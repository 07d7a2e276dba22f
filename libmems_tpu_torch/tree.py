"""Phylogenetic guide trees: Newick I/O, neighbor joining, midpoint rooting.

TPU-native rebuild of the reference's guide-tree stack:

* PhyloTree — generic n-ary tree with Newick read/write
  (libMems/PhyloTree.h:38-44, :109-307);
* MuscleInterface::CreateTree — neighbor-joining construction from a
  distance matrix; the reference delegates to libMUSCLE's ``Clust`` with
  CLUSTER_NeighborJoining (libMems/MuscleInterface.cpp:1165-1189), here
  it is the classic Saitou-Nei NJ on the dense matrix (vectorized numpy —
  the matrices are G×G with G = number of genomes, far below device
  dispatch granularity);
* findMidpoint / moveRootToBranch — midpoint rooting of the NJ tree
  (libMems/ProgressiveAligner.cpp:2967+).

Trees are kept as simple node objects (not arrays): tree sizes are tiny
(≤ number of genomes) and the progressive aligner's traversals are
host-side orchestration by design (SURVEY.md §7 M5).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class TreeNode:
    """One node of a guide tree (PhyloTree.h TreeNode equivalent)."""

    name: str = ""
    distance: float = 0.0          # branch length to parent
    children: list["TreeNode"] = field(default_factory=list)
    parent: "TreeNode | None" = None
    sequence_id: int = -1          # leaf payload: genome index, -1 internal

    def is_leaf(self) -> bool:
        return not self.children

    def add_child(self, child: "TreeNode"):
        child.parent = self
        self.children.append(child)

    # -- traversals ------------------------------------------------------

    def postorder(self):
        for c in self.children:
            yield from c.postorder()
        yield self

    def leaves(self) -> list["TreeNode"]:
        return [n for n in self.postorder() if n.is_leaf()]

    def height(self) -> float:
        """Max root-to-leaf distance below this node (PhyloTree::getHeight)."""
        if self.is_leaf():
            return 0.0
        return max(c.distance + c.height() for c in self.children)

    def n_nodes(self) -> int:
        return sum(1 for _ in self.postorder())

    def descendant_leaf_ids(self) -> list[int]:
        """Genome ids at or below this node (getDescendants equivalent,
        libMems/TreeUtilities.h)."""
        return [n.sequence_id for n in self.postorder()
                if n.is_leaf() and n.sequence_id >= 0]

    def copy(self) -> "TreeNode":
        n = TreeNode(name=self.name, distance=self.distance,
                     sequence_id=self.sequence_id)
        for c in self.children:
            n.add_child(c.copy())
        return n


# --------------------------------------------------------------------------
# Newick I/O (PhyloTree::readTree / writeTree, PhyloTree.h:109-307)
# --------------------------------------------------------------------------

def parse_newick(text: str) -> TreeNode:
    """Parse a Newick string into a TreeNode tree."""
    text = text.strip()
    if text.endswith(";"):
        text = text[:-1]
    pos = 0

    def parse_node() -> TreeNode:
        nonlocal pos
        node = TreeNode()
        if pos < len(text) and text[pos] == "(":
            pos += 1  # consume '('
            while True:
                node.add_child(parse_node())
                if pos < len(text) and text[pos] == ",":
                    pos += 1
                    continue
                break
            if pos >= len(text) or text[pos] != ")":
                raise ValueError(f"newick parse error at {pos}: expected ')'")
            pos += 1  # consume ')'
        # optional label
        start = pos
        while pos < len(text) and text[pos] not in ",():;":
            pos += 1
        node.name = text[start:pos].strip()
        # optional :distance
        if pos < len(text) and text[pos] == ":":
            pos += 1
            start = pos
            while pos < len(text) and text[pos] not in ",()":
                pos += 1
            node.distance = float(text[start:pos])
        return node

    root = parse_node()
    if pos != len(text):
        raise ValueError(f"newick parse error: trailing input at {pos}")
    return root


def write_newick(root: TreeNode, include_distances: bool = True) -> str:
    """Serialize a tree to Newick (PhyloTree::writeTree equivalent)."""
    def fmt(node: TreeNode, top: bool) -> str:
        if node.is_leaf():
            s = node.name
        else:
            s = "(" + ",".join(fmt(c, False) for c in node.children) + ")"
            s += node.name
        if not top and include_distances:
            s += f":{node.distance:g}"
        return s

    return fmt(root, True) + ";"


def assign_sequence_ids(root: TreeNode, names: list[str] | None = None):
    """Bind leaf names to genome indices.

    With ``names`` given, leaves are matched by name; otherwise the
    reference convention ``seqN`` (1-based, MuscleInterface.cpp:1176-1180)
    is parsed.
    """
    for leaf in root.leaves():
        if names is not None:
            leaf.sequence_id = names.index(leaf.name)
        elif leaf.name.startswith("seq"):
            leaf.sequence_id = int(leaf.name[3:]) - 1
    return root


# --------------------------------------------------------------------------
# neighbor joining (MuscleInterface::CreateTree equivalent)
# --------------------------------------------------------------------------

def neighbor_joining(distance: np.ndarray,
                     names: list[str] | None = None) -> TreeNode:
    """Classic Saitou-Nei NJ over a symmetric distance matrix.

    Leaf i is named ``names[i]`` (default ``seq{i+1}``, matching the
    reference's synthetic leaf naming, MuscleInterface.cpp:1176-1180) and
    carries sequence_id=i.  Negative branch lengths are clamped to 0 (the
    usual NJ fix, also applied by libMUSCLE).
    """
    D = np.array(distance, dtype=np.float64)
    n = D.shape[0]
    if D.shape != (n, n):
        raise ValueError("distance matrix must be square")
    if names is None:
        names = [f"seq{i + 1}" for i in range(n)]
    nodes = [TreeNode(name=names[i], sequence_id=i) for i in range(n)]
    if n == 1:
        return nodes[0]
    active = list(range(n))

    while len(active) > 2:
        m = len(active)
        sub = D[np.ix_(active, active)]
        r = sub.sum(axis=1)
        q = (m - 2) * sub - r[:, None] - r[None, :]
        np.fill_diagonal(q, np.inf)
        i, j = np.unravel_index(np.argmin(q), q.shape)
        if i > j:
            i, j = j, i
        ai, aj = active[i], active[j]
        dij = sub[i, j]
        li = 0.5 * dij + (r[i] - r[j]) / (2.0 * (m - 2))
        lj = dij - li
        li, lj = max(li, 0.0), max(lj, 0.0)

        parent = TreeNode()
        ci, cj = nodes[ai], nodes[aj]
        ci.distance, cj.distance = li, lj
        parent.add_child(ci)
        parent.add_child(cj)

        # distances from the new node to every other active node
        new_d = 0.5 * (D[ai, active] + D[aj, active] - dij)
        D = np.pad(D, ((0, 1), (0, 1)))
        k = D.shape[0] - 1
        D[k, active] = new_d
        D[active, k] = new_d
        nodes.append(parent)
        active = [a for a in active if a not in (ai, aj)] + [k]

    # join the last two
    ai, aj = active
    root = TreeNode()
    half = max(D[ai, aj] / 2.0, 0.0)
    nodes[ai].distance = half
    nodes[aj].distance = half
    root.add_child(nodes[ai])
    root.add_child(nodes[aj])
    return root


# --------------------------------------------------------------------------
# midpoint rooting (findMidpoint / moveRootToBranch,
# ProgressiveAligner.cpp:2967+)
# --------------------------------------------------------------------------

def _leaf_paths(root: TreeNode) -> tuple[list[TreeNode], np.ndarray,
                                         list[list[TreeNode]]]:
    """All leaves, pairwise path lengths, and node paths root->leaf."""
    leaves = root.leaves()
    paths = []
    for leaf in leaves:
        p = []
        node = leaf
        while node is not None:
            p.append(node)
            node = node.parent
        paths.append(p[::-1])  # root..leaf
    L = len(leaves)
    dist = np.zeros((L, L))
    for i in range(L):
        for j in range(i + 1, L):
            pi, pj = paths[i], paths[j]
            k = 0
            while k < len(pi) and k < len(pj) and pi[k] is pj[k]:
                k += 1
            d = sum(x.distance for x in pi[k:]) + \
                sum(x.distance for x in pj[k:])
            dist[i, j] = dist[j, i] = d
    return leaves, dist, paths


def midpoint_root(root: TreeNode) -> TreeNode:
    """Re-root the tree at the midpoint of the longest leaf-to-leaf path.

    Equivalent of findMidpoint + moveRootToBranch
    (ProgressiveAligner.cpp:2967+): locate the edge containing the
    midpoint of the tree diameter and split it with a new root node.
    """
    leaves, dist, paths = _leaf_paths(root)
    if len(leaves) < 2:
        return root
    i, j = np.unravel_index(np.argmax(dist), dist.shape)
    pi, pj = paths[i], paths[j]
    k = 0
    while k < len(pi) and k < len(pj) and pi[k] is pj[k]:
        k += 1
    # path: leaf_i .. lca .. leaf_j
    path = pi[k:][::-1] + [pi[k - 1]] + pj[k:]
    half = dist[i, j] / 2.0
    # walk from leaf_i toward leaf_j accumulating branch lengths
    acc = 0.0
    for t in range(len(path) - 1):
        a, b = path[t], path[t + 1]
        # edge length between a and b: child-side distance
        edge = a.distance if a.parent is b else b.distance
        if acc + edge >= half or t == len(path) - 2:
            # midpoint lies on edge (a, b), `half - acc` from a
            child = a if a.parent is b else b
            return _reroot_on_edge(child, max(min(half - acc, edge), 0.0)
                                   if a.parent is b else
                                   max(min(edge - (half - acc), edge), 0.0))
        acc += edge
    return root


def _reroot_on_edge(child: TreeNode, dist_from_child: float) -> TreeNode:
    """Split the (child, child.parent) edge with a new root."""
    parent = child.parent
    if parent is None:
        return child
    edge = child.distance
    new_root = TreeNode()
    # detach child from parent
    parent.children.remove(child)
    child.parent = None
    # reverse parent pointers up to the old root
    _invert_path(parent)
    child.distance = dist_from_child
    parent.distance = edge - dist_from_child
    new_root.add_child(child)
    new_root.add_child(parent)
    _suppress_unary(new_root)
    return new_root


def _invert_path(node: TreeNode):
    """Make `node` a root by reversing parent links above it."""
    if node.parent is None:
        return
    parent = node.parent
    _invert_path(parent)
    parent.children.remove(node)
    node.parent = None
    parent.distance = node.distance
    node.add_child(parent)
    node.distance = 0.0


def _suppress_unary(root: TreeNode):
    """Remove internal nodes with a single child (merging branch lengths)."""
    for node in list(root.postorder()):
        if node is root or node.is_leaf():
            continue
        if len(node.children) == 1:
            child = node.children[0]
            child.distance += node.distance
            p = node.parent
            idx = p.children.index(node)
            p.children[idx] = child
            child.parent = p
    if len(root.children) == 1:
        only = root.children[0]
        only.parent = None
        return only
    return root


# --------------------------------------------------------------------------
# alignment-order extraction (chooseNextAlignmentPair support)
# --------------------------------------------------------------------------

def alignment_order(root: TreeNode) -> list[TreeNode]:
    """Internal nodes in postorder — the order in which the progressive
    aligner visits ancestors (each internal node aligns its children;
    cf. ProgressiveAligner::getAlignment, ProgressiveAligner.cpp:3727)."""
    return [n for n in root.postorder() if not n.is_leaf()]
