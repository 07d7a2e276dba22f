"""libmems_tpu_torch — the PyTorch and CUDA port of libmems_tpu.

Runs the pipelines of libmems_tpu (the JAX package, which stays as the
reference) on one NVIDIA GPU:

* the flat aligner (``align`` on any number of genomes): SML
  construction, multi-MUM discovery (``find_mums``, every mode), LCBs
  with the extension loop, recursive anchoring, batched gapped alignment
  of the inter-anchor windows and XMFA output;
* progressive alignment (``progressive_align``, with the windowed
  refinement of its default ``refine=True``) and backbone
  (``apply_backbone``), the progressiveMauve path: pairwise seeding from
  per-genome-unique seeds, guide tree, node merges with multi-row
  profile DP windows, score-gated refinement, the pairwise homology HMM
  and the backbone files;
* one-window alignment and refinement (``align_codes``, ``refine``).

The device work is PyTorch plus hand-written CUDA kernels (``csrc/``):
canonical seed keys (K1), ungapped extension (K2), the profile DP
forward with pointers (K3), the traceback walk (K4), the pairwise
seeder's run flags, cluster words and representatives (K5-K7), the
homology HMM forward/backward (K8), the score-only profile forward (K9),
the banded profile forward with its certificate (K10) and with pointers
(K11), the banded traceback walk (K12), the multi-MUM pipeline's
seed-enumeration flags, candidate signatures and cluster representatives
(K13-K15), the seed occurrence list's run counts and smoothing (K16,
K17) and the pair fast path's cluster words and representatives (K18,
K19).  Each has a plain PyTorch version that CPU tensors use.

Every tensor-building entry point takes an explicit ``device``
(``AlignerConfig.device``, ``ProgressiveConfig.device``); ``"cuda"``
without a GPU raises.  Modules keep the JAX package's names:
``libmems_tpu_torch/ops/extend.py`` ports ``libmems_tpu/ops/extend.py``.
The package never imports JAX or libmems_tpu.

Coordinates follow libMems conventions: match starts are signed, 1-based
left ends; a negative start means the match content is the reverse
complement of the forward strand at |start|.
"""

from libmems_tpu_torch import seeds
from libmems_tpu_torch.sequence import (Genome, read_fasta, read_mfa,
                                        revcomp_codes, translate_dna)
from libmems_tpu_torch.sml import SortedMerList, create_smls
from libmems_tpu_torch.match import MatchArray, write_match_list
from libmems_tpu_torch.matchfind import (find_mums, find_mums_device,
                                         find_pairwise_mums)
from libmems_tpu_torch.aligner import AlignerConfig, align
from libmems_tpu_torch.interval import (Interval, IntervalList, marble,
                                        read_xmfa, read_xmfa_intervals,
                                        write_xmfa)
from libmems_tpu_torch.tree import (TreeNode, midpoint_root,
                                    neighbor_joining, parse_newick,
                                    write_newick)
from libmems_tpu_torch.distance import (breakpoint_distance_matrix,
                                        distance_matrix, identity_matrix,
                                        single_copy_distance)
from libmems_tpu_torch.msa import align_codes, refine
from libmems_tpu_torch.progressive import (ProgressiveConfig,
                                           align_profiles,
                                           progressive_align)
from libmems_tpu_torch.backbone import (BackboneSegment, apply_backbone,
                                        compute_gc, detect_backbone,
                                        write_backbone_columns,
                                        write_backbone_seq_coordinates)

__all__ = [
    "seeds",
    "Genome",
    "read_fasta",
    "read_mfa",
    "translate_dna",
    "revcomp_codes",
    "SortedMerList",
    "create_smls",
    "MatchArray",
    "write_match_list",
    "find_mums",
    "find_pairwise_mums",
    "find_mums_device",
    "AlignerConfig",
    "align",
    "Interval",
    "IntervalList",
    "write_xmfa",
    "read_xmfa",
    "read_xmfa_intervals",
    "TreeNode",
    "neighbor_joining",
    "midpoint_root",
    "parse_newick",
    "write_newick",
    "distance_matrix",
    "identity_matrix",
    "single_copy_distance",
    "breakpoint_distance_matrix",
    "marble",
    "align_codes",
    "refine",
    "ProgressiveConfig",
    "progressive_align",
    "align_profiles",
    "detect_backbone",
    "apply_backbone",
    "BackboneSegment",
    "write_backbone_seq_coordinates",
    "write_backbone_columns",
    "compute_gc",
]

__version__ = "0.1.0"
