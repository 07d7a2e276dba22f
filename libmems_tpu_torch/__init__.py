"""libmems_tpu_torch — the PyTorch and CUDA port of libmems_tpu.

Runs the flat pairwise aligner of libmems_tpu (the JAX package, which
stays as the reference) on one NVIDIA GPU: SML construction, pair MUM
discovery, LCBs with the extension loop, recursive anchoring, batched
gapped alignment of the inter-anchor windows and XMFA output.  The
device work is PyTorch plus four hand-written CUDA kernels (``csrc/``):
canonical seed keys, ungapped extension, the profile DP forward with
pointers, and the traceback walk.  Each has a plain PyTorch version that
CPU tensors use.

Every tensor-building entry point takes an explicit ``device``
(``AlignerConfig.device``); ``"cuda"`` without a GPU raises.  Modules
keep the JAX package's names: ``libmems_tpu_torch/ops/extend.py`` ports
``libmems_tpu/ops/extend.py``.  The package never imports JAX or
libmems_tpu.

Coordinates follow libMems conventions: match starts are signed, 1-based
left ends; a negative start means the match content is the reverse
complement of the forward strand at |start|.
"""

from libmems_tpu_torch import seeds
from libmems_tpu_torch.sequence import Genome, read_fasta
from libmems_tpu_torch.sml import SortedMerList, create_smls
from libmems_tpu_torch.match import MatchArray, write_match_list
from libmems_tpu_torch.matchfind import find_mums
from libmems_tpu_torch.aligner import AlignerConfig, align
from libmems_tpu_torch.interval import IntervalList, write_xmfa

__all__ = [
    "seeds",
    "Genome",
    "read_fasta",
    "SortedMerList",
    "create_smls",
    "MatchArray",
    "write_match_list",
    "find_mums",
    "AlignerConfig",
    "align",
    "IntervalList",
    "write_xmfa",
]

__version__ = "0.1.0"
