"""The homology HMM's f64 routes against an 80-bit run of the recurrence.

    python -m tests.hmm_scan_accuracy [log2 or columns ...]

For each length (default 2^14 + 3, 2^16, 2^17 + 5 and 2^19 columns of
tests/test_torch_hmm.py's seeded generator, rng 17, adapted_hoxd_params
(0.5)) prints one JSON line: the largest absolute posterior difference
of the port's sequential route and of its chunked route from an 80-bit
np.longdouble run of the same recurrence, and between the two routes.
CPU only (plain PyTorch versions); 2^19 takes about a minute.
"""

import json
import sys

import numpy as np
import torch

from libmems_tpu_torch.ops import hmm
from tests.test_torch_hmm import _columns
from tests.test_torch_hmm_scan import _posterior_80bit

DEFAULT = ((1 << 14) + 3, 1 << 16, (1 << 17) + 5, 1 << 19)


def row(n: int) -> dict:
    rng = np.random.default_rng(17)
    params = hmm.adapted_hoxd_params(0.5)
    obs = _columns(rng, n, block=20_000)
    batch = (torch.from_numpy(obs[None]), torch.tensor([n], dtype=torch.int32))
    mats = hmm.log_matrices(params, "cpu")
    seq = hmm.fb_sequential_plain(*batch, mats, 0.9)[0].numpy()[0]
    scan = hmm.fb_scan_plain(*batch, mats, 0.9)[0].numpy()[0]
    ref = _posterior_80bit(obs, params)
    return {"columns": n,
            "sequential_vs_80bit": float(np.abs(seq - ref).max()),
            "chunked_vs_80bit": float(np.abs(scan - ref).max()),
            "chunked_vs_sequential": float(np.abs(scan - seq).max())}


def main(argv) -> int:
    lengths = [1 << int(a) if int(a) < 32 else int(a) for a in argv] \
        or DEFAULT
    for n in lengths:
        print(json.dumps(row(n)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
