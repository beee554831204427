"""How much TF32 matmuls move the port's Morpho E-step and a whole solve on
the card: the plain dense E-step (`estep_reduced`, n_chunks=1) at
20,000 x 2,000 with `torch.backends.cuda.matmul.allow_tf32` on and off,
each against `estep_reference` with TF32 off, and one 20,000-cell
`morpho_align` pair with TF32 on against the same pair with it off. Needs
one NVIDIA GPU; run from the repository root:

    python3 scripts/tf32_probe_morpho.py
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bench  # noqa: E402
import spateo_tpu_torch as stt  # noqa: E402
from chip_smoke import ESTEP_KEYS, estep_case, scaled_err  # noqa: E402
from spateo_tpu_torch.alignment.methods import math as tm  # noqa: E402
from spateo_tpu_torch.ops import estep_cuda as ec  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    args = estep_case(20000, 2000, 0.05, 1)
    ref = ec.estep_reference(*args)
    XAHat, coordsA, coordsB, a, b, A, Bf, mm, s2, gamma, ss, s2v, p = args

    def dense():
        return tm.estep_reduced(2.0, XAHat, coordsA, coordsB, (a,), (b,), (A,), (Bf,), s2, mm, gamma, ss, s2v,
                                ["gauss"], [p], n_chunks=1, use_kernel=False)

    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        out = dense()
        errs = {k: scaled_err(ref[k], out[k]) for k in ESTEP_KEYS}
        print(f"{torch.cuda.get_device_name(0)}; dense E-step 20000x2000, allow_tf32={tf32}: scaled errors vs "
              f"estep_reference (TF32 off): {errs}")

    pts, ptsA, X = bench._make_slice_pair(20000, seed=2)
    res = {}
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        out, _ = stt.align.morpho_align([bench._mk_adata(stt, pts, X), bench._mk_adata(stt, ptsA, X)],
                                        spatial_key="spatial", key_added="align", max_iter=200, verbose=False)
        res[tf32] = out[1]
    torch.backends.cuda.matmul.allow_tf32 = False
    r = float(np.abs(res[True].uns["VecFld_morpho"]["optimal_R"] - res[False].uns["VecFld_morpho"]["optimal_R"]).max())
    x = float(np.abs(res[True].obsm["align_nonrigid"] - res[False].obsm["align_nonrigid"]).max())
    print(f"morpho_align 20000-cell pair, TF32 on vs off: optimal_R max_abs_diff {r!r}, non-rigid coords "
          f"max_abs_diff {x!r}")


if __name__ == "__main__":
    main()
