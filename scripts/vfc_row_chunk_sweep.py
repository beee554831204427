"""The SparseVFC EM's row chunk (`spateo_tpu_torch.ops.vfc.ROW_CHUNK`) swept
on the card.

Runs the EM of `bench.vfc_bench`'s sweep (4 fields of 100,000 3-D points,
M 100, 60 iterations, ecr 0, the same control points and betas throughout)
with the M-step's row products taken in chunks of at most 1,024, 2,048,
4,096, 8,192 rows and in one product over all 100,000 rows. For each it
prints the EM's device time by CUDA events (mean of 3), the device's busy
time and the host's kernel launches under torch.profiler, the largest
device ops, and V's largest error against the same EM in float64 on the
card, scaled by max|V|. Needs one NVIDIA GPU; run from the repository root:

    python3 scripts/vfc_row_chunk_sweep.py
"""

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import cuda_ms, device_profile, vfc_fields  # noqa: E402
from spateo_tpu_torch.core.bridge import _to_device  # noqa: E402
from spateo_tpu_torch.ops import vfc  # noqa: E402

N, M, MAXIT, F = 100_000, 100, 60, 4
CHUNKS = (1024, 2048, 4096, 8192, N)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    Xs, Vs = vfc_fields(N, F)
    _, ctrls, subs = vfc._batch_ctrl_draws(Xs, M, 1, True)
    Xj, Yj, cj, sj = (_to_device(a, "cuda") for a in (Xs, Vs, ctrls, subs))
    betas = vfc._beta_from_h2(vfc._median_positive_sqdist(sj))

    def em(dtype=torch.float32):
        X, Y, c = (t.to(dtype) for t in (Xj, Yj, cj))
        return vfc._sparsevfc_em_batch(X, Y, c, betas, 0.9, 5.0, 3.0, 0.0, 1e-5, MAXIT, with_morphometrics=False)

    default = vfc.ROW_CHUNK
    V64 = em(torch.float64)["V"]
    scale = float(V64.abs().max())
    print(f"{card}; EM of {F} x {N} points, M {M}, {MAXIT} iterations; V error against the float64 EM, of max|V|")
    try:
        for chunk in CHUNKS:
            vfc.ROW_CHUNK = chunk
            ms = cuda_ms(em, 3)
            out, wall, busy, launches, ops = device_profile(em)
            err = float((out["V"].double() - V64).abs().max()) / scale
            top = "; ".join(f"{name[:70]} {t!r} ({n})" for name, (t, n) in list(ops.items())[:4])
            print(f"row chunk {chunk} ({vfc._row_chunks(N)} chunks): {ms!r} ms (CUDA events), busy {busy!r} ms of "
                  f"{wall!r} ms under the profiler, {launches / MAXIT!r} launches an iteration, V error {err!r}; "
                  f"largest ops (ms, events): {top}")
    finally:
        vfc.ROW_CHUNK = default


if __name__ == "__main__":
    main()
