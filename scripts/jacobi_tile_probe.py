"""Time the Jacobi kernel (`spateo_tpu_torch/csrc/jacobi.cu`) under other
compile-time choices of sweeps per launch T and tile, on one NVIDIA GPU.

    python3 scripts/jacobi_tile_probe.py [--sizes 1024,2048,4096] [--sweeps 2000]

Each variant is built with nvcc (`-DJACOBI_T=.. -DJACOBI_TILE_X=..
-DJACOBI_TILE_Y=..`, the flags of `ops/_build.py`, all builds started
together) into a temporary directory, checked bit for bit against the plain
version `jacobi_block_reference` at 1000x1500 over T + 3 sweeps, and timed
with CUDA events over `--sweeps` sweeps per size; the ptxas report of each
build (registers, shared memory, spills) is printed first. Prints one line
per variant and size, with the card's name and power limit.
"""

import argparse
import ctypes
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from spateo_tpu_torch.ops import _build  # noqa: E402
from spateo_tpu_torch.ops.jacobi_cuda import jacobi_block_reference  # noqa: E402

VARIANTS = ((8, 64, 64), (8, 64, 32), (8, 32, 32), (4, 64, 64), (16, 64, 64), (8, 128, 32), (12, 64, 64))


def build(variant, out_dir):
    T, tx, ty = variant
    lib = Path(out_dir) / f"libjacobi_{T}_{tx}_{ty}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", f"-DJACOBI_T={T}", f"-DJACOBI_TILE_X={tx}",
           f"-DJACOBI_TILE_Y={ty}", "-o", str(lib), str(_build.CSRC / "jacobi.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {variant}:\n{proc.stdout}{proc.stderr}")
    return lib, proc.stderr


def runner(lib_path):
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.jacobi_block_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    cfg = (ctypes.c_int * 4)()
    lib.jacobi_config(cfg)
    T = cfg[0]

    def run(f, upd, n, bufs):
        err = fn(f.data_ptr(), upd.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(), f.shape[0], f.shape[1], n,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return bufs[(-(-n // T) - 1) % 2]

    return run, T


def case(H, W, seed=0):
    rng = np.random.default_rng(seed)
    f = torch.from_numpy(rng.uniform(0, 100, (H, W)).astype(np.float32)).cuda()
    upd = torch.zeros((H, W), dtype=torch.uint8, device="cuda")
    upd[1:-1, 1:-1] = 1
    upd[torch.from_numpy(rng.uniform(size=(H, W)) < 0.01).cuda()] = 0
    return f, upd


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="1024,2048,4096")
    ap.add_argument("--sweeps", type=int, default=2000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("jacobi_tile_probe: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(lambda v: build(v, tmp), VARIANTS))
        for v, (_, report) in zip(VARIANTS, built):
            print(f"ptxas T={v[0]} tile={v[1]}x{v[2]}: " + " | ".join(
                ln.strip() for ln in report.splitlines() if "registers" in ln or "spill" in ln))
        f, upd = case(1000, 1500)
        for v, (lib, _) in zip(VARIANTS, built):
            run, T = runner(lib)
            bufs = (torch.empty_like(f), torch.empty_like(f))
            out = run(f, upd, T + 3, bufs)
            ok = torch.equal(out, jacobi_block_reference(f, upd, T + 3))
            if not ok:
                raise RuntimeError(f"variant {v} differs from the plain version")
            for size in map(int, args.sizes.split(",")):
                g, u = case(size, size, seed=1)
                bufs = (torch.empty_like(g), torch.empty_like(g))
                run(g, u, 2 * T, bufs)
                torch.cuda.synchronize()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                run(g, u, args.sweeps, bufs)
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end) / args.sweeps
                print(f"T={v[0]} tile={v[1]}x{v[2]} {size}x{size}: {ms * 1e3!r} us per sweep, "
                      f"{size * size / ms / 1e3!r} Mpixel-iters/s (bit-identical to plain at 1000x1500: {ok})")


if __name__ == "__main__":
    main()
