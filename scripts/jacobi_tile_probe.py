"""Time the Jacobi kernel (`spateo_tpu_torch/csrc/jacobi.cu`) under other
compile-time choices of sweeps per launch T, rows per lane R and warps per
block NW (a block's output tile is (128 - 2T) x (NW R - 2T)), on one NVIDIA
GPU.

    python3 scripts/jacobi_tile_probe.py [--sizes 1024,2048,4096] [--sweeps 2000]
        [--variants "14,10,12;12,12,8"] [--source path/to/jacobi.cu]

Each variant is built with nvcc (`-DJACOBI_T=.. -DJACOBI_R=..
-DJACOBI_NW=..`, the flags of `ops/_build.py`, all builds started together)
into a temporary directory, checked bit for bit against the plain version
`jacobi_block_reference` at 1000x1500 and 229x333 over T + 3 sweeps, and
timed with CUDA events over `--sweeps` sweeps per size, on two moving
sets: the interior minus 1% scattered Dirichlet pixels ("scattered"), and
the interior minus two isolines, as the PDE benchmark ("isolines"); the
ptxas report of
each build (registers, shared memory, spills) is printed first. Prints one
line per variant and size, with the card's name and power limit.
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

# (T, R, NW)
VARIANTS = ((12, 12, 8), (16, 12, 12), (14, 10, 12), (14, 12, 10), (12, 8, 12), (12, 8, 8), (16, 8, 16),
            (10, 8, 12))


def build(variant, out_dir, source):
    T, R, NW = variant
    lib = Path(out_dir) / f"libjacobi_{T}_{R}_{NW}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", f"-DJACOBI_T={T}", f"-DJACOBI_R={R}",
           f"-DJACOBI_NW={NW}", "-o", str(lib), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {variant}:\n{proc.stdout}{proc.stderr}")
    return lib, proc.stderr


def runner(lib_path):
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.jacobi_block_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    cfg = (ctypes.c_int * 8)()
    lib.jacobi_config(cfg)
    T = cfg[0]

    def run(f, upd, n, bufs):
        err = fn(f.data_ptr(), upd.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(), None, None, None,
                 f.shape[0], f.shape[1], n, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return bufs[(-(-n // T) - 1) % 2]

    return run, T


def case(H, W, seed=0, isolines=False):
    rng = np.random.default_rng(seed)
    f = torch.from_numpy(rng.uniform(0, 100, (H, W)).astype(np.float32)).cuda()
    upd = torch.zeros((H, W), dtype=torch.uint8, device="cuda")
    upd[1:-1, 1:-1] = 1
    if isolines:
        upd[1], upd[-2] = 0, 0
    else:
        upd[torch.from_numpy(rng.uniform(size=(H, W)) < 0.01).cuda()] = 0
    return f, upd


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="1024,2048,4096")
    ap.add_argument("--sweeps", type=int, default=2000)
    ap.add_argument("--variants", default=None, help="T,R,NW triples separated by ';' (default: a built-in set)")
    ap.add_argument("--source", default=str(_build.CSRC / "jacobi.cu"), help="the kernel source to build")
    args = ap.parse_args()
    variants = VARIANTS if args.variants is None else tuple(
        tuple(int(x) for x in v.split(",")) for v in args.variants.split(";"))
    if not torch.cuda.is_available():
        raise SystemExit("jacobi_tile_probe: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"source: {args.source}")
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(lambda v: build(v, tmp, args.source), variants))
        for v, (_, report) in zip(variants, built):
            print(f"ptxas T={v[0]} R={v[1]} NW={v[2]}: " + " | ".join(
                ln.strip() for ln in report.splitlines() if "registers" in ln or "spill" in ln))
        checks = [case(1000, 1500), case(229, 333, seed=2), case(300, 700, isolines=True)]
        for v, (lib, _) in zip(variants, built):
            run, T = runner(lib)
            for f, upd in checks:
                bufs = (torch.empty_like(f), torch.empty_like(f))
                out = run(f, upd, T + 3, bufs)
                ok = torch.equal(out, jacobi_block_reference(f, upd, T + 3))
                if not ok:
                    raise RuntimeError(f"variant {v} differs from the plain version at {tuple(f.shape)}")
            for size in map(int, args.sizes.split(",")):
                for kind in ("scattered", "isolines"):
                    g, u = case(size, size, seed=1, isolines=kind == "isolines")
                    bufs = (torch.empty_like(g), torch.empty_like(g))
                    run(g, u, 2 * T, bufs)
                    torch.cuda.synchronize()
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                    run(g, u, args.sweeps, bufs)
                    end.record()
                    end.synchronize()
                    ms = start.elapsed_time(end) / args.sweeps
                    tile = (128 - 2 * v[0], v[2] * v[1] - 2 * v[0])
                    print(f"T={v[0]} R={v[1]} NW={v[2]} tile={tile[0]}x{tile[1]} {size}x{size} {kind}: "
                          f"{ms * 1e3!r} us per sweep, {size * size / ms / 1e3!r} Mpixel-iters/s (bit-identical to "
                          f"plain: {ok})")


if __name__ == "__main__":
    main()
