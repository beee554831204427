"""Before/after of the two redesigned kernels on one NVIDIA GPU, in turns.

    python3 scripts/kernel_ab_probe.py

Builds the previous designs kept in `scripts/baseline/` (the Jacobi kernel
with T = 8 and 64x64 tiles in shared memory, `jacobi_shared_tile.cu`; the
E-step whose `rowred` restages both factor chunks for every column tile,
`estep_restaged_tiles.cu`) with the flags of `ops/_build.py`
beside the current `csrc/` kernels, and times each pair with CUDA events in
the order old, new, new, old at the main path's shapes:

- Jacobi: 1024^2 and 2048^2, 2000 sweeps per call; and one solver block of
  100 sweeps with its relative change (old: the kernel then the PyTorch
  reduction `rel_change_reference`; new: the fused sums), as `digitize`
  runs it at 2048^2;
- rowred: 20,000 x 2,000 and 100,000 x 10,000 (`chip_smoke.estep_case`),
  both against `rowred_reference` (scaled error), and the three against the
  same sweep in f64; then the new kernel under other column-split targets.

Prints the card's name and power limit first, then one line per case.
"""

import ctypes
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from spateo_tpu_torch.ops import _build, estep_cuda as ec, jacobi_cuda as jc  # noqa: E402


def nvcc(src, out_dir):
    lib = Path(out_dir) / f"lib{Path(src).stem}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib))


def ms_turns(fns, n):
    """CUDA-event ms per call of each of `fns` ({name: fn}), timed in the
    order given and then reversed; returns {name: [ms, ms]}."""
    out = {k: [] for k in fns}
    order = list(fns) + list(fns)[::-1]
    for k in order:
        fns[k]()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fns[k]()
        b.record()
        b.synchronize()
        out[k].append(a.elapsed_time(b) / n)
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab_probe: needs an NVIDIA GPU")
    import chip_smoke

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(4) as pool:
        baseline = ROOT / "scripts" / "baseline"
        jobs = [pool.submit(nvcc, baseline / n, tmp) for n in ("jacobi_shared_tile.cu", "estep_restaged_tiles.cu")]
        jobs += [pool.submit(_build.build, n) for n in ("jacobi", "estep")]
        old_j, old_e = jobs[0].result(), jobs[1].result()
        for j in jobs[2:]:
            j.result()
    old_j.jacobi_block_f32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    old_j.jacobi_block_f32.restype = ctypes.c_int
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def old_jacobi(f, upd, n, bufs):
        if old_j.jacobi_block_f32(f.data_ptr(), upd.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(), f.shape[0],
                                  f.shape[1], n, stream()):
            raise RuntimeError("old jacobi launch failed")
        return bufs[(-(-n // 8) - 1) % 2]

    print(f"new Jacobi config {jc.kernel_config()}")
    for H in (1024, 2048):
        f, upd = chip_smoke.jacobi_case(H, H, seed=H)
        w = torch.ones_like(f)
        bufs = (torch.empty_like(f), torch.empty_like(f))
        same = torch.equal(old_jacobi(f, upd, 2000, bufs), jc.jacobi_block(f, upd, 2000))
        t = ms_turns({"old": lambda: old_jacobi(f, upd, 2000, bufs), "new": lambda: jc.jacobi_block(f, upd, 2000)}, 3)
        print(f"jacobi {H}x{H}, us per sweep over 2000 sweeps: old {[x / 2000 * 1e3 for x in t['old']]!r}, "
              f"new {[x / 2000 * 1e3 for x in t['new']]!r}; same bits {same}")

        def old_block():
            out = old_jacobi(f, upd, 100, bufs)
            return out, jc.rel_change_reference(out, f, w)

        e_old, e_new = old_block()[1], jc.jacobi_block(f, upd, 100, weight=w)[1]
        t = ms_turns({"old": old_block, "new": lambda: jc.jacobi_block(f, upd, 100, weight=w)}, 20)
        print(f"jacobi {H}x{H}, ms per block of 100 sweeps with its relative change: old {t['old']!r}, "
              f"new {t['new']!r}; err old {float(e_old)!r}, new {float(e_new)!r}")

    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    old_e.estep_rowred.argtypes = [ptr] * 9 + [i32] * 3 + [f32, ptr]
    old_e.estep_rowred.restype = i32
    for name, NA, B, s2, seed in (("20000x2000", 20000, 2000, 0.05, 1), ("100000x10000", 100000, 10000, 1e-3, 2)):
        args = chip_smoke.estep_case(NA, B, s2, seed)
        xa, cb, fat, fbt, bt, mm, scal, skip = ec.prepare(*args[:1], *args[2:])
        col = ec.colnorm_reference(xa, cb, fat, fbt, bt, mm, scal)
        G1 = fat.shape[0]

        def old_rowred():
            out = torch.zeros((6, NA), dtype=torch.float32, device="cuda")
            if old_e.estep_rowred(xa.data_ptr(), cb.data_ptr(), fat.data_ptr(), fbt.data_ptr(), bt.data_ptr(),
                                  col.data_ptr(), scal.data_ptr(), skip.data_ptr(), out.data_ptr(), NA, B, G1,
                                  float(ec._SKIP_MULT), stream()):
                raise RuntimeError("old rowred launch failed")
            return out

        new_rowred = lambda: ec.rowred(xa, cb, fat, fbt, bt, col, scal, skip)
        ref = ec.rowred_reference(xa, cb, fat, fbt, bt, col, scal)
        errs = {k: max(chip_smoke.scaled_err(ref[q], fn()[q]) for q in range(6))
                for k, fn in (("old", old_rowred), ("new", new_rowred))}
        # the same sweep in f64 from the same f32 inputs: how far the plain
        # f32 version itself is from it, beside the kernels
        ref64 = ec.rowred_reference(*(x.double() for x in (xa, cb, fat, fbt, bt, col, scal)))
        errs64 = {k: max(chip_smoke.scaled_err(ref64[q], fn()[q]) for q in range(6))
                  for k, fn in (("plain", lambda: ref), ("old", old_rowred), ("new", new_rowred))}
        print(f"rowred {name}: scaled error against the f64 sweep {errs64!r}")
        t = ms_turns({"old": old_rowred, "new": new_rowred}, 20 if NA <= 20000 else 5)
        print(f"rowred {name}: ms old {t['old']!r}, new {t['new']!r}; scaled error vs plain {errs!r}")
        default = ec._ROWRED_BLOCKS
        for target in (264, 528, 1056, 2112):
            ec._ROWRED_BLOCKS = target
            t = ms_turns({"new": new_rowred}, 20 if NA <= 20000 else 5)
            print(f"rowred {name} with column splits up to {target} blocks: ms {t['new']!r}")
        ec._ROWRED_BLOCKS = default


if __name__ == "__main__":
    main()
