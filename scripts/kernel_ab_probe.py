"""Before/after of the redesigned kernels on one NVIDIA GPU, in turns.

    python3 scripts/kernel_ab_probe.py [--only bp,colnorm,inlier,rowred,jacobi]

Builds the previous designs kept in `scripts/baseline/` (the Jacobi kernel
with T = 8 and 64x64 tiles in shared memory, `jacobi_shared_tile.cu`; the
E-step whose sweeps restage both factor chunks for every tile and split
sweep 1 into contiguous row ranges, `estep_restaged_tiles.cu`; the inlier
fit in one block of 1,024 threads, `inlier_one_block.cu`; the BP iteration
with a 32x8 block staging a halo tile in shared memory,
`bp_step_block_tile.cu`) with the flags of
`ops/_build.py` beside the current `csrc/` kernels, and times each pair with
CUDA events in the order old, new, new, old at the main path's shapes:

- colnorm: 20,000 x 2,000 and 100,000 x 10,000 (`chip_smoke.estep_case`),
  both against `colnorm_reference` (scaled error), the most live tiles one
  block of a column tile computes under either split rule, then the new
  kernel under other block targets (`_COLNORM_BLOCKS`);
- inlier: the 20k pair's 20,480 NN matches, 100 iterations (old, and the
  new kernel as `inlier_fit` launches it), then the new kernel with
  clusters of 8 and 16 blocks of 256 and 512 threads, and at 200,000 rows;
- rowred: 20,000 x 2,000 and 100,000 x 10,000, both against
  `rowred_reference`, and the three against the same sweep in f64; then
  the new kernel under other column-split targets;
- bp: one iteration at 2048^2 in bf16 and f32 (both against
  `bp_step_reference`, bit for bit), and a checked block of 10 bf16
  iterations as `bp_kernel` runs it (old: 10 launches, then the PyTorch
  delta `delta_reference`; new: 9 launches and one with the fused delta);
  then the new kernel built under other strip rows, warps a block and
  blocks an SM (`-DBP_ROWS`, `-DBP_WARPS`, `-DBP_MIN_BLOCKS`), each with
  ptxas's register and spill report, and the SASS of the bf16 kernel
  counted by `cuobjdump -sass`: instructions in the row loop and per pixel,
  and its MUFU.RCP and division slow-path calls;
- Jacobi: 1024^2 and 2048^2, 2000 sweeps per call; and one solver block of
  100 sweeps with its relative change (old: the kernel then the PyTorch
  reduction `rel_change_reference`; new: the fused sums), as `digitize`
  runs it at 2048^2.

Prints the card's name and power limit first, then one line per case.
"""

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from spateo_tpu_torch.ops import _build, estep_cuda as ec, inlier_cuda as ic, jacobi_cuda as jc  # noqa: E402


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


def stream():
    return torch.cuda.current_stream().cuda_stream


def ab_jacobi(old_j, chip_smoke):
    old_j.jacobi_block_f32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    old_j.jacobi_block_f32.restype = ctypes.c_int

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

#: (pixels a lane, rows, warps, blocks an SM, branch-free division); the first is the default
BP_VARIANTS = ((8, 16, 4, 3, 1), (8, 16, 4, 3, 0), (8, 16, 4, 2, 1), (8, 8, 4, 3, 1), (8, 32, 4, 3, 1),
               (8, 16, 2, 6, 1), (4, 16, 4, 4, 1), (4, 8, 4, 4, 1))
BP_KEYS = ("BP_PIXELS", "BP_ROWS", "BP_WARPS", "BP_MIN_BLOCKS", "BP_FAST_DIV")


def nvcc_variant(src, out_dir, defines):
    """Build `src` with -D `defines` ({name: value}); returns (library, ptxas report)."""
    tag = "_".join(f"{k}{v}" for k, v in defines.items())
    lib = Path(out_dir) / f"lib{Path(src).stem}_{tag}.so"
    flags = [f"-D{k}={v}" for k, v in defines.items()]
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", *flags, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src} {defines}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib)), lib, proc.stderr


def ptxas_summary(report):
    """(kernel, registers, spill stores, spill loads) for each bp_step_kernel in a ptxas -v report."""
    out, name, spill = [], None, (None, None)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), (None, None)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name and "bp_step_kernel" in name:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name and "bp_step_kernel" in name:
            out.append((name, int(m.group(1))) + spill)
    return out


def sass_counts(lib_path):
    """Per bp_step_kernel in the library: static SASS instructions, those
    inside the row loop (the largest backward branch), the loop's slow
    region (the largest forward branch inside it: the rows that take IEEE
    division), what a row on the branch-free path runs (loop less slow
    region), and MUFU.RCP and CALL (the division slow path) in the loop."""
    tool = shutil.which("cuobjdump") or str(Path(_build._nvcc()).parent / "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True, check=True).stdout
    out = {}
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name = part.split("\n", 1)[0].strip()
        if "bp_step_kernel" not in name:
            continue
        ins = [(int(a, 16), op) for a, op in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part)]
        branches = []
        for at, op in ins:
            m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", op)
            if m:
                branches.append((at, int(m.group(1), 16)))
        lo, hi = max(((t, a) for a, t in branches if t < a), key=lambda b: b[1] - b[0], default=(0, -1))
        body = [op for at, op in ins if lo <= at <= hi]
        fwd = [(a, t) for a, t in branches if lo <= a < t <= hi]
        slow = max((sum(1 for at, _ in ins if a < at < t) for a, t in fwd), default=0)
        out[name] = dict(total=len(ins), loop=len(body), slow_region=slow, fast_row=len(body) - slow,
                         mufu_rcp=sum("MUFU.RCP" in op for op in body),
                         calls=sum(op.split()[0].startswith("CALL") or " CALL" in op for op in body))
    return out


def ab_bp(old_b, chip_smoke):
    from spateo_tpu_torch.ops import bp_cuda as bc

    for fn in (old_b.bp_step_f32, old_b.bp_step_bf16):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    P, Q = chip_smoke.BP_P, chip_smoke.BP_Q
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    H = W = 2048
    phi = torch.rand((2, H, W), generator=gen, device="cuda") + 0.05
    phi = (phi / phi.sum(0, keepdim=True)).contiguous()
    M32 = torch.rand((4, H, W), generator=gen, device="cuda") * 0.96 + 0.02

    def old_step(M):
        out = torch.empty_like(M)
        fn = old_b.bp_step_bf16 if M.dtype == torch.bfloat16 else old_b.bp_step_f32
        if fn(phi.data_ptr(), M.data_ptr(), out.data_ptr(), H, W, P, Q, stream()):
            raise RuntimeError("old bp_step launch failed")
        return out

    for dt in (torch.bfloat16, torch.float32):
        M = M32.to(dt)
        ref = bc.bp_step_reference(phi, M, P, Q)
        same = torch.equal(old_step(M), ref) and torch.equal(bc.bp_step(phi, M, P, Q), ref)
        t = ms_turns({"old": lambda: old_step(M), "new": lambda: bc.bp_step(phi, M, P, Q)}, 50)
        gb = (8 + 8 * M.element_size()) * H * W / 1e9
        print(f"bp {H}x{W} {dt}: ms old {t['old']!r}, new {t['new']!r}; GB/s new "
              f"{[gb / x * 1e3 for x in t['new']]!r}; both equal to the plain version {same}")

    M = M32.to(torch.bfloat16)

    def old_block():
        A = M
        for _ in range(9):
            A = old_step(A)
        B = old_step(A)
        return B, bc.delta_reference(B, A)

    def new_block():
        A = M
        for _ in range(9):
            A = bc.bp_step(phi, A, P, Q)
        return bc.bp_step(phi, A, P, Q, delta=True)

    (o_old, d_old), (o_new, d_new) = old_block(), new_block()
    t = ms_turns({"old": old_block, "new": new_block}, 10)
    print(f"bp checked block of 10 bf16 iterations at {H}x{W}, ms: old (kernel + PyTorch delta) {t['old']!r}, "
          f"new (fused delta) {t['new']!r}; delta old {float(d_old)!r}, new {float(d_new)!r}, messages equal "
          f"{torch.equal(o_old, o_new)}")
    t = ms_turns({"plain launch": lambda: bc.bp_step(phi, M, P, Q),
                  "fused delta": lambda: bc.bp_step(phi, M, P, Q, delta=True)}, 50)
    print(f"bp {H}x{W} bf16 one launch, ms: {t!r}")

    src = ROOT / "spateo_tpu_torch" / "csrc" / "bp_step.cu"
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(BP_VARIANTS)) as pool:
        builds = [pool.submit(nvcc_variant, src, tmp, dict(zip(BP_KEYS, v))) for v in BP_VARIANTS]
        builds = [f.result() for f in builds]
        for v, (lib, path, report) in zip(BP_VARIANTS, builds):
            for name, c in sass_counts(path).items():
                V = v[0]
                if "Lb0E" not in name or f"Li{V}E" not in name:
                    continue  # the widest access without the fused delta: the main path's kernel
                print(f"bp SASS {dict(zip(BP_KEYS, v))} {name}: {c}; instructions a pixel on the branch-free path "
                      f"{c['fast_row'] / V!r}")
            print(f"bp variant {dict(zip(BP_KEYS, v))}: ptxas (kernel, registers, spill stores, spill loads) "
                  f"{ptxas_summary(report)}")
        fns = {}
        for key, (lib, _, _) in zip(BP_VARIANTS, builds):
            for fn in (lib.bp_step_f32, lib.bp_step_bf16):
                fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 3
                fn.restype = ctypes.c_int
            fns[key] = lib
        for dt in (torch.bfloat16, torch.float32):
            Mx = M32.to(dt)
            out = torch.empty_like(Mx)

            def run(lib, Mx=Mx, out=out):
                bf16 = Mx.dtype == torch.bfloat16
                cfg = (ctypes.c_int * 4)()
                lib.bp_step_config(cfg)
                K = min(cfg[0], 16 // Mx.element_size())
                fn = lib.bp_step_bf16 if bf16 else lib.bp_step_f32
                if fn(phi.data_ptr(), Mx.data_ptr(), out.data_ptr(), H, W, K, P, Q, None, None, stream()):
                    raise RuntimeError("bp variant launch failed")
                return out

            ref = bc.bp_step_reference(phi, Mx, P, Q)
            ok = {k: torch.equal(run(lib).clone(), ref) for k, lib in fns.items()}
            t = ms_turns({k: (lambda lib=lib: run(lib)) for k, lib in fns.items()}, 50)
            print(f"bp variants {H}x{W} {dt} {BP_KEYS}: " + ", ".join(
                f"{k} ms {t[k]!r} equal {ok[k]}" for k in fns))


ESTEP_CASES = (("20000x2000", 20000, 2000, 0.05, 1), ("100000x10000", 100000, 10000, 1e-3, 2))


def ab_rowred(old_e, chip_smoke):
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    old_e.estep_rowred.argtypes = [ptr] * 9 + [i32] * 3 + [f32, ptr]
    old_e.estep_rowred.restype = i32
    for name, NA, B, s2, seed in ESTEP_CASES:
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


def ab_colnorm(old_e, chip_smoke):
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    old_e.estep_colnorm.argtypes = [ptr] * 10 + [i32] * 5 + [f32, ptr]
    old_e.estep_colnorm.restype = i32
    for name, NA, B, s2, seed in ESTEP_CASES:
        args = chip_smoke.estep_case(NA, B, s2, seed)
        xa, cb, fat, fbt, bt, mm, scal, skip = ec.prepare(*args[:1], *args[2:])
        G1 = fat.shape[0]
        n_ta, n_tb = -(-NA // ec.TM), -(-B // ec.TN)
        # the old design's contiguous row ranges
        splits = min(n_ta, max(1, -(-528 // n_tb)))
        per_split = -(-n_ta // splits)
        splits = -(-n_ta // per_split)

        def old_colnorm():
            out = torch.zeros((5, B), dtype=torch.float32, device="cuda")
            partial = torch.empty((splits, 4, B), dtype=torch.float32, device="cuda")
            if old_e.estep_colnorm(xa.data_ptr(), cb.data_ptr(), fat.data_ptr(), fbt.data_ptr(), bt.data_ptr(),
                                   mm.data_ptr(), scal.data_ptr(), skip.data_ptr(), partial.data_ptr(),
                                   out.data_ptr(), NA, B, G1, splits, per_split, float(ec._SKIP_MULT), stream()):
                raise RuntimeError("old colnorm launch failed")
            return out

        new_colnorm = lambda: ec.colnorm(xa, cb, fat, fbt, bt, mm, scal, skip)
        ref = ec.colnorm_reference(xa, cb, fat, fbt, bt, mm, scal)
        errs = {k: max(chip_smoke.scaled_err(ref[q], fn()[q]) for q in range(5))
                for k, fn in (("old", old_colnorm), ("new", new_colnorm))}
        # live tiles (by the bbox mask) of the busiest block of each rule
        live = (skip.reshape(n_ta, n_tb) == 0).cpu()
        old_max = max(int(live[s * per_split:(s + 1) * per_split, jt].sum()) for jt in range(n_tb)
                      for s in range(splits))
        new_split = ec.colnorm_splits(NA, B)
        new_max = max(len(t) for per in ec.colnorm_assignment(skip, NA, B, new_split) for t in per)
        print(f"colnorm {name}: live tiles {int(live.sum())} of {n_ta * n_tb}; busiest block: old {old_max} "
              f"({splits} contiguous splits), new {new_max} ({new_split} dealt splits)")
        t = ms_turns({"old": old_colnorm, "new": new_colnorm}, 20 if NA <= 20000 else 5)
        print(f"colnorm {name}: ms old {t['old']!r}, new {t['new']!r}; scaled error vs plain {errs!r}; same bits "
              f"twice {torch.equal(new_colnorm(), new_colnorm())}")
        default = ec._COLNORM_BLOCKS
        for target in (264, 528, 1056, 2112):
            ec._COLNORM_BLOCKS = target
            t = ms_turns({"new": new_colnorm}, 20 if NA <= 20000 else 5)
            print(f"colnorm {name} with blocks up to {target} ({ec.colnorm_splits(NA, B)} splits): ms {t['new']!r}")
        ec._COLNORM_BLOCKS = default


def ab_inlier(old_i, chip_smoke):
    old_i.inlier_fit.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    old_i.inlier_fit.restype = ctypes.c_int
    for N, n in ((20480, 20000), (200000, 195000)):
        args, _ = chip_smoke.inlier_case(n, N)
        prep = ic.kernel_inputs(*args)[:5]
        x, y, d, m, scal = prep
        bufs = [torch.empty((2, N), device="cuda"), torch.empty(N, device="cuda"), torch.empty(8, device="cuda")]

        def old_fit():
            if old_i.inlier_fit(x.data_ptr(), y.data_ptr(), d.data_ptr(), m.data_ptr(), scal.data_ptr(),
                                bufs[0][0].data_ptr(), bufs[0][1].data_ptr(), bufs[1].data_ptr(), bufs[2].data_ptr(),
                                N, 100, stream()):
                raise RuntimeError("old inlier launch failed")
            return bufs[1].clone(), bufs[2].clone()

        def launch(*layout):
            return old_fit() if not layout else ic.launch(*prep, 100, layout)

        ref = ic.inlier_reference(*args)
        layouts = {f"C={C} NT={NT}": ic.inlier_layout(N, C, NT)[:3] for C in (8, 16) for NT in (256, 512)}
        errs = {}
        for k, lay in [("old", ())] + list(layouts.items()):
            p, misc = launch(*lay)
            errs[k] = dict(P=float((p - ref[0][:, 0]).abs().max()), R=float((misc[:4] - ref[1].reshape(4)).abs().max()))
        default = ic.inlier_layout(N)[:3]
        t = ms_turns({"old": old_fit, "new": lambda: launch(*default)}, 10)
        print(f"inlier {N} rows x 100 iterations: ms old {t['old']!r}, new {t['new']!r} (layout {default}); "
              f"errors vs plain {errs!r}")
        t = ms_turns({k: (lambda lay=lay: launch(*lay)) for k, lay in layouts.items()}, 10)
        print(f"inlier {N} rows, cluster and threads: " + ", ".join(f"{k} {lay} ms {t[k]!r}"
                                                                 for k, lay in layouts.items()))
    # where the time goes: 16 rows (the chain of 302 cluster reductions and
    # almost no row work) against 20,480, for each cluster size
    for N in (16, 20480):
        args, _ = chip_smoke.inlier_case(N - N // 40, N)
        prep = ic.kernel_inputs(*args)[:5]

        def run(lay, iters=100):
            ic.launch(*prep, iters, lay)

        lays = {C: ic.inlier_layout(N, C, 256)[:3] for C in (1, 2, 4, 8, 16)}
        t = ms_turns({f"C={C}": (lambda lay=lay: run(lay)) for C, lay in lays.items()}, 10)
        t0 = ms_turns({f"C={C}": (lambda lay=lay: run(lay, 0)) for C, lay in lays.items()}, 10)
        print(f"inlier {N} rows, 256 threads, us per iteration over 100 (0 iterations: 2 reductions, ms): "
              + ", ".join(f"C={C} {lay}: {[v * 10 for v in t[f'C={C}']]!r} ({t0[f'C={C}']!r})"
                          for C, lay in lays.items()))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab_probe: needs an NVIDIA GPU")
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="bp,colnorm,inlier,rowred,jacobi")
    parts = ap.parse_args().only.split(",")
    import chip_smoke

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    baseline = ROOT / "scripts" / "baseline"
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(6) as pool:
        old = {n: pool.submit(nvcc, baseline / f, tmp) for n, f in (("jacobi", "jacobi_shared_tile.cu"),
                                                                   ("estep", "estep_restaged_tiles.cu"),
                                                                   ("inlier", "inlier_one_block.cu"),
                                                                   ("bp", "bp_step_block_tile.cu"))}
        new = [pool.submit(_build.build, n) for n in ("jacobi", "estep", "inlier", "bp_step")]
        old = {n: f.result() for n, f in old.items()}
        for f in new:
            f.result()
    if "bp" in parts:
        ab_bp(old["bp"], chip_smoke)
    if "colnorm" in parts:
        ab_colnorm(old["estep"], chip_smoke)
    if "inlier" in parts:
        ab_inlier(old["inlier"], chip_smoke)
    if "rowred" in parts:
        ab_rowred(old["estep"], chip_smoke)
    if "jacobi" in parts:
        ab_jacobi(old["jacobi"], chip_smoke)


if __name__ == "__main__":
    main()
