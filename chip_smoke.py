"""Drive the PyTorch/CUDA port's Starro EM+BP slice on one NVIDIA GPU and
check it. Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases; any failure raises, and the run then exits non-zero without the
final ``ok`` line:

0. environment: a CUDA device is required; prints the card's name and power
   limit, the torch and CUDA versions; TF32 off for matmul and cuDNN.
1. build: compiles the CUDA kernels from `spateo_tpu_torch/csrc`.
2. kernel vs plain version: `bp_step` (the kernel) against
   `bp_step_reference` on the card at 2048x2048 and 1000x1500, in f32 and
   bf16, and full 50-iteration `bp_kernel` runs against the plain loop on
   the CPU; per-iteration times of both at 2048x2048.
3. main path: `cs.score_and_mask_pixels` on a 2048x2048 AGG raster (k=5, BP
   50 iterations, bf16 messages), then four tiles through
   `starro_em_bp_stream`; the launch counts of that run prove the kernel ran.
   A per-stage breakdown of one tile is timed first.
4. CUDA vs CPU: one 512x512 density raster and one NB fit scored on the card
   (kernel) and on the CPU (plain); mask IoU >= 0.999.

The last three lines are the card line from nvidia-smi, a JSON line with
each kernel's launches, error and times, and the ``ok`` JSON line.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

BP_P, BP_Q = 0.6, 0.4
TILE = 2048


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def cuda_ms(fn, n=20):
    """Mean device time of `fn` over `n` back-to-back calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def host_ms(fn):
    """Host time of `fn` run to completion on the card, and its result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def iou(a, b):
    a, b = np.asarray(a, bool), np.asarray(b, bool)
    return float(np.logical_and(a, b).sum() / max(np.logical_or(a, b).sum(), 1))


def phase_kernel_vs_plain(bp_cuda):
    """Phase 2. Returns the 2048^2 bf16 step's error and times (ms)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    tol_step = {torch.float32: 1e-6, torch.bfloat16: 4e-3}  # bf16: 1 ulp on values <= 1
    tol_marg = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
    result = {}
    for H, W in ((TILE, TILE), (1000, 1500)):
        phi = torch.rand((2, H, W), generator=gen, device="cuda") + 0.05
        phi = (phi / phi.sum(0, keepdim=True)).contiguous()
        M32 = torch.rand((4, H, W), generator=gen, device="cuda") * 0.96 + 0.02
        for dt in (torch.float32, torch.bfloat16):
            M = M32.to(dt)
            before = bp_cuda.bp_step.launches
            out_k = bp_cuda.bp_step(phi, M, BP_P, BP_Q)
            torch.cuda.synchronize()
            check(bp_cuda.bp_step.launches == before + 1, "bp_step did not count its launch")
            out_r = bp_cuda.bp_step_reference(phi, M, BP_P, BP_Q)
            check(out_k.dtype == dt and out_k.shape == (4, H, W), f"bp_step output {out_k.dtype} {tuple(out_k.shape)}")
            err = float((out_k.float() - out_r.float()).abs().max())
            edges = torch.cat([out_k[0, -1], out_k[1, 0], out_k[2, :, -1], out_k[3, :, 0]]).float()
            check(bool((edges == 0.5).all()), f"edge planes not 0.5 at {H}x{W} {dt}")
            check(err <= tol_step[dt], f"bp_step vs plain at {H}x{W} {dt}: {err} > {tol_step[dt]}")
            exact = bool(torch.equal(out_k, out_r))
            print(f"phase 2: bp_step {H}x{W} {dt}: max_abs_err={err!r} (tol {tol_step[dt]}), bit-identical={exact}")

            # full loops: the kernel on the card against the plain loop on the CPU
            phi_hw = phi.permute(1, 2, 0).contiguous()
            msg = "float32" if dt == torch.float32 else "bfloat16"
            marg_k = bp_cuda.bp_kernel(phi_hw, BP_P, BP_Q, 1e-6, 50, check_every=10, msg_dtype=msg)
            marg_r = bp_cuda.bp_kernel(phi_hw.cpu(), BP_P, BP_Q, 1e-6, 50, check_every=10, msg_dtype=msg)
            merr = float((marg_k.cpu() - marg_r).abs().max())
            check(merr <= tol_marg[dt], f"bp_kernel marginals at {H}x{W} {dt}: {merr} > {tol_marg[dt]}")
            print(f"phase 2: bp_kernel 50 it {H}x{W} {msg}: marginal max_abs_err={merr!r} (tol {tol_marg[dt]})")

            if H == TILE:
                ms_k = cuda_ms(lambda: bp_cuda.bp_step(phi, M, BP_P, BP_Q))
                ms_r = cuda_ms(lambda: bp_cuda.bp_step_reference(phi, M, BP_P, BP_Q))
                gbytes = (2 * 4 + 8 * M.element_size()) * H * W / 1e9
                print(
                    f"phase 2: per-iteration time {H}x{W} {msg}: kernel {ms_k!r} ms "
                    f"({gbytes / ms_k * 1e3!r} GB/s), plain {ms_r!r} ms"
                )
                if dt == torch.bfloat16:
                    result = dict(max_abs_err=err, ms=ms_k, plain_ms=ms_r)
    return result


def phase_stages(X, ts, em, bp_cuda, report):
    """Phase 3a: one tile stage by stage, synchronised between stages."""
    stages = {}
    t, dev = host_ms(lambda: ts._upload(X, "cuda"))
    stages["upload"] = t
    n_samples = ts._n_samples(X.size, 0.001)
    t, (res, samp, w0, mu0, var0, _) = host_ms(lambda: ts._starro_density_init_sample(dev, 5, n_samples, seed=0))
    stages["density_init_sample"] = t
    stats = {}
    ones = torch.ones((1, n_samples), dtype=torch.bool, device="cuda")
    t, (w, r, p) = host_ms(
        lambda: em._nbn_em_batched(samp[None], ones, w0[None], mu0[None], var0[None], 2000, 1e-6, stats=stats)
    )
    stages["em"] = t
    t, phi = host_ms(lambda: ts._starro_conditionals(res, r[0], p[0]))
    stages["conditionals"] = t
    before = bp_cuda.bp_step.launches
    t, scores = host_ms(lambda: bp_cuda.bp_kernel(phi, BP_P, BP_Q, 1e-6, 50, check_every=10, msg_dtype="bfloat16"))
    stages["bp"] = t
    bp_iters = bp_cuda.bp_step.launches - before
    t, mask = host_ms(lambda: ts._starro_threshold_mask(scores, 7))
    stages["threshold_morphology"] = t
    if report:
        print(
            "phase 3: stages of one 2048x2048 tile (ms, host clock, synchronised): "
            + ", ".join(f"{k}={v!r}" for k, v in stages.items())
            + f"; EM iterations={stats['n_iter']}, BP iterations={bp_iters}, total={sum(stages.values())!r}"
        )
    return bp_iters, mask.cpu().numpy()


def main():
    # -- phase 0: environment --------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 0: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    from bench import make_raster
    import spateo_tpu_torch as stt
    from spateo_tpu_torch.ops import _build, bp_cuda, em
    from spateo_tpu_torch.segmentation import starro as ts

    # -- phase 1: build -------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build("bp_step")
    _build.load("bp_step")
    print(f"phase 1: built {lib.name} in {time.perf_counter() - t0:.2f} s")

    # -- phase 2: kernel vs plain version ----------------------------------------
    kstats = phase_kernel_vs_plain(bp_cuda)

    # -- phase 3: main path ------------------------------------------------------
    X = make_raster(TILE, TILE, seed=0)
    phase_stages(X, ts, em, bp_cuda, report=False)  # warm-up: first-call costs of each op
    bp_iters, stage_mask = phase_stages(X, ts, em, bp_cuda, report=True)

    adata = stt.AnnData(X=X)
    stt.SKM.init_adata_type(adata, stt.SKM.ADATA_AGG_TYPE)
    tiles = [make_raster(TILE, TILE, seed=s) for s in range(4)]
    torch.cuda.reset_peak_memory_stats()
    bp_cuda.bp_step.launches = 0
    t_main, _ = host_ms(
        lambda: stt.cs.score_and_mask_pixels(
            adata, "X", k=5, method="EM+BP", em_kwargs=dict(seed=0), bp_kwargs=dict(max_iter=50)
        )
    )
    launches_single = bp_cuda.bp_step.launches
    t_stream, streamed = host_ms(
        lambda: list(stt.cs.starro_em_bp_stream(tiles, k=5, seed=0, bp_max_iter=50, mask_only=True))
    )
    launches = bp_cuda.bp_step.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    check("X_scores" in adata.layers and "X_mask" in adata.layers, "scores/mask layers missing")
    scores, mask = adata.layers["X_scores"], adata.layers["X_mask"]
    check(mask.dtype == bool and mask.shape == X.shape, f"mask {mask.dtype} {mask.shape}")
    check(scores.shape == X.shape and bool(np.isfinite(scores).all()), "scores not finite or wrong shape")
    fg = float(mask.mean())
    check(0.01 <= fg <= 0.30, f"foreground share {fg} outside [0.01, 0.30]")
    check(launches_single >= bp_iters > 0, f"bp_step launched {launches_single} times, BP ran {bp_iters} iterations")
    check(launches >= launches_single + 4 * bp_iters, f"stream launched {launches - launches_single} kernels")
    check(len(streamed) == 4 and all(m.shape == X.shape and m.dtype == bool for _, m in streamed), "stream output")
    check(np.array_equal(streamed[0][1], mask), "stream tile 0 differs from the single-tile call")
    print(
        f"phase 3: score_and_mask_pixels 2048x2048: {t_main!r} ms ({TILE * TILE / t_main / 1e3!r} Mpixels/s), "
        f"foreground share {fg!r}, scores in [{float(scores.min())!r}, {float(scores.max())!r}], "
        f"mask IoU vs staged run {iou(mask, stage_mask)!r}, bp_step launches {launches_single}"
    )
    print(
        f"phase 3: stream of 4 tiles: {t_stream!r} ms, {4 * TILE * TILE / t_stream / 1e3!r} Mpixels/s; "
        f"peak device memory {peak_gb!r} GB; bp_step launches in the main path {launches}"
    )

    # -- phase 4: CUDA vs CPU at 512^2 ---------------------------------------------
    X4 = make_raster(512, 512, seed=1)
    dev = ts._upload(X4, "cuda")
    n4 = ts._n_samples(X4.size, 0.001)
    res, samp, w0, mu0, var0, _ = ts._starro_density_init_sample(dev, 5, n4, seed=0)
    w, r, p = em._nbn_em_batched(samp[None], torch.ones((1, n4), dtype=torch.bool, device="cuda"), w0[None], mu0[None], var0[None])
    offsets = ts._offsets(3, False)
    s_gpu, m_gpu = ts._starro_score_mask(res, w[0], r[0], p[0], 7, offsets, BP_P, BP_Q, 1e-6, 50, True, "bfloat16")
    s_cpu, m_cpu = ts._starro_score_mask(res.cpu(), w[0].cpu(), r[0].cpu(), p[0].cpu(), 7, offsets, BP_P, BP_Q, 1e-6, 50, False)
    iou4 = iou(m_gpu.cpu().numpy(), m_cpu.numpy())
    serr = float((s_gpu.cpu() - s_cpu).abs().max())
    check(iou4 >= 0.999, f"512x512 CUDA vs CPU mask IoU {iou4} < 0.999")
    print(f"phase 4: 512x512 CUDA (kernel, bf16) vs CPU (plain, f32): mask IoU {iou4!r}, scores max_abs_err {serr!r}")

    print(card)
    print(json.dumps({"kernels": [{
        "name": "bp_step",
        "route": "cuda",
        "source": "spateo_tpu_torch/csrc/bp_step.cu",
        "replaces": "spateo_tpu/ops/bp_pallas.py:63",
        "launches": launches,
        **kstats,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
