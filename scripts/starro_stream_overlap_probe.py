"""The Starro stream's pipeline on the card: where its copies run, what it
hides, and what its staging worker costs the main thread.

On four 2048² `bench.make_raster` tiles (mask only, BP 50 iterations), after
a one-tile warm-up, in a fresh process:

1. one stream under torch.profiler, the process's first trace (``--cuda-only``
   records device activity only, without the host ops' profiling cost): for
   each copy on a stream that runs no kernel (the rasters going up, the
   packed masks coming back), its start and length, the compute stream's
   kernels before and after it (the gaps, in us, and their names) and
   inside it; the longest runs of kernels queued back to back, and the
   kernels by their longest launch;
2. per-tile `starro_em_bp` calls against the stream, in turns (calls,
   stream, stream, calls, five times), host ms each, the card synchronised;
3. one tile's steps 1-7 (`_starro_em_bp_fused` on a landed raster) alone
   and with the next three tiles staged (`_stage`) on a thread beside it,
   in turns, five times: the staging's cost to the main thread's launches.

Prints each part. Run on a machine with a card, from the repository root:

    python3 scripts/starro_stream_overlap_probe.py [--cuda-only]
"""

import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench import make_raster  # noqa: E402
from spateo_tpu_torch.segmentation import starro as ts  # noqa: E402

KW = dict(k=5, seed=0, bp_max_iter=50, mask_only=True)


def host_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def copies_under_the_profiler(tiles):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] if "--cuda-only" in sys.argv else [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        wall = host_ms(lambda: list(ts.starro_em_bp_stream(tiles, **KW)))
    gpu, launches = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            gpu.append((e.start_ns(), e.end_ns(), e.device_resource_id(), e.name()))
        elif e.name() in ("cudaLaunchKernel", "cudaMemcpyAsync", "cudaStreamWaitEvent", "cudaEventRecord",
                          "cudaStreamSynchronize", "cudaEventSynchronize"):
            launches.append((e.start_ns(), e.name()))
    base = min(g[0] for g in gpu)
    is_kernel = lambda g: not g[3].startswith(("Memcpy", "Memset"))
    kernel_streams = {g[2] for g in gpu if is_kernel(g)}
    kernels = sorted(g for g in gpu if g[2] in kernel_streams and is_kernel(g))
    rows = []
    for c0, c1, sid, name in sorted(g for g in gpu if g[2] not in kernel_streams):
        before = [k for k in kernels if k[1] <= c0]
        after = [k for k in kernels if k[0] >= c1]
        host = [n for t, n in launches if c0 <= t < c1]
        rows.append({
            "copy": name, "stream": sid, "start_us": (c0 - base) / 1e3, "us": (c1 - c0) / 1e3,
            "gap_before_us": (c0 - before[-1][1]) / 1e3 if before else None,
            "kernel_before": before[-1][3][:80] if before else None,
            "gap_after_us": (after[0][0] - c1) / 1e3 if after else None,
            "kernel_after": after[0][3][:80] if after else None,
            "kernels_inside": sum(k[0] < c1 and k[1] > c0 for k in kernels),
            "host_calls_inside": {n: host.count(n) for n in set(host)},
        })
    # runs of kernels queued back to back (each starting within 2 us of the
    # last one's end): where the card has work queued ahead of the host
    runs, cur = [], [kernels[0]]
    for prev, k in zip(kernels, kernels[1:]):
        if k[0] - prev[1] < 2000:
            cur.append(k)
        else:
            runs.append(cur)
            cur = [k]
    runs.append(cur)
    runs.sort(key=lambda r: r[0][0] - r[-1][1])
    by_name = {}
    for k in kernels:
        n, t, mx = by_name.get(k[3][:70], (0, 0.0, 0.0))
        by_name[k[3][:70]] = (n + 1, t + (k[1] - k[0]) / 1e3, max(mx, (k[1] - k[0]) / 1e3))
    return {
        "wall_ms": wall, "kernels": len(kernels), "kernel_ms": sum(k[1] - k[0] for k in kernels) / 1e6,
        "copies": rows,
        "longest_runs": [((r[-1][1] - r[0][0]) / 1e3, len(r), r[0][3][:60]) for r in runs[:8]],
        "longest_kernels": sorted(by_name.items(), key=lambda kv: -kv[1][2])[:10],
    }


def calls_against_stream(tiles, rounds=5):
    calls = lambda: [ts.starro_em_bp(t, **KW) for t in tiles]
    stream = lambda: list(ts.starro_em_bp_stream(tiles, **KW))
    out = {"calls": [], "stream": []}
    for _ in range(rounds):
        for name in ("calls", "stream", "stream", "calls"):
            out[name].append(host_ms(calls if name == "calls" else stream))
    return out


def staging_beside_compute(tiles, rounds=5):
    X0 = ts._upload(tiles[0], "cuda")
    fused = lambda: list(ts._starro_em_bp_fused([X0], 5, 7, ts._n_samples(X0.numel(), 0.001), 2000, 1e-6,
                                                ts._offsets(3, False), 0.6, 0.4, 1e-6, 50, True, "bfloat16", 0,
                                                pack_mask=True))
    bufs = ts._HostBuffers(pinned=True)
    stage = lambda t: bufs.give(ts._stage(t, bufs)[1])  # into a reused buffer, as the stream stages
    stage_ms = min(host_ms(lambda: stage(tiles[1])) for _ in range(3))
    out = {"stage_ms": stage_ms, "alone": [], "beside": []}
    with ThreadPoolExecutor(max_workers=1) as ex:
        for _ in range(rounds):
            out["alone"].append(host_ms(fused))
            staged = ex.submit(lambda: [stage(t) for t in tiles[1:]])
            out["beside"].append(host_ms(fused))
            staged.result()
    return out


def main():
    tiles = [make_raster(2048, 2048, seed=s) for s in range(4)]
    list(ts.starro_em_bp_stream(tiles[:1], **KW))
    card = f"{torch.cuda.get_device_name(0)}"
    result = {"card": card, "profiled": copies_under_the_profiler(tiles)}
    result["calls_against_stream"] = calls_against_stream(tiles)
    result["staging_beside_compute"] = staging_beside_compute(tiles)
    prof = result["profiled"]
    print(f"{card}; stream of 4 tiles under the profiler {prof['wall_ms']!r} ms, {prof['kernels']} kernels "
          f"({prof['kernel_ms']!r} ms)")
    for r in prof["copies"]:
        print(json.dumps(r))
    print("longest runs of back-to-back kernels (us, kernels, first kernel):", prof["longest_runs"])
    print("kernels by longest (name: count, total us, max us):", prof["longest_kernels"])
    print("per-tile calls and the stream, in turns (ms):", json.dumps(result["calls_against_stream"]))
    print("one tile's steps 1-7 alone and with three tiles staged beside it (ms):",
          json.dumps(result["staging_beside_compute"]))


if __name__ == "__main__":
    main()
