"""Where one warm 20,000-cell Morpho pair spends its time on the card, for
the PyTorch/CUDA port (`spateo_tpu_torch`).

Runs `align.morpho_align` on `bench._make_slice_pair(20000)` (50 genes, kl,
SVI batch 2,000, 200 iterations) twice to warm up, then once under
`torch.profiler`. Prints the wall time, the device's busy time and idle
share (device-side events only: kernels and copies), the number of device
events, and the kernels and host ops that take the most time. Needs one
NVIDIA GPU; run from the repository root:

    python3 scripts/profile_port_morpho.py
"""

import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bench  # noqa: E402
import spateo_tpu_torch as stt  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pts, ptsA, X = bench._make_slice_pair(20000, seed=2)

    def run():
        fixed, moving = bench._mk_adata(stt, pts, X), bench._mk_adata(stt, ptsA, X)
        stt.align.morpho_align([fixed, moving], spatial_key="spatial", key_added="align", max_iter=200, verbose=False)

    run()
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
    print(f"{torch.cuda.get_device_name(0)}; one warm pair: {plain_ms!r} ms without the profiler, "
          f"{wall_ms!r} ms under it")
    print(f"device busy {busy_ms!r} ms, idle share {1 - busy_ms / wall_ms!r} (under the profiler), "
          f"{1 - busy_ms / plain_ms!r} (busy time against the unprofiled wall), device events {len(device)}")
    by_name = {}
    for e in device:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    print("device time by kernel (count, ms):")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]:
        print(f"  {n:6d} {t:9.3f}  {name[:100]}")
    print("host self time by op (count, ms):")
    for e in sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:15]:
        print(f"  {e.count:6d} {e.self_cpu_time_total / 1e3:9.3f}  {e.key[:100]}")


if __name__ == "__main__":
    main()
