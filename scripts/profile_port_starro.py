"""Where one warm 2048x2048 Starro tile spends its time on the card, for the
PyTorch/CUDA port (`spateo_tpu_torch`).

Runs `cs.score_and_mask_pixels` (k=5, BP 50 iterations) twice to warm up,
then once under `torch.profiler`. Prints the wall time, the device's busy
time and idle share (device-side events only: kernels and copies), the
number of kernel launches, and the kernels and host ops that take the most
time. Needs one NVIDIA GPU; run from the repository root:

    python3 scripts/profile_port_starro.py
"""

import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench import make_raster  # noqa: E402
import spateo_tpu_torch as stt  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    X = make_raster(2048, 2048, seed=0)

    def run():
        a = stt.AnnData(X=X)
        stt.SKM.init_adata_type(a, stt.SKM.ADATA_AGG_TYPE)
        stt.cs.score_and_mask_pixels(a, "X", k=5, method="EM+BP", em_kwargs=dict(seed=0), bp_kwargs=dict(max_iter=50))

    run()
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
    print(f"{torch.cuda.get_device_name(0)}; one warm tile under the profiler: wall {wall_ms!r} ms")
    print(f"device busy {busy_ms!r} ms, idle share {1 - busy_ms / wall_ms!r}, device events {len(device)}")
    by_name = {}
    for e in device:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    print("device time by kernel (count, ms):")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"  {n:6d} {t:9.3f}  {name[:100]}")
    print("host self time by op (count, ms):")
    for e in sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:12]:
        print(f"  {e.count:6d} {e.self_cpu_time_total / 1e3:9.3f}  {e.key[:100]}")


if __name__ == "__main__":
    main()
