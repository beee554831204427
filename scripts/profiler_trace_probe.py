"""Time torch.profiler's two ways of reading a trace on the card: the raw
kineto events (`prof.profiler.kineto_results.events()`, what
`chip_smoke.device_profile` reads) and `prof.events()` (which builds the
event tree), over 30,000 small kernels (~180,000 events), and check that
both give the same device busy ms, kernel launches and device op names.

    python3 scripts/profiler_trace_probe.py
"""

import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profiler_trace_probe: needs an NVIDIA GPU")
    x = torch.ones(1000, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(30_000):
            x = x * 1.0000001 + 0.0
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw = prof.profiler.kineto_results.events()
    busy_raw = sum(e.duration_ns() for e in raw if e.device_type() == DeviceType.CUDA) / 1e6
    launches_raw = sum(1 for e in raw if e.name() == "cudaLaunchKernel")
    t1 = time.perf_counter()
    ev = prof.events()
    busy = sum(e.time_range.elapsed_us() for e in ev if e.device_type == DeviceType.CUDA) / 1e3
    launches = sum(1 for e in ev if e.name == "cudaLaunchKernel")
    t2 = time.perf_counter()
    same_names = sorted({e.name() for e in raw if e.device_type() == DeviceType.CUDA}) == sorted(
        {e.name for e in ev if e.device_type == DeviceType.CUDA})
    print(f"torch {torch.__version__}: raw trace {t1 - t0!r} s, event tree {t2 - t1!r} s for {len(raw)} events; "
          f"busy ms {busy_raw!r} / {busy!r}, launches {launches_raw} / {launches}, same op names {same_names}")


if __name__ == "__main__":
    main()
