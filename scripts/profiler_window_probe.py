"""Which `profiler.trace` windows keep the card's kernel events in a long
process. With no argument: every 90 s for 6 minutes, trace 100 Jacobi
sweeps at 1024² with no padding and with 0.5 s of host time before and
after them. With ``--after-load``: first a profiled session of 30,000 small
kernels, then `chip_smoke`'s profiled t-SNE stage on a 20,000-cell section
(the load that precedes phase 34 in a whole run), each followed by the
variants below. Each line prints the kernel events the Chrome trace holds,
the launches it holds, the smallest gap between a kernel's start and its
launch call's start (negative: the kernel is stamped before its launch) and
the trace's span; and, from the same session's raw kineto events (what
`chip_smoke.device_profile` reads), the device events and the distance of
the first and last kernel from the window's ends.

    python3 scripts/profiler_window_probe.py [--after-load]

torch.profiler drops device events stamped outside the host's capture
window.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from spateo_tpu_torch import profiler  # noqa: E402
from spateo_tpu_torch.ops import jacobi_cuda as jc  # noqa: E402


def session(f, upd, pad, extra_ops=0):
    """One trace of 100 sweeps with `pad` seconds of host time on each side
    and `extra_ops` small kernels after them: (kernel events, launch events,
    smallest kernel-launch gap in us, span in us)."""
    with tempfile.TemporaryDirectory() as tmp:
        with profiler.trace(tmp):
            time.sleep(pad)
            jc.jacobi_block(f, upd, 100)
            x = torch.ones(1000, device="cuda")
            for _ in range(extra_ops):
                x = x * 1.0000001
            torch.cuda.synchronize()
            time.sleep(pad)
        with open(os.path.join(tmp, os.listdir(tmp)[0])) as fh:
            ev = json.load(fh)["traceEvents"]
    kern = sorted((e for e in ev if e.get("cat") == "kernel" and "jacobi" in str(e.get("name"))),
                  key=lambda e: e["ts"])
    launch = sorted((e for e in ev if e.get("cat") == "cuda_runtime" and "Launch" in str(e.get("name"))),
                    key=lambda e: e["ts"])
    ts = [e["ts"] for e in ev if e.get("ts") is not None]
    gaps = [k["ts"] - la["ts"] for k, la in zip(kern, launch)]
    return len(kern), len(launch), min(gaps) if gaps else None, max(ts) - min(ts) if ts else None


def raw_session(f, upd, pad):
    """The same work under torch.profiler read as raw kineto events: (device
    events, jacobi kernels, first kernel's start minus the window's first
    event in ms, the window's last event minus the last kernel's end in ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        jc.jacobi_block(f, upd, 100)
        torch.cuda.synchronize()
        time.sleep(pad)
    events = prof.profiler.kineto_results.events()
    dev = [e for e in events if e.device_type() == DeviceType.CUDA]
    kern = [e for e in dev if "jacobi" in e.name()]
    host = [e for e in events if e.device_type() != DeviceType.CUDA]
    if not kern or not host:
        return len(dev), len(kern), None, None
    lo, hi = min(e.start_ns() for e in host), max(e.end_ns() for e in host)
    return (len(dev), len(kern), (min(e.start_ns() for e in kern) - lo) / 1e6,
            (hi - max(e.end_ns() for e in kern)) / 1e6)


def variants(f, upd, tag):
    print(f"{tag}: no padding {session(f, upd, 0.0)}; 0.5 s padding {session(f, upd, 0.5)}; "
          f"0.5 s padding + 5,000 small kernels {session(f, upd, 0.5, 5000)}; 3 s padding {session(f, upd, 3.0)}; "
          f"raw kineto, 0.5 s padding {raw_session(f, upd, 0.5)}", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--after-load", action="store_true")
    after_load = parser.parse_args().after_load
    if not torch.cuda.is_available():
        raise SystemExit("profiler_window_probe: needs an NVIDIA GPU")
    f, upd = cs.jacobi_case(1024, 1024)
    jc.jacobi_block(f, upd, 100)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if after_load:
        import spateo_tpu_torch as stt

        variants(f, upd, "fresh process")

        def small():
            x = torch.ones(1000, device="cuda")
            for _ in range(30_000):
                x = x * 1.0000001 + 0.0
            return x

        cs.device_profile(small)
        variants(f, upd, f"t={time.perf_counter() - t0:.0f}s, after 30,000 profiled kernels")
        cs.tsne_warmup()
        cs.tsne_stage(stt, cs.cluster_section(stt))
        variants(f, upd, f"t={time.perf_counter() - t0:.0f}s, after the profiled t-SNE stage")
        return
    for i in range(5):
        print(f"t={time.perf_counter() - t0:.0f}s (kernels, launches, min kernel-launch gap us, span us): "
              f"no padding {session(f, upd, 0.0)}, 0.5 s padding {session(f, upd, 0.5)}", flush=True)
        if i < 4:
            time.sleep(90)


if __name__ == "__main__":
    main()
