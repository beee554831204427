"""Whether `profiler.trace` keeps every kernel record when it runs minutes
after a process starts, as `chip_smoke.py`'s phase 34 trace process does
(`TRACE_CHILD`, which imports and warms the card up, then waits for a line
on stdin). Three such processes start together on the card: one that also
runs a short trace before it waits (a profiler warm-up) and is told to
trace after 150 s, and two without, told after 165 s and 300 s. Each line
prints the `jacobi_kernel` events the served Perfetto file holds against
the launches, and the process's seconds.

    python3 scripts/trace_wait_probe.py
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

FIRST = 'seconds["card, first sweeps"] ='
WARM_UP = 'with tempfile.TemporaryDirectory() as tmp, profiler.trace(tmp):\n    torch.cuda.synchronize()\n'


def main():
    assert FIRST in cs.TRACE_CHILD
    variants = {
        "profiler warm-up, traced after 150 s": (cs.TRACE_CHILD.replace(FIRST, WARM_UP + FIRST), 150),
        "no warm-up, traced after 165 s": (cs.TRACE_CHILD, 165),
        "no warm-up, traced after 300 s": (cs.TRACE_CHILD, 300),
    }
    procs = {k: subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdin=subprocess.PIPE,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for k, (code, _) in variants.items()}
    t0 = time.time()
    try:
        for k, (_, wait) in sorted(variants.items(), key=lambda kv: kv[1][1]):
            time.sleep(max(0.0, wait - (time.time() - t0)))
            out, err = procs[k].communicate(input="trace\n", timeout=300)
            if procs[k].returncode:
                print(f"{k}: failed: {err[-1500:]}", flush=True)
                continue
            tr = json.loads(out.strip().splitlines()[-1])
            print(f"{k}: {tr['kernels']} jacobi_kernel events for {tr['launched']} launches; events by category "
                  f"{tr['categories']}; seconds {tr['seconds']}", flush=True)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


if __name__ == "__main__":
    main()
