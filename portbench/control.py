"""Read a cell's compared numbers on many seeds in one process, on the
card: with `--program control` (the default) the plain reference at the
precision below the configuration's (`reference/<config>.py`) in the
program's place, whose readings set the upper end of each limit; with
`--program port` the program itself, whose readings set the lower end
(PERF.md). Each seed is driven through a short window at the cell's own
sizes and judged as a run judges the program. The benchmark's runs never
run this.

    python3 portbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...] [--program port]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", choices=("control", "port"), default="control")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        res = run.execute(args.workload, seed, args.seconds, False, program=args.program, t0=time.perf_counter())
        print(json.dumps({"workload": args.workload, "seed": seed, "program": args.program, "correct": res["correct"],
                          "judged": res["judged"], "metrics": res["metrics"], "checks": res["checks"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
