"""Run one cell of the port's benchmark once, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: set-up (the port's CUDA libraries built or
loaded from `spateo_tpu_torch/_build/`, the cell's inputs made from the
seed, one unit of work of each of the cell's shapes), then the window of
`--seconds`, then the check of the window's outputs against the plain
reference. The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), `device`, with `--trace 1` a
`breakdown`, and last `checks`, each compared number beside its limit; the
same numbers are the last lines of standard error. With no card, or fewer
than the cell asks for, it prints no result and exits with 2.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import load_by_path, load_json, trace  # noqa: E402

#: Top-level module names that no run may load: JAX, and the JAX package
#: and benchmark beside the port (compared whole: the port's own name
#: begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "spateo_tpu", "bench")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cell(name: str):
    """(BENCHMARK.json, workload, config) of a cell."""
    spec = json.loads((Path(__file__).resolve().parent.parent / "BENCHMARK.json").read_text())
    workload = load_json(f"workloads/{name}.json")
    return spec, workload, load_json(f"configs/{workload['config']}.json")


def metrics_of(spec: dict, name: str, traced: bool):
    """The BENCHMARK.json entries of the metrics this cell reports."""
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    if not traced:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"] if name in m.get("workloads", [name] if m["moves"] in reported else [])]


def execute(name: str, seed: int, seconds: float, traced: bool, device: str = "cuda", program: str = "port",
            t0: float = None, overrides: dict = None) -> dict:
    """One run of a cell; returns the result's fields (without printing).
    `program="control"` puts the configuration's control in the program's
    place. `overrides` ({"params": ..., "settings": ...}) shrinks a cell's
    traffic or settings for the CPU tests; the benchmark passes none."""
    import torch

    t0 = _T0 if t0 is None else t0
    spec, workload, config = cell(name)
    overrides = overrides or {}
    workload = dict(workload, params={**workload["params"], **overrides.get("params", {})})
    config = dict(config, settings={**config["settings"], **overrides.get("settings", {})})
    on_card = str(device).startswith("cuda")
    if on_card and program == "port":
        from spateo_tpu_torch.ops import _build

        for lib in config["kernels"]:
            _build.load(lib)
    driver = load_by_path(f"drivers/{config['driver']}.py").Driver(config, workload, seed, device, program)
    driver.setup()
    setup_s = time.perf_counter() - t0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    out = driver.window(seconds, traced)
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    driver.release()
    t_judge = time.perf_counter()
    checks, failed, judged = driver.judge()
    print(f"portbench: set-up {setup_s:.1f} s, window {out['window_s']:.1f} s, {judged} judged in "
          f"{time.perf_counter() - t_judge:.1f} s", file=sys.stderr)
    values = dict(out["e2e"], setup_s=setup_s)
    metrics = {}
    for m in metrics_of(spec, name, traced):
        if traced:
            value = load_by_path(f"metrics/{m['name']}.py").read(out["span"]) if out["span"] else None
        else:
            value = values.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    # nothing judged proves nothing
    result = {"correct": judged > 0 and failed == 0 and all(v <= lim for _, v, lim in checks),
              "attempted": int(out["attempted"]), "failed": int(failed), "metrics": metrics, "device": dev}
    if traced and out["span"] is not None:
        span = out["span"]
        dev["busy_s"] = trace.busy_ns(span) / 1e9
        dev["window_s"] = span.window_ns / 1e9
        result["breakdown"] = trace.breakdown(span)
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    result["judged"] = judged
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(1)  # one process, few threads: the launching thread and the stream's worker
    _, workload, _ = cell(args.workload)
    need = int(workload["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < need:
        print(f"portbench: {args.workload} needs {need} CUDA device(s), found {found}; no result", file=sys.stderr)
        return 2
    from portbench import peaks

    print(f"portbench: {args.workload} seed {args.seed} on {peaks.power_limit()}", file=sys.stderr)
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace))
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}; no result", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result["checks"] = checks  # last in the line
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
