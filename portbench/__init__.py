"""The benchmark of the PyTorch and CUDA port (`spateo_tpu_torch`).

`run.py` runs one cell once. A cell (`workloads/<cell>.json`) names its
configuration (`configs/<config>.json`), whose `driver` (`drivers/`) drives
the port's entry point through a window on traffic from `traffic/`, and
whose `reference` (`reference/`) decides whether the window's outputs are
correct. Each per-layer metric is a reader of its own in `metrics/`. Files
are found by the names in `BENCHMARK.json`; nothing here imports JAX, the
JAX package or the JAX benchmark, and the references import nothing of
the port.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(rel: str) -> dict:
    """A JSON file under this directory."""
    return json.loads((HERE / rel).read_text())


def load_by_path(rel: str):
    """The module in the file `rel` under this directory (names may hold
    dots and dashes), loaded once a process."""
    name = "portbench._files." + rel.replace("/", ".").removesuffix(".py").replace("-", "_").replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, HERE / rel)
    if spec is None or not (HERE / rel).is_file():
        raise FileNotFoundError(f"portbench: no file {HERE / rel}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module
