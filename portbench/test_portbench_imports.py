"""No JAX anywhere in a run, and nothing of the program in a reference.

A fresh interpreter imports `portbench/run.py` and every driver, traffic,
metric and reference module, and must then hold no module whose top-level
name (before the first dot, compared whole: `spateo_tpu_torch` begins with
`spateo_tpu`) is `jax`, `jaxlib`, `flax`, `spateo_tpu` or `bench`. A second
interpreter imports the references alone and must hold nothing whose
top-level name is `spateo_tpu_torch` either."""

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "spateo_tpu", "bench")

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
from portbench import load_by_path
for rel in {files!r}:
    load_by_path(rel)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded_after(files):
    code = PROBE.format(root=str(ROOT), files=list(files))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def modules(folder):
    return sorted(f"{folder}/{p.name}" for p in (HERE / folder).glob("*.py") if p.name != "__init__.py")


def test_run_and_every_module_load_no_jax_nor_the_jax_package():
    files = ["run.py", "control.py", "trace.py", "peaks.py"] + [m for f in ("drivers", "traffic", "metrics", "reference")
                                                               for m in modules(f)]
    top = loaded_after(files)
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)


def test_a_run_through_the_program_loads_no_jax():
    # the drivers import the program lazily: drive both entry points a little
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from portbench import run\n"
        "run.execute('starro-bin1.interior', 5, 0.1, False, device='cpu', "
        "overrides={'params': {'tile': 64, 'pool': 3}, 'settings': {'em_batch': 2, 'bp_msg_dtype': 'float32'}})\n"
        "run.execute('morpho-pair.20k', 5, 0.1, False, device='cpu', overrides={'params': {'cells': 300, 'pool': 2}})\n"
        "print(json.dumps(run.forbidden_modules()))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_the_references_load_nothing_of_the_program():
    top = loaded_after(modules("reference"))
    assert "spateo_tpu_torch" not in top and not top & set(FORBIDDEN)
