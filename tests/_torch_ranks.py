"""Run jobs of `_torch_rank_jobs` on several ranks of a gloo process group on
the CPU, each rank a process of its own.

The ranks join through a file store under the test's temporary directory
(no TCP port, so parallel test workers cannot collide), run one torch thread
each (``OMP_NUM_THREADS=1``) and import neither JAX nor `spateo_tpu`: the
JAX side of a test runs in the pytest process. Each group runs all its jobs
in one start, so the imports are paid once per world size; several groups
start together. A group that outlives `timeout` seconds is killed and the
test fails; a rank that raises fails it with its traceback.
"""

from __future__ import annotations

import os
import pickle
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

JOBS = Path(__file__).resolve().parent / "_torch_rank_jobs.py"

#: Seconds a group of ranks may take, imports included.
TIMEOUT = 120


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    for p in procs:
        p.wait()


def run_groups(groups: dict, tmp_path, timeout: float = TIMEOUT) -> dict:
    """`groups` maps a world size to a list of jobs ``(name, kwargs)`` (names
    of functions in `_torch_rank_jobs`). Starts every group at once and
    returns {world: [per rank: [per job: result]]}."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    env.pop("LOCAL_RANK", None)
    procs, outs = {}, {}
    for world, jobs in groups.items():
        d = Path(tmp_path) / f"world{world}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "jobs.pkl").write_bytes(pickle.dumps(jobs))
        outs[world] = d
        procs[world] = [
            subprocess.Popen(
                [sys.executable, str(JOBS), str(rank), str(world), str(d / "store"), str(d / "jobs.pkl"), str(d)],
                env=env, stdout=subprocess.DEVNULL, stderr=open(d / f"err{rank}.txt", "w"),
                start_new_session=True,
            )
            for rank in range(world)
        ]
    every = [p for ps in procs.values() for p in ps]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in every):
            failed = [(w, r) for w, ps in procs.items() for r, p in enumerate(ps) if p.poll() not in (None, 0)]
            if failed:
                w, r = failed[0]
                _kill(every)
                pytest.fail(f"rank {r} of {w} failed:\n" + (outs[w] / f"err{r}.txt").read_text()[-4000:])
            if time.monotonic() > deadline:
                _kill(every)
                pytest.fail(f"ranks still running after {timeout} s; killed")
            time.sleep(0.05)
    finally:
        _kill(every)
    for w, ps in procs.items():
        for r, p in enumerate(ps):
            if p.returncode != 0:
                pytest.fail(f"rank {r} of {w} failed:\n" + (outs[w] / f"err{r}.txt").read_text()[-4000:])
    return {w: [pickle.loads((outs[w] / f"out{r}.pkl").read_bytes()) for r in range(w)] for w in groups}


def same_bits(results) -> bool:
    """Whether every rank returned the same bits (nested tuples, lists and
    dicts of arrays and scalars)."""
    import numpy as np

    def eq(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(eq(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(eq(x, y) for x, y in zip(a, b))
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()

    return all(eq(results[0], r) for r in results[1:])
