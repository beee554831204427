"""Tracing and timing (counterpart of `spateo_tpu.profiler`): wall timing of
named blocks, `torch.profiler` traces, named ranges, and a count of the
blocking device-to-host reads inside a block.

Usage:
    with stt.profiler.timer("morpho EM"):
        model.run()                      # logs "... took 1.23 s"

    with stt.profiler.trace("traces/run"):
        jacobi_block(f, upd, 100)        # Chrome trace JSON, CPU and CUDA activity

    with stt.profiler.trace("traces/run", create_perfetto_link=True):
        ...                              # also serves it to ui.perfetto.dev, as JAX does

    stt.profiler.report()                # table of accumulated timings

`timer(block=True)` waits for the card (`torch.cuda.synchronize()`) before it
stops the clock, where CUDA is initialised, so that queued kernels count.
`sync_audit` counts on `torch.Tensor` of any device, as the JAX version
counts on any `jax.Array`.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

from .logging import logger_manager as lm

_TIMINGS: Dict[str, List[float]] = defaultdict(list)


@contextlib.contextmanager
def timer(name: str, log: bool = True, block: bool = True) -> Iterator[None]:
    """Wall-time a code block; with `block=True` (default) the host waits
    for every queued kernel of the card before stopping the clock, so that
    asynchronous launches don't hide device time."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if block:
            import torch

            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        _TIMINGS[name].append(dt)
        if log:
            lm.main_info(f"{name} took {dt:.3f} s")


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False) -> Iterator[None]:
    """Capture a `torch.profiler` trace of the CPU and, where CUDA is
    available, the card into `log_dir`, as a Chrome trace JSON file (open in
    Perfetto or chrome://tracing). The card's queued work ends before the
    capture does.

    `create_perfetto_link=True` does what `jax.profiler` does with it: it
    also writes the trace gzipped as ``perfetto_trace.json.gz`` in
    `log_dir`, serves that directory from ``127.0.0.1:9001`` (the address
    ui.perfetto.dev fetches from), prints ``Open URL in browser: <link>``
    and blocks until the file has been fetched. On a remote machine, forward
    the port first (``ssh -L 9001:127.0.0.1:9001 host``), or fetch the file
    with ``curl -O http://127.0.0.1:9001/perfetto_trace.json.gz`` there.

    Late in a long process, and most after large profiler sessions,
    torch.profiler has lost some or all of a short trace's kernel records
    on an H100 machine (`scripts/profiler_window_probe.py`); where every
    kernel must show, trace in a fresh process."""
    import os

    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        if create_perfetto_link:
            _serve_perfetto_trace(_write_perfetto_trace(path))


#: the port `_serve_perfetto_trace` binds on 127.0.0.1, as `jax.profiler`'s;
#: 0 lets the system pick a free one (the link names the port bound)
_PERFETTO_PORT = 9001


def _perfetto_link(port: int, filename: str = "perfetto_trace.json.gz") -> str:
    """The line `jax.profiler` prints for a trace served on `port`."""
    return f"Open URL in browser: https://ui.perfetto.dev/#!/?url=http://127.0.0.1:{port}/{filename}"


def _write_perfetto_trace(path: str) -> str:
    """The Chrome trace at `path`, gzipped beside it as
    ``perfetto_trace.json.gz``; returns that file's path."""
    import gzip
    import os
    import shutil

    out = os.path.join(os.path.dirname(path), "perfetto_trace.json.gz")
    with open(path, "rb") as src, gzip.open(out, "wb") as dst:
        shutil.copyfileobj(src, dst)
    return out


def _serve_perfetto_trace(path: str) -> None:
    """Serve `path`'s directory from 127.0.0.1 on `_PERFETTO_PORT`, with
    ``Access-Control-Allow-Origin: *``, print the ui.perfetto.dev link to
    the port bound, and return once the file has been fetched
    (`jax.profiler`'s `_host_perfetto_trace_file`). The handler serves from
    the directory itself, so the working directory never changes."""
    import functools
    import http.server
    import os
    import socketserver

    directory, filename = os.path.split(os.path.abspath(path))

    class Handler(http.server.SimpleHTTPRequestHandler):
        def end_headers(self):
            self.send_header("Access-Control-Allow-Origin", "*")
            return super().end_headers()

        def do_GET(self):
            self.server.last_request = self.path
            return super().do_GET()

        def do_POST(self):
            self.send_error(404, "File not found")

    class Server(socketserver.TCPServer):
        allow_reuse_address = True

    with Server(("127.0.0.1", _PERFETTO_PORT), functools.partial(Handler, directory=directory)) as httpd:
        print(_perfetto_link(httpd.server_address[1], filename), flush=True)
        while getattr(httpd, "last_request", None) != "/" + filename:
            httpd.handle_request()


def annotate(name: str):
    """Decorator: wrap a function in both a named `torch.profiler` range
    (visible inside traces) and the wall timer."""
    import functools

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            import torch

            with torch.profiler.record_function(name), timer(name, log=False):
                return fn(*args, **kwargs)

        return wrapped

    return deco


def timings() -> Dict[str, List[float]]:
    """Raw accumulated timings (name -> list of seconds)."""
    return dict(_TIMINGS)


def reset() -> None:
    _TIMINGS.clear()


def report() -> List[Tuple[str, int, float, float]]:
    """(name, calls, total_s, mean_s) rows, logged and returned."""
    rows = []
    for name, ts in sorted(_TIMINGS.items(), key=lambda kv: -sum(kv[1])):
        rows.append((name, len(ts), sum(ts), sum(ts) / len(ts)))
        lm.main_info(f"{name}: {len(ts)} calls, total {sum(ts):.3f} s, mean {sum(ts)/len(ts):.3f} s")
    return rows


#: the `torch.Tensor` methods `sync_audit` counts, with the key each counts under
_AUDITED = (
    ("__array__", "array"),
    ("numpy", "array"),
    ("__float__", "float"),
    ("__int__", "int"),
    ("__index__", "int"),
    ("__bool__", "bool"),
    ("item", "device_get"),
    ("tolist", "device_get"),
    ("cpu", "device_get"),
    ("to", "device_get"),  # from a device to the CPU only
)


def _to_host(t, args, kwargs) -> bool:
    """Whether `t.to(...)` copies `t` from a device to the CPU."""
    import torch

    if t.device.type == "cpu":
        return False
    target = kwargs.get("device")
    if target is None and args:
        target = args[0]
    if isinstance(target, torch.Tensor):
        target = target.device
    if isinstance(target, (str, torch.device)):
        return torch.device(target).type == "cpu"
    return False


@contextlib.contextmanager
def sync_audit(log: bool = True, capture_stacks: bool = False) -> Iterator[dict]:
    """Count blocking device->host materializations inside a block.

    Each pull of a tensor's values to the host (``np.asarray(t)``,
    ``float(t)``, ``if t:``, ``t.item()``) makes the host wait for the card,
    and *sequential* pulls dominate a pipeline's fixed cost. This context
    manager wraps `torch.Tensor`'s ``__array__`` and ``numpy`` (counted as
    "array"), ``__float__`` ("float"), ``__int__`` and ``__index__``
    ("int"), ``__bool__`` ("bool"), and ``item``, ``tolist`` and ``cpu``
    ("device_get"), on tensors of any device, and ``to`` where it copies a
    tensor from a device to the CPU ("device_get"; ``.to(device)`` with
    ``device="cpu"`` of a tensor already there is how a CPU run uploads, and
    does not count, so that a run on the CPU counts what the same run on the
    card counts):

        with stt.profiler.sync_audit() as audit:
            model.run()
        audit  # {"array": 3, "float": 1, "device_get": 1, "stacks": [...]}

    A pull made inside another (``np.asarray`` calls ``numpy``) counts once.
    Every wrapped method is restored when the block ends, also by an
    exception. ``capture_stacks=True`` additionally records a short
    traceback per event so the offending line can be found. Only use for
    diagnosis (the wrapper adds per-call overhead)."""
    import traceback

    import torch

    counts = {"array": 0, "float": 0, "int": 0, "bool": 0, "device_get": 0, "stacks": []}
    cls = torch.Tensor
    own = {}  # name -> the class's own attribute, or None where it was inherited
    # the outermost pull counts; pulls it makes itself do not
    in_get = [False]

    def _wrap(name, key):
        orig = getattr(cls, name)

        def wrapped(self, *a, **k):
            if in_get[0] or (name == "to" and not _to_host(self, a, k)):
                return orig(self, *a, **k)
            counts[key] += 1
            if capture_stacks:
                counts["stacks"].append((key, "".join(traceback.format_stack(limit=8)[:-1])))
            in_get[0] = True
            try:
                return orig(self, *a, **k)
            finally:
                in_get[0] = False

        own[name] = cls.__dict__.get(name)
        setattr(cls, name, wrapped)

    try:
        for name, key in _AUDITED:
            _wrap(name, key)
        yield counts
    finally:
        for name, orig in own.items():
            if orig is None:
                delattr(cls, name)
            else:
                setattr(cls, name, orig)
        if log:
            total = sum(v for k, v in counts.items() if k != "stacks")
            lm.main_info(
                f"sync_audit: {total} blocking materializations "
                f"(array={counts['array']} float={counts['float']} int={counts['int']} "
                f"bool={counts['bool']} device_get={counts['device_get']})"
            )
