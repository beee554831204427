"""The port's package root (ROADMAP item 16: `configuration`'s
`SpateoConfig`, `config` and figure settings, `profiler`, `colormaps`,
`utils`, `warnings`, `_lazy_loader`, `get_version`, the names the root
binds) against the JAX package on the CPU.

Bars: `sync_audit` gives the JAX version's counts on the same toy (each pull
counted once, nested pulls not); the wrapped `torch.Tensor` methods are
the originals again after the block, also after an exception; `timer`,
`timings`, `report`, `reset` and `annotate` record as the JAX version
records; `trace` writes a Chrome trace JSON; every figure-settings function
leaves `matplotlib.rcParams` equal to what the JAX function leaves; the
colormaps' colours, the palettes and `get_version` equal the JAX package's.
"""

import json
import logging

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import spateo_tpu as st  # noqa: E402
import spateo_tpu_torch as stt  # noqa: E402
from spateo_tpu import colormaps as JC  # noqa: E402
from spateo_tpu import configuration as JCfg  # noqa: E402
from spateo_tpu import profiler as JProf  # noqa: E402
from spateo_tpu_torch import colormaps as TC  # noqa: E402
from spateo_tpu_torch import configuration as TCfg  # noqa: E402
from spateo_tpu_torch import profiler as TProf  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch, and for numpy's BLAS and OpenMP."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


# -- sync_audit -------------------------------------------------------------------------------------------------


def _toy(audit, zeros, pull, host_view):
    """np.asarray twice, float, int, bool and one explicit pull, of a [3]
    vector and a scalar."""
    with audit(log=False) as counts:
        v, s = zeros((3,)), zeros(())
        np.asarray(host_view(v))
        np.asarray(host_view(v + 1))
        float(s)
        int(s)
        bool(s)
        pull(v)
    return {k: v for k, v in counts.items() if k != "stacks"}


def test_sync_audit_counts_as_jax_does():
    """The JAX version counts through `jax.Array.__array__`; numpy reads a
    float32 `jax.Array` on the CPU through the buffer protocol, around that
    method, so the JAX toy converts its vectors as bfloat16, which numpy
    reads through `__array__`, as it reads any array on an accelerator."""
    import jax
    import jax.numpy as jnp

    a = _toy(JProf.sync_audit, jnp.zeros, lambda x: jax.device_get(x), lambda x: x.astype(jnp.bfloat16))
    b = _toy(TProf.sync_audit, torch.zeros, lambda t: t.cpu(), lambda t: t)
    assert a == b == {"array": 2, "float": 1, "int": 1, "bool": 1, "device_get": 1}


@pytest.mark.parametrize("pull", ["item", "tolist", "cpu", "to_cpu", "numpy", "index"])
def test_sync_audit_counts_each_pull_once(pull):
    """Each kind of pull counts once under its key; `np.asarray` (which
    calls `numpy` itself) counts once; `to` a dtype, or to the CPU from a
    tensor already there, does not count."""
    t = torch.arange(4.0)
    do, key = {
        "item": (lambda: t[1].item(), "device_get"),
        "tolist": (lambda: t.tolist(), "device_get"),
        "cpu": (lambda: t.cpu(), "device_get"),
        "to_cpu": (lambda: _to_cpu_from_a_device(t), "device_get"),
        "numpy": (lambda: (t.numpy(), np.asarray(t)), "array"),
        "index": (lambda: [10, 11, 12][torch.tensor(1)], "int"),
    }[pull]
    with TProf.sync_audit(log=False, capture_stacks=True) as c:
        do()
    n = 2 if pull == "numpy" else 1
    assert c[key] == n and sum(v for k, v in c.items() if k not in ("stacks", key)) == 0
    assert len(c["stacks"]) == n and all(k == key for k, _ in c["stacks"])


def _to_cpu_from_a_device(t):
    """`to` the CPU from a tensor there, or to a dtype, does not count; from
    another device it does (a meta tensor, which cannot be copied, stands
    for the card here)."""
    t.to("cpu"), t.to(device=torch.device("cpu")), t.to(torch.float64), t.to(t)
    with pytest.raises(NotImplementedError):
        torch.zeros(3, device="meta").to("cpu")


def test_sync_audit_restores_every_method_after_an_exception():
    before = {name: torch.Tensor.__dict__.get(name) for name, _ in TProf._AUDITED}
    with pytest.raises(ZeroDivisionError):
        with TProf.sync_audit(log=False) as c:
            float(torch.ones(()))
            1 / 0
    assert c["float"] == 1
    assert {name: torch.Tensor.__dict__.get(name) for name, _ in TProf._AUDITED} == before
    t = torch.ones(())
    with TProf.sync_audit(log=False) as c2:
        pass
    float(t), t.item(), np.asarray(t)
    assert c2["float"] == c2["device_get"] == c2["array"] == 0


def test_sync_audit_counts_jacobi_solves_documented_reads():
    """`ops.stencil.jacobi_solve` reads `err` once a block of `check_every`
    sweeps and copies the result back once."""
    from spateo_tpu_torch.ops.stencil import jacobi_solve

    n = 40
    f = np.zeros((n, n), np.float32)
    border = np.zeros((n, n), np.float32)
    f[0], border[0] = 100.0, 1
    mask = np.ones((n, n), np.float32)
    with TProf.sync_audit(log=False) as c:
        out, it, err = jacobi_solve(f, border, mask, max_err=1e-4, max_itr=5000, check_every=50, device="cpu")
    assert it % 50 == 0 and it > 50
    assert {k: v for k, v in c.items() if k != "stacks"} == {
        "array": 1, "float": it // 50, "int": 0, "bool": 0, "device_get": 0}


# -- timer, trace, annotate -----------------------------------------------------------------------------------


def test_timer_report_reset_annotate_match_jax():
    rows = {}
    for prof in (JProf, TProf):
        prof.reset()
        with prof.timer("a", log=False):
            pass
        with prof.timer("a", log=False, block=False):
            pass

        @prof.annotate("f")
        def f(x):
            """doc"""
            return x + 1

        assert f(1) == 2 and f.__name__ == "f" and f.__doc__ == "doc"
        t = prof.timings()
        assert sorted(t) == ["a", "f"] and len(t["a"]) == 2 and len(t["f"]) == 1
        rows[prof] = [(r[0], r[1]) for r in prof.report()]
        prof.reset()
        assert prof.timings() == {}
    assert sorted(rows[TProf]) == sorted(rows[JProf]) == [("a", 2), ("f", 1)]


def test_timer_logs_and_records_an_exception_block():
    TProf.reset()
    with pytest.raises(ValueError):
        with TProf.timer("boom"):
            raise ValueError("x")
    assert len(TProf.timings()["boom"]) == 1
    TProf.reset()


def test_trace_writes_a_chrome_trace(tmp_path):
    @TProf.annotate("my_range")
    def work():
        return (torch.ones(64, 64) @ torch.ones(64, 64)).sum()

    with TProf.trace(str(tmp_path / "tr")):
        work()
    files = list((tmp_path / "tr").glob("*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "my_range" in names and any("mm" in str(n) for n in names)


#: `trace(create_perfetto_link=True)` in a process of its own: it blocks
#: until the served file is fetched, and the repo has no pytest-timeout. It
#: serves on a port the system picks, so that two runs on one machine, or
#: anything else holding 9001, do not meet
PERFETTO_CHILD = """
import json, os, sys
import torch
import spateo_tpu_torch.profiler as profiler  # the module itself: the package binds a lazy proxy

profiler._PERFETTO_PORT = 0
cwd = os.getcwd()
with profiler.trace(sys.argv[1], create_perfetto_link=True):
    with torch.profiler.record_function("my_range"):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
print(json.dumps({"cwd_kept": os.getcwd() == cwd, "files": sorted(os.listdir(sys.argv[1]))}), flush=True)
"""


def test_perfetto_link_is_jaxs():
    """By default the trace is served on JAX's port 9001, and the printed
    line is the one `jax.profiler` prints."""
    import inspect

    from jax._src import profiler as jax_profiler

    src = inspect.getsource(jax_profiler._host_perfetto_trace_file)
    assert "port = 9001" in src and 'print(f"Open URL in browser: {url}")' in src
    assert 'url = f"https://ui.perfetto.dev/#!/?url=http://127.0.0.1:{port}/{filename}"' in src
    assert TProf._PERFETTO_PORT == 9001
    assert TProf._perfetto_link(9001) == (
        "Open URL in browser: https://ui.perfetto.dev/#!/?url=http://127.0.0.1:9001/perfetto_trace.json.gz")


def test_trace_serves_a_perfetto_link_as_jax_does(tmp_path):
    """`trace(create_perfetto_link=True)` writes the Chrome trace and
    ``perfetto_trace.json.gz`` beside it, prints JAX's ``Open URL in
    browser: https://ui.perfetto.dev/#!/?url=http://127.0.0.1:<port>/...``
    line for the port it bound, serves the file from 127.0.0.1 with
    ``Access-Control-Allow-Origin: *``, returns once it has been fetched,
    and leaves the working directory as it was. The parent fetches the
    printed URL and reads the events."""
    import gzip
    import os
    import pathlib
    import queue
    import subprocess
    import sys
    import threading
    import urllib.parse
    import urllib.request

    log_dir = tmp_path / "tr"
    root = str(pathlib.Path(__file__).resolve().parents[1])
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([root, os.environ.get("PYTHONPATH", "")])}
    child = subprocess.Popen([sys.executable, "-c", PERFETTO_CHILD, str(log_dir)], cwd=str(tmp_path), env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in child.stdout] + [lines.put("")], daemon=True).start()
    try:
        line = lines.get(timeout=60)
        if not line:
            child.wait(timeout=60)
            pytest.fail(f"the tracing process printed no link: {child.stderr.read()[-3000:]}")
        prefix = "Open URL in browser: https://ui.perfetto.dev/#!/?url="
        assert line.startswith(prefix), line
        url = line[len(prefix):].strip()
        parts = urllib.parse.urlsplit(url)
        assert (parts.scheme, parts.hostname, parts.path) == ("http", "127.0.0.1", "/perfetto_trace.json.gz")
        assert parts.port not in (None, 9001) and line.strip() == TProf._perfetto_link(parts.port)
        with urllib.request.urlopen(url, timeout=60) as resp:
            assert resp.headers["Access-Control-Allow-Origin"] == "*"
            body = resp.read()
        _, err = child.communicate(timeout=60)
        assert child.returncode == 0, err
        done = json.loads(lines.get(timeout=10))
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert done["cwd_kept"] and "perfetto_trace.json.gz" in done["files"] and len(done["files"]) == 2
    assert body == (log_dir / "perfetto_trace.json.gz").read_bytes()
    (chrome,) = [f for f in done["files"] if f.endswith(".json")]
    events = json.loads(gzip.decompress(body))["traceEvents"]
    assert events == json.loads((log_dir / chrome).read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "my_range" in names and any("mm" in str(n) for n in names)


# -- configuration ---------------------------------------------------------------------------------------------


def jax_device_count():
    import jax

    return jax.device_count()


def test_config_matches_jax_where_it_can_and_refuses_where_it_cannot():
    cfg = TCfg.SpateoConfig(n_threads=2, mesh_shape=(2, 1), precision="bfloat16")
    assert cfg.mesh_shape == (2, 1) and cfg.mesh_axis_names == ("data", "model") and cfg.n_threads == 2
    cfg.mesh_shape, cfg.mesh_axis_names = [4], ["d"]
    assert cfg.mesh_shape == (4,) and cfg.mesh_axis_names == ("d",)
    assert cfg.dtype is torch.bfloat16 and cfg.enable_x64 is False
    for p, dt in (("float32", torch.float32), ("float64", torch.float64)):
        cfg.precision = p
        assert cfg.dtype is dt
    cfg.logging_level = "warning"
    assert cfg.logging_level == logging.WARNING
    cfg.logging_level = logging.INFO
    # config.mesh: a shape that does not cover the devices raises in both
    # packages (here one rank, no process group yet); the default mesh puts
    # every device on 'data' (JAX: all 8 CPU devices; here a one-rank mesh,
    # whose group is started for it)
    cfg.mesh_device = "cpu"
    with pytest.raises(stt.MeshError, match="does not cover 1 devices"):
        cfg.mesh
    jcfg = JCfg.SpateoConfig(mesh_shape=(4 * jax_device_count(),))
    with pytest.raises(st.MeshError, match="does not cover"):
        jcfg.mesh
    cfg.mesh_shape, cfg.mesh_axis_names = None, ("data", "model")
    jcfg.mesh_shape = None
    try:
        m = cfg.mesh
        assert m is cfg.mesh and m.device_type == "cpu" and m.mesh_dim_names == ("data", "model")
        assert tuple(m.shape) == (1, 1) and tuple(jcfg.mesh.shape.values()) == (jax_device_count(), 1)
    finally:
        torch.distributed.destroy_process_group()
    with pytest.raises(stt.ConfigurationError, match="x64"):
        cfg.enable_x64 = True
    with pytest.raises(stt.ConfigurationError):
        TCfg.SpateoConfig(enable_x64=True)
    cfg.enable_x64 = False
    assert stt.config is TCfg.config and isinstance(stt.config, TCfg.SpateoConfig)
    assert TCfg.EPS == JCfg.EPS and TCfg.MAX == JCfg.MAX
    assert (TCfg.SKM.SELECTION_SUFFIX, TCfg.SKM.UNS_SPATIAL_SEGMENTATION_KEY) == (
        JCfg.SKM.SELECTION_SUFFIX, JCfg.SKM.UNS_SPATIAL_SEGMENTATION_KEY)


def _rc_after(fn, *args, **kwargs):
    import matplotlib as mpl

    with mpl.rc_context():
        mpl.rcParams.update(mpl.rcParamsDefault)
        out = fn(*args, **kwargs)
        return dict(mpl.rcParams), out


@pytest.mark.parametrize("name,args,kwargs", [
    ("config_spateo_rcParams", (), {}),
    ("config_spateo_rcParams", ("black",), {"prop_cycle": ["#000000", "#ff0000"], "fontsize": 6,
                                            "color_map": "magma", "frameon": False}),
    ("set_figure_params", (), {}),
    ("set_figure_params", (), {"spateo": False, "dpi": 120, "dpi_save": 200, "frameon": False,
                               "color_map": "viridis", "format": "png", "transparent": True, "figsize": (3, 2)}),
    ("reset_rcParams", (), {}),
    ("spateo_theme", (), {}),
    ("spateo_theme", ("black",), {}),
    ("set_pub_style_mpltex", (), {}),
    ("set_pub_style", (), {}),
    ("set_pub_style", (), {"scaler": 2.0}),
])
def test_figure_settings_leave_rcparams_as_jax_does(name, args, kwargs):
    a, _ = _rc_after(getattr(JCfg, name), *args, **kwargs)
    b, _ = _rc_after(getattr(TCfg, name), *args, **kwargs)
    assert {k: str(v) for k, v in a.items()} == {k: str(v) for k, v in b.items()}


def test_shifted_colormap_matches_jax():
    import matplotlib as mpl

    x = np.linspace(0, 1, 33)
    for kw in ({}, {"midpoint": 0.3, "start": 0.1, "stop": 0.9}):
        _, cj = _rc_after(JCfg.shiftedColorMap, mpl.colormaps["viridis"], name="shift_j", **kw)
        _, ct = _rc_after(TCfg.shiftedColorMap, mpl.colormaps["viridis"], name="shift_t", **kw)
        assert np.array_equal(cj(x), ct(x))


# -- colormaps, utils, warnings, the lazy loader, the version ----------------------------------------------------


def test_colormaps_match_jax():
    x = np.linspace(0, 1, 64)
    names = ["fire_cmap", "darkblue_cmap", "darkgreen_cmap", "darkred_cmap", "darkpurple_cmap",
             "div_blue_black_red_cmap", "div_blue_red_cmap", "glasbey_white_cmap", "glasbey_dark_cmap"]
    for name in names:
        cj, ct = getattr(JC, name), getattr(TC, name)
        assert cj.name == ct.name and np.array_equal(cj(x), ct(x)), name
        assert getattr(TCfg, name) is ct
    for name in ("zebrafish_colors", "zebrafish_256", "cyc_10", "cyc_20"):
        assert getattr(TC, name) == getattr(JC, name) == getattr(TCfg, name), name
    assert TC.glasbey_palette(40, min_lightness=20.0, grid=12) == JC.glasbey_palette(40, min_lightness=20.0, grid=12)
    assert sorted(TC.__all__) == sorted(JC.__all__)
    with pytest.raises(AttributeError):
        TC.nope_cmap


def test_utils_warnings_and_lazy_loader_match_jax():
    from spateo_tpu import utils as JU
    from spateo_tpu import warnings as JW
    from spateo_tpu_torch import _lazy_loader as LL
    from spateo_tpu_torch import utils as TU
    from spateo_tpu_torch import warnings as TW

    d = {"a": 1, "b": 2, "c": 3}
    assert TU.remove_kwargs(dict(d), ["a", "z", "c"]) == JU.remove_kwargs(dict(d), ["a", "z", "c"]) == [
        ("a", 1), ("c", 3)]
    a = stt.AnnData(X=np.ones((3, 2), np.float32))
    b = TU.copy_adata(a)
    assert b is not a and np.array_equal(b.X, a.X)
    for name in ("PreprocessingWarning", "IOWarning", "PlottingWarning", "SegmentationWarning"):
        assert issubclass(getattr(TW, name), UserWarning) and getattr(TW, name).__name__ == getattr(JW, name).__name__
    g = {}
    lazy = LL.LazyLoader("m", g, "spateo_tpu_torch.utils")
    assert lazy.copy_adata is TU.copy_adata and g["m"] is TU and "remove_kwargs" in dir(lazy)
    attr = LL.create_lazy_attribute("spateo_tpu_torch.utils.remove_kwargs")
    assert attr({"q": 1}, ["q"]) == [("q", 1)] and attr.__name__ == "remove_kwargs"
    assert LL.create_lazy_module("spateo_tpu_torch.warnings", {}).IOWarning is TW.IOWarning
    assert stt.LazyLoader is LL.LazyLoader and stt.LazyAttribute is LL.LazyAttribute


def test_root_binds_the_names_and_lazy_modules():
    from spateo_tpu_torch import errors as TE

    assert stt.profiler.sync_audit is TProf.sync_audit
    assert stt.ops.stencil.jacobi_solve.__module__ == "spateo_tpu_torch.ops.stencil"
    for name in ("AlignmentError", "DigitizationError", "MeshError", "PreprocessingError"):
        assert getattr(stt, name) is getattr(TE, name) and issubclass(getattr(stt, name), stt.SpateoError)
        assert getattr(stt, name).__name__ == getattr(st, name).__name__


def test_get_version_matches_jax():
    import importlib

    JV = importlib.import_module("spateo_tpu.get_version")
    TV = importlib.import_module("spateo_tpu_torch.get_version")

    assert stt.__version__ == st.__version__
    assert stt.get_version(stt.__file__) == st.get_version(st.__file__)
    for v in ("1.2.3", "1.2.3.dev4+abc.def", "0.1"):
        assert str(TV.Version.parse(v)) == str(JV.Version.parse(v))
    assert TV.match_groups(TV.RE_GIT_DESCRIBE, "v1.2.3-5-gabcdef1") == JV.match_groups(JV.RE_GIT_DESCRIBE,
                                                                                     "v1.2.3-5-gabcdef1")
    df = TV.get_all_dependencies_version(display=False)
    assert df.loc["version", "torch"] == torch.__version__ and "jax" not in df.columns
    assert df.loc["version", "spateo-tpu-torch"] == stt.__version__
