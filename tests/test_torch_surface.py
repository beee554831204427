"""Public names that ported modules took from the JAX package late: point
cloud sampling (`alignment.methods.sample` and its helpers),
`segmentation.moran.binary_morani_result`, the logging helpers and the
logging classes' methods, the `core` device helpers and `core.to_device`,
and PCA's randomized and ARPACK solvers, each against the JAX package (or,
for PCA, the scikit-learn it calls) on the CPU; and the diff between every
ported module and its JAX counterpart: top-level public names, every public
class's public attributes, and every public function's and method's
parameters and defaults.

Bars:

- Sampling: the same indices and points, bit for bit (the k-means path is
  `ops.kmeans.MiniBatchKMeans`, held against scikit-learn's in
  `test_torch_kmeans.py`).
- `binary_morani_result`: pixels that differ, counted; 0 on these rasters.
- The bridge helpers: equal to the JAX arrays (sums of whole numbers below
  2^24 are exact in any order).
- PCA's randomized and ARPACK solvers: components, projections and
  variances within `PCA_TOL` = 1e-10 of scale of scikit-learn 1.9's
  (measured at most 5e-13).
"""

import ast
import importlib
import inspect
import logging
import pathlib
import re

import numpy as np
import pandas as pd
import pytest
import torch
from scipy import sparse

import spateo_tpu as st
import spateo_tpu_torch as stt
from bench import make_raster
from spateo_tpu import logging as JLg
from spateo_tpu.alignment.methods import sampling as JS
from spateo_tpu.core import bridge as JB
from spateo_tpu.segmentation import moran as JM
from spateo_tpu_torch import logging as TLg
from spateo_tpu_torch.alignment.methods import sampling as TS
from spateo_tpu_torch.core import bridge as TB
from spateo_tpu_torch.core.bridge import adata_from_reference
from spateo_tpu_torch.segmentation import moran as TM
from spateo_tpu_torch.tools.dimensionality_reduction import PCA, pca_fit

PCA_TOL = 1e-10
ROOT = pathlib.Path(__file__).resolve().parents[1]
#: Public names of JAX modules that the port's counterpart lacks on purpose,
#: each with where it stands; renamed counterparts map to their new name.
LEFT_OUT = {
    # the port returns plain dicts filled by one batched copy
    "ops/vfc.py": {"LazyHostDict"},
}
RENAMED = {"ops/vfc.py": {"vector_field_function_jax": "vector_field_function_torch"}}
#: Names that a JAX package's ``__init__.py`` binds and its port's does not,
#: each with where it stands.
LEFT_OUT_EXPORTS = {}
#: The settled kinds of signature difference, each with the phrase of
#: ROADMAP.md ("Settled divergences", **Signatures**) that settles it.
SIGNATURE_RULES = {
    "device": '`device` defaults to `"cuda"`',
    "dtype": "a dtype default is torch's dtype of the same name",
    "random": "a JAX random key is the port's random source",
    "gate": "`estep_reduced` drops `use_pallas`",
    "staticmethod": "`simple_GC_DEC.loss_function` is a staticmethod",
}
#: Every public function or method whose parameters differ from its JAX
#: counterpart's other than by added keyword parameters with defaults, with
#: its rule: "random" names the JAX parameter and the port's in its place,
#: "gate" and "staticmethod" the JAX parameters the port drops.
SETTLED_SIGNATURES = {
    **{f"{rel}::{name}": ("device",) for rel, names in {
        "alignment/deformation.py": ["grid_deformation"],
        "alignment/methods/__init__.py": ["empty_cache"],
        "alignment/methods/deprecated_morpho.py": ["BA_align"],
        "alignment/methods/morpho.py": ["Morpho_pairwise.__init__"],
        "alignment/methods/paste.py": ["paste_pairwise_align", "paste_center_align"],
        "alignment/morpho_alignment.py": ["morpho_align", "morpho_align_ref", "morpho_align_transformation"],
        "alignment/paste_alignment.py": ["paste_align", "paste_align_ref"],
        "alignment/transform.py": ["BA_transform", "BA_transform_and_assignment"],
        "svg/get_svg.py": ["smoothing_and_sampling"],
        "tdr/interpolations/interpolation_gaussianprocess/gp_train.py": ["gp_train"],
        "tdr/interpolations/interpolation_gp.py": ["gp_interpolation"],
        "tdr/morphometrics/morphofield/sparsevfc.py": ["cell_directions"],
        "tools/cluster/_stagate.py": ["pySTAGATE.__init__"],
    }.items() for name in names},
    **{f"core/bridge.py::{name}": ("dtype",) for name in ("csr_to_dense_device", "layer_to_device",
                                                          "points_to_raster")},
    **{f"external/cast.py::{name}": ("random", "key", "generator") for name in ("drop_feature", "mask_edge",
                                                                                 "random_aug")},
    **{f"external/cast_model.py::{name}.__init__": ("random", "key", "seed") for name in ("Encoder", "GCNII", "GCN",
                                                                                           "CCA_SSG")},
    **{f"external/merfishvi_modules.py::{name}": ("random", "key", "rng") for name in (
        "VAE.inference", "VAE.loss", "LDVAE.inference", "LDVAE.loss", "SpatialVAE.inference", "SpatialVAE.loss",
        "MultiModalSpatialVAE.inference", "MultiModalSpatialVAE.inference_nonspatial",
        "MultiModalSpatialVAE.inference_spatial", "MultiModalSpatialVAE.loss")},
    "external/merfishvi_modules.py::SpatialEncoder.init_params": ("random", "rng", "gen"),
    "alignment/methods/math.py::estep_reduced": ("gate", "use_pallas"),
    "tools/cluster/spagcn_utils.py::simple_GC_DEC.loss_function": ("staticmethod", "self"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch, and for numpy's BLAS and OpenMP: the
    tier-1 run shares the CPU among its workers, where those pools only
    contend."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _scaled(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# -- the public-name diff ----------------------------------------------------------------------------


def _public_names(path):
    tree = ast.parse(path.read_text())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and not n.name.startswith("_")}


def _ported_modules():
    jax_root, port_root = ROOT / "spateo_tpu", ROOT / "spateo_tpu_torch"
    return [p.relative_to(jax_root).as_posix() for p in sorted(jax_root.rglob("*.py"))
            if (port_root / p.relative_to(jax_root)).exists()]


def test_every_ported_module_has_its_counterparts_public_names():
    """For every module of the port with a JAX counterpart, the JAX module's
    top-level public functions and classes less the port's are exactly the
    `LEFT_OUT` set (renames applied)."""
    modules = _ported_modules()
    assert len(modules) > 150
    for rel in modules:
        jax_names = _public_names(ROOT / "spateo_tpu" / rel)
        port_names = _public_names(ROOT / "spateo_tpu_torch" / rel)
        renamed = RENAMED.get(rel, {})
        assert set(renamed.values()) <= port_names, rel
        missing = {renamed.get(n, n) for n in jax_names} - port_names
        assert missing == LEFT_OUT.get(rel, set()), (rel, sorted(missing))


def _exported_names(path):
    """The public names a package's ``__init__.py`` binds by its imports and
    assignments (not submodules that other imports attach later, and not
    names taken from `typing` or `__future__`)."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.module in ("typing", "__future__"):
            continue
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


def test_every_ported_package_exports_its_counterparts_names():
    """For every package of the port with a JAX counterpart, the names the
    JAX package's ``__init__.py`` binds less the port's are exactly the
    `LEFT_OUT_EXPORTS` set."""
    packages = [rel for rel in _ported_modules() if rel.endswith("__init__.py")]
    assert len(packages) > 25
    for rel in packages:
        missing = _exported_names(ROOT / "spateo_tpu" / rel) - _exported_names(ROOT / "spateo_tpu_torch" / rel)
        assert missing == LEFT_OUT_EXPORTS.get(rel, set()), (rel, sorted(missing))


def _module(package, rel):
    name = rel[: -len("/__init__.py")] if rel.endswith("/__init__.py") else rel[: -len(".py")]
    return importlib.import_module(f"{package}.{name.replace('/', '.')}")


def _same_default(a, b):
    if a is b:
        return True
    if inspect.isfunction(a) and inspect.isfunction(b):  # two lambdas, say
        return a.__code__.co_code == b.__code__.co_code and a.__code__.co_consts == b.__code__.co_consts
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    try:
        return type(a) is type(b) and bool(a == b)
    except (TypeError, ValueError):
        return False


def _expected_parameters(params, rule):
    """The JAX parameters as the port must take them under `rule`: [(name,
    kind, default or `inspect.Parameter.empty`, whether to compare the
    default)]."""
    kind = rule[0] if rule else None
    out = []
    for p in params:
        if kind in ("gate", "staticmethod") and p.name in rule[1:]:
            continue
        name, default, compare = p.name, p.default, True
        if kind == "device" and name == "device":
            default = "cuda"
        elif kind == "dtype" and name == "dtype":
            default = getattr(torch, np.dtype(p.default).name)
        elif kind == "random" and name == rule[1]:
            name, compare = rule[2], False
        out.append((name, p.kind, default, compare))
    return out


def _signature_problems(jax_fn, port_fn, rule):
    """Why `port_fn` does not take `jax_fn`'s parameters (under `rule`): in
    their order, of their kind, with their defaults; parameters the port
    adds have defaults and follow every JAX parameter that binds by
    position. An empty list where it does."""
    jp = list(inspect.signature(jax_fn).parameters.values())
    tp = list(inspect.signature(port_fn).parameters.values())
    want = _expected_parameters(jp, rule)
    names = [w[0] for w in want]
    by_name = {p.name: p for p in tp}
    problems = []
    if [p.name for p in tp if p.name in names] != names:
        problems.append(f"parameters {[p.name for p in tp]}, expected {names} in this order")
    for name, kind, default, compare in want:
        q = by_name.get(name)
        if q is not None and (q.kind != kind or compare and not _same_default(default, q.default)):
            problems.append(f"{name}: {q.kind.name} = {q.default!r}, expected {kind.name} = {default!r}")
    positional = (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)
    last = max((i for i, p in enumerate(tp) if p.name in names and p.kind in positional), default=-1)
    for i, q in enumerate(tp):
        if q.name in names or q.kind in (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD):
            continue
        if q.default is inspect.Parameter.empty or (q.kind in positional and i < last):
            problems.append(f"added parameter {q.name} has no default or comes before a JAX positional one")
    return problems


def _own_attributes(cls):
    """Public attributes a JAX class defines in its own module tree (not
    those of flax, equinox or `object`)."""
    own = [c for c in cls.__mro__ if c.__module__.startswith("spateo_tpu.")]
    return sorted({k for c in own for k in vars(c) if not k.startswith("_")}), own


def _surface_diff():
    """{"missing": [...], "signatures": {key: problems}} over every ported
    module's public functions, and every public class's public attributes,
    methods and ``__init__``; keys are ``"rel::name"``."""
    missing, signatures, checked = [], {}, 0

    def compare(key, a, b):
        nonlocal checked
        checked += 1
        problems = _signature_problems(a, b, SETTLED_SIGNATURES.get(key))
        if problems or key in SETTLED_SIGNATURES:
            signatures[key] = problems

    for rel in _ported_modules():
        J, T = _module("spateo_tpu", rel), _module("spateo_tpu_torch", rel)
        for name in sorted(_public_names(ROOT / "spateo_tpu" / rel) - LEFT_OUT.get(rel, set())):
            a, b = getattr(J, name), getattr(T, RENAMED.get(rel, {}).get(name, name))
            if not inspect.isclass(a):
                compare(f"{rel}::{name}", a, b)
                continue
            attrs, own = _own_attributes(a)
            missing += [f"{rel}::{name}.{k}" for k in attrs if not hasattr(b, k)]
            for k in attrs:
                if hasattr(b, k) and inspect.isroutine(getattr(a, k)):
                    compare(f"{rel}::{name}.{k}", getattr(a, k), getattr(b, k))
            if any("__init__" in vars(c) for c in own):
                compare(f"{rel}::{name}.__init__", a.__init__, b.__init__)
    return missing, signatures, checked


@pytest.fixture(scope="module")
def surface_diff():
    return _surface_diff()


def test_every_public_class_has_its_counterparts_attributes(surface_diff):
    """`hasattr` on the port's class for every public attribute a JAX class
    defines: methods, properties and class attributes (several of which are
    None, so no `getattr(..., None)`)."""
    missing, _, _ = surface_diff
    assert missing == []


def test_every_public_signature_matches_or_is_settled(surface_diff):
    """Every public function's and method's parameters (names in order,
    kinds, defaults) equal the JAX counterpart's, but for keyword
    parameters with defaults that the port adds; the only other differences
    are `SETTLED_SIGNATURES`, each explained by its rule, and every entry of
    that table is still needed."""
    _, signatures, checked = surface_diff
    assert checked > 900
    assert {k: v for k, v in signatures.items() if v} == {}
    assert set(signatures) == set(SETTLED_SIGNATURES)
    for key in SETTLED_SIGNATURES:  # each entry differs from JAX's without its rule
        rel, name = key.split("::")
        a, b = _module("spateo_tpu", rel), _module("spateo_tpu_torch", rel)
        for part in name.split("."):
            a, b = getattr(a, part), getattr(b, part)
        assert _signature_problems(a, b, None), key


@pytest.mark.parametrize("rule", sorted(SIGNATURE_RULES))
def test_each_settled_signature_rule_is_recorded_in_the_roadmap(rule):
    assert SIGNATURE_RULES[rule] in (ROOT / "ROADMAP.md").read_text()
    assert any(v[0] == rule for v in SETTLED_SIGNATURES.values())


# -- sampling ----------------------------------------------------------------------------------------


def _cloud(n=500, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 10, (n, 2)), rng.normal(size=(n, 2))


@pytest.mark.parametrize("method", ["random", "velocity", "trn", "kmeans", "lhs", "LHS"])
@pytest.mark.parametrize("aux", [False, True])
def test_sample_matches_jax(method, aux):
    X, V = _cloud()
    arr = np.arange(len(X))[:, None] * np.ones((1, 3))
    kw = {"X": X} if aux else {}
    src = arr if aux else X
    a = JS.sample(src, 60, method=method, V=V, seed=5, **kw)
    b = TS.sample(src, 60, method=method, V=V, seed=5, device="cpu", **kw)
    assert np.array_equal(a, b)


def test_sample_rejects_velocity_without_V_as_jax_does():
    X, _ = _cloud()
    for mod in (JS, TS):
        with pytest.raises(NotImplementedError, match="velocity"):
            mod.sample(X, 10, method="velocity")


def test_sample_kmeans_ignores_seed_as_jax_does():
    """`sample(method="kmeans")` takes `sample_by_kmeans`'s own seed (0)."""
    X, _ = _cloud()
    a = TS.sample(X, 40, method="kmeans", seed=1, device="cpu")
    assert np.array_equal(a, TS.sample(X, 40, method="kmeans", seed=2, device="cpu"))
    assert np.array_equal(a, X[TS.sample_by_kmeans(X, 40, return_index=True, device="cpu")])


@pytest.mark.parametrize("return_index", [True, False])
def test_sample_by_kmeans_and_velocity_match_jax(return_index):
    X, V = _cloud()
    assert np.array_equal(TS.sample_by_kmeans(X, 30, return_index=return_index, seed=3, device="cpu"),
                          JS.sample_by_kmeans(X, 30, return_index=return_index, seed=3))
    assert np.array_equal(TS.sample_by_velocity(V, 70, seed=4), JS.sample_by_velocity(V, 70, seed=4))


@pytest.mark.parametrize("return_index", [True, False])
def test_trn_matches_jax(return_index):
    X, _ = _cloud(n=200)
    a, b = TS.trn(X, 25, return_index=return_index, seed=7), JS.trn(X, 25, return_index=return_index, seed=7)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("bounds", [None, [[0.0, 2.0], [-1.0, 1.0], [5.0, 6.0]]])
def test_lhsclassic_matches_jax(bounds):
    assert np.array_equal(TS.lhsclassic(17, 3, bounds=bounds, seed=2), JS.lhsclassic(17, 3, bounds=bounds, seed=2))


@pytest.mark.parametrize("c", [0, 3])
def test_trnet_matches_jax(c):
    X, _ = _cloud(n=150)
    a, b = TS.TRNET(12, X, seed=1), JS.TRNET(12, X, seed=1)
    assert np.array_equal(a.draw_sample(8), b.draw_sample(8))
    assert np.array_equal(a.run(tmax=120, c=c), b.run(tmax=120, c=c))
    a.run_n_pause(10, 40, tmax=60)
    b.run_n_pause(10, 40, tmax=60)
    assert np.array_equal(a.W, b.W)
    a.runOnce(X[3], 0.5, 0.1)
    b.runOnce(X[3], 0.5, 0.1)
    assert np.array_equal(a.W, b.W)


def test_sample_is_exported_where_jax_exports_it():
    assert stt.align.methods.sample is TS.sample and st.align.methods.sample is JS.sample


# -- binary_morani_result ---------------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["otsu", "edge-watershed"])
@pytest.mark.parametrize("tissue", [False, True])
def test_binary_morani_result_matches_jax(method, tissue):
    X = make_raster(96, 96, seed=0)
    _, c, _, p = JM.moranI(X, JM._moran_kernel_weights(7))
    tissue_mask = np.zeros(X.shape, np.uint8)
    tissue_mask[8:88, 4:80] = 1
    kw = {"tissue_mask": tissue_mask} if tissue else {}
    a = JM.binary_morani_result(c, p, method=method, **kw)
    b = TM.binary_morani_result(c, p, method=method, device="cpu", **kw)
    assert a.any() and (~a).any()
    assert int((a != b).sum()) == 0


def test_binary_morani_result_given_cutoffs_matches_jax():
    X = make_raster(64, 64, seed=1)
    _, c, _, p = JM.moranI(X, JM._moran_kernel_weights(5))
    for kw in ({"pvalue_cutoff": 0.05}, {"pvalue_cutoff": 0.01, "c_cutoff": 1.0}):
        assert np.array_equal(TM.binary_morani_result(c, p, device="cpu", **kw), JM.binary_morani_result(c, p, **kw))
    with pytest.raises(ValueError, match="unknown method"):
        TM.binary_morani_result(c, p, method="nope", device="cpu")


# -- logging ------------------------------------------------------------------------------------------------


def test_logging_helpers_match_jax():
    for level in (logging.INFO, logging.WARNING, logging.CRITICAL, logging.DEBUG, logging.ERROR):
        for indent in (1, 2):
            assert TLg.format_logging_message("m", level, indent) == JLg.format_logging_message("m", level, indent)
    TLg.set_logger_level("spateo_port_test", logging.WARNING)
    assert logging.getLogger("spateo_port_test").level == logging.WARNING
    TLg.silence_logger("spateo_port_test")
    lg = logging.getLogger("spateo_port_test")
    assert lg.level == logging.CRITICAL + 100 and lg.propagate is False

    @TLg.timeit
    def twice(x):
        """doc"""
        return 2 * x

    assert twice(4) == 8 and twice.__name__ == "twice" and twice.__doc__ == "doc"


def _records(mod, namespace, call, caplog):
    """(level, message) of each record that `call(mod)` logs, with the
    logger at DEBUG; the package's loggers do not propagate, so caplog's
    handler goes on them directly."""
    lg = logging.getLogger(namespace)
    saved = lg.level
    lg.addHandler(caplog.handler)
    lg.setLevel(logging.DEBUG)
    caplog.clear()
    try:
        call(mod)
    finally:
        lg.removeHandler(caplog.handler)
        lg.setLevel(saved)
    return [(r.levelno, r.getMessage()) for r in caplog.records]


def _raise_and_log(lm):
    try:
        raise ValueError("boom")
    except ValueError:
        lm.main_exception("caught")


def _insert_notices(lm):
    lm.main_set_level(lm.DEBUG)  # the notices log at DEBUG
    for attr in ("var", "obs", "obsm", "uns", "layer"):
        getattr(lm, f"main_info_insert_adata_{attr}")(f"key_{attr}")


LOGGER_CALLS = {
    "main_error": lambda m: m.LoggerManager("spateo_lm_test").main_error("e", indent_level=2),
    "main_critical": lambda m: m.LoggerManager("spateo_lm_test").main_critical("c"),
    "main_exception": lambda m: _raise_and_log(m.LoggerManager("spateo_lm_test")),
    "main_info_insert_adata": lambda m: _insert_notices(m.LoggerManager("spateo_lm_test")),
    "gen_logger": lambda m: m.LoggerManager("spateo_lm_test").gen_logger("spateo_lm_test.gen").warning("w"),
    "temp_timer_logger": lambda m: m.LoggerManager("spateo_lm_test").temp_timer_logger.info("t"),
    "Logger.error, critical": lambda m: (m.Logger("spateo_lm_test").error("e %d", 1),
                                         m.Logger("spateo_lm_test").critical("c")),
    "Logger.namespaced": lambda m: m.Logger("spateo_lm_test", logging.DEBUG).namespaced("sub").info("n"),
    "Logger.report_progress": lambda m: (m.Logger("spateo_lm_test").report_progress(count=3, total=8,
                                                                                   progress_name="p"),
                                         m.Logger("spateo_lm_test").report_progress(12.5)),
}


@pytest.mark.parametrize("name", sorted(LOGGER_CALLS))
def test_logger_methods_log_what_jax_logs(name, caplog):
    """Each method of `Logger` and `LoggerManager` that the port took late
    logs the same records (level and message) as the JAX package's, on the
    logger it logs to."""
    namespace = {"gen_logger": "spateo_lm_test.gen", "temp_timer_logger": "spateo_lm_test-temp-timer-logger",
                 "Logger.namespaced": "spateo_lm_test.sub"}.get(name, "spateo_lm_test")
    want = _records(JLg, namespace, LOGGER_CALLS[name], caplog)
    got = _records(TLg, namespace, LOGGER_CALLS[name], caplog)
    assert got == want and len(want) > 0


def test_logger_attributes_match_jax():
    """The level constants, `Logger.level`, `namespaced`'s name and level,
    `gen_logger`'s level, and `log_time` / `finish_progress`, which read the
    host clock since the previous call."""
    for name in ("DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL"):
        assert getattr(TLg.LoggerManager, name) == getattr(JLg.LoggerManager, name) == getattr(logging, name)
    for mod in (JLg, TLg):
        lg = mod.Logger("spateo_attr_test", level=logging.WARNING)
        assert lg.level == logging.WARNING
        sub = lg.namespaced("x")
        assert sub.namespace == "spateo_attr_test.x" and sub.level == logging.WARNING
        lm = mod.LoggerManager("spateo_attr_test")
        lm.main_set_level(logging.ERROR)
        assert lm.gen_logger("spateo_attr_test.g").level == logging.ERROR
        assert lm.temp_timer_logger.namespace == "spateo_attr_test-temp-timer-logger"
    lg = TLg.Logger("spateo_attr_test")
    t0 = lg.previous_timestamp
    assert lg.time_passed == 0.0 and lg.log_time() >= 0.0 and lg.previous_timestamp >= t0
    assert lg.time_passed == lg.previous_timestamp - t0


@pytest.mark.parametrize("finish", [("s", r"p finished \[\d+\.\d{4}s\]"), ("ms", r"p finished \[\d+\.\d{4}ms\]")])
def test_finish_progress_logs_as_jax_does(finish, caplog):
    unit, pattern = finish
    recs = [_records(m, "spateo_lm_test", lambda m: m.Logger("spateo_lm_test").finish_progress("p", unit), caplog)
            for m in (JLg, TLg)]
    for (level, msg), in recs:
        assert level == logging.INFO and re.fullmatch(pattern, msg), msg


@pytest.mark.parametrize("n,use_iterable", [(7, False), (40, False), (45, True)])
def test_main_tqdm_yields_and_logs_as_jax_does(n, use_iterable, caplog):
    """`main_tqdm` yields every item and logs `desc [i/total] (s)` every
    twentieth of the total, as the JAX package's does (the seconds, which
    read the host clock, are left out of the comparison)."""
    def run(mod):
        lm = mod.LoggerManager("spateo_lm_test")
        kw = {"iterable": range(n)} if use_iterable else {"generator": list(range(n))}
        return list(lm.main_tqdm(desc="loop", **kw))

    out = {}
    for mod in (JLg, TLg):
        recs = _records(mod, "spateo_lm_test", lambda m: out.__setitem__(m, run(m)), caplog)
        out[mod, "lines"] = [(lvl, re.sub(r"\(\d+\.\ds\)$", "(s)", msg)) for lvl, msg in recs]
    assert out[TLg] == out[JLg] == list(range(n))
    assert out[TLg, "lines"] == out[JLg, "lines"] and len(out[JLg, "lines"]) >= 7


# -- the core device helpers ----------------------------------------------------------------------------------


TO_DEVICE_CASES = {
    "float64": (np.linspace(-1.5, 2.5, 7), None),
    "int64": (np.arange(-3, 5, dtype=np.int64), None),
    "uint8": (np.arange(250, 256, dtype=np.uint8), None),
    "uint64": (np.array([0, 7, 2**31 + 5], dtype=np.uint64), None),
    "bool": (np.array([True, False, True]), None),
    "complex128": (np.array([1 + 2j, -0.5j]), None),
    "explicit float64": (np.arange(6, dtype=np.int64).reshape(2, 3), np.float64),
    "float32 of float64": (np.array([1 / 3, 2 / 3]), np.float32),
    "scalar": (2.5, None),
    "list": ([1, 2, 3], None),
}


@pytest.mark.parametrize("case", sorted(TO_DEVICE_CASES))
def test_to_device_matches_jax(case):
    """`to_device(x, dtype)` gives the JAX package's dtype (x64 off: 64-bit
    types narrow, also when asked for) and values; a torch dtype does too."""
    x, dtype = TO_DEVICE_CASES[case]
    a = np.asarray(JB.to_device(x, dtype))
    b = TB.to_device(x, dtype, device="cpu")
    assert b.device.type == "cpu" and str(b.dtype) == f"torch.{a.dtype.name}"
    assert b.shape == a.shape and np.array_equal(b.numpy(), a)
    if dtype is not None:
        assert torch.equal(TB.to_device(x, getattr(torch, np.dtype(dtype).name), device="cpu"), b)
    assert stt.core.to_device is TB.to_device


def test_to_device_sharding_matches_jax():
    """`to_device(x, dtype, sharding=...)` on a one-rank gloo mesh: the
    placements over `config.mesh`, or a (mesh, placements) pair, give a
    DTensor whose full tensor is the JAX package's array on its 8-device
    mesh; a missing mesh or placements of another length raise MeshError."""
    from torch.distributed.tensor import DTensor, Shard

    from spateo_tpu.parallel import mesh as jmesh

    x = np.random.default_rng(3).normal(size=(16, 3))
    jm = jmesh.create_mesh()
    want = {"row": np.asarray(JB.to_device(x, np.float32, sharding=jmesh.row_sharding(jm))),
            "replicated": np.asarray(JB.to_device(x, sharding=jmesh.replicated(jm)))}
    cfg = stt.config
    saved = cfg.mesh_device
    cfg.mesh_device = "cpu"
    try:
        mesh = cfg.mesh
        got = {"row": TB.to_device(x, np.float32, sharding=stt.parallel.row_sharding(mesh)),
               "replicated": TB.to_device(x, sharding=(mesh, stt.parallel.replicated(mesh)))}
        for k, t in got.items():
            assert isinstance(t, DTensor) and t.dtype == torch.float32
            assert np.array_equal(t.full_tensor().numpy(), want[k]), k
        assert got["row"].placements[0] == Shard(0)
        with pytest.raises(stt.MeshError, match="DeviceMesh"):
            TB.to_device(x, sharding=(None, stt.parallel.replicated(mesh)))
        with pytest.raises(stt.MeshError, match="placements"):
            TB.to_device(x, sharding=[Shard(0)])
    finally:
        torch.distributed.destroy_process_group()
        cfg.mesh_device = saved


@pytest.mark.parametrize("pads", [(1, 1), (8, 128)])
def test_csr_and_layer_to_device_match_jax(pads):
    rng = np.random.default_rng(0)
    M = sparse.random(37, 53, density=0.2, random_state=0, format="csr") * 10
    M.data = np.round(M.data)
    a, shape_a = JB.csr_to_dense_device(M, pad_rows_to=pads[0], pad_cols_to=pads[1])
    b, shape_b = TB.csr_to_dense_device(M, pad_rows_to=pads[0], pad_cols_to=pads[1], device="cpu")
    assert shape_a == shape_b == (37, 53) and b.dtype == torch.float32
    assert np.array_equal(np.asarray(a), b.numpy())
    aj = st.AnnData(X=M, var=pd.DataFrame(index=[f"g{i}" for i in range(53)]))
    aj.layers["dense"] = rng.poisson(2.0, (37, 53)).astype(np.float64)
    at = adata_from_reference(aj)
    for layer in (None, "dense"):
        a, sa = JB.layer_to_device(aj, layer, pad_rows_to=pads[0], pad_cols_to=pads[1])
        b, sb = TB.layer_to_device(at, layer, pad_rows_to=pads[0], pad_cols_to=pads[1], device="cpu")
        assert sa == sb and np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("dtype", [np.float64, np.int64, np.float32, np.complex128])
def test_segment_sum_device_matches_jax(dtype):
    rng = np.random.default_rng(1)
    values = rng.integers(0, 50, (400, 3)).astype(dtype)
    ids = rng.integers(-2, 12, 400)  # out-of-range ids are dropped in both
    a = np.asarray(JB.segment_sum_device(values, ids, 10))
    b = TB.segment_sum_device(values, ids, 10, device="cpu").numpy()
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_points_to_raster_matches_jax():
    rng = np.random.default_rng(2)
    x, y = rng.integers(0, 30, 1000), rng.integers(0, 20, 1000)
    counts = rng.integers(1, 9, 1000)
    a = np.asarray(JB.points_to_raster(x, y, counts, (30, 20)))
    b = TB.points_to_raster(x, y, counts, (30, 20), device="cpu").numpy()
    assert np.array_equal(a, b)
    assert stt.core.points_to_raster is TB.points_to_raster and stt.core.layer_to_device is TB.layer_to_device


# -- PCA's randomized and ARPACK solvers ---------------------------------------------------------------------


def _pca_data(n, d, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)) @ rng.normal(size=(d, d)) * 0.1 + rng.normal(size=(n, d))


def _check_pca(X, **kw):
    from sklearn.decomposition import PCA as SkPCA

    a = SkPCA(random_state=0, **kw).fit(X)
    b = PCA(random_state=0, device="cpu", **kw).fit(X)
    assert _scaled(b.components_, a.components_) <= PCA_TOL
    assert _scaled(b.transform(X), a.transform(X)) <= PCA_TOL
    for attr in ("explained_variance_", "explained_variance_ratio_", "singular_values_", "mean_"):
        assert _scaled(getattr(b, attr), getattr(a, attr)) <= PCA_TOL, attr
    assert abs(b.noise_variance_ - a.noise_variance_) <= PCA_TOL * a.explained_variance_[0]
    assert b.n_components_ == a.n_components_
    return a


@pytest.mark.parametrize("n,d", [(2000, 1500), (2000, 300), (300, 2000)])
def test_pca_auto_takes_the_randomized_solver_as_sklearn(n, d):
    a = _check_pca(_pca_data(n, d), n_components=10)
    assert a._fit_svd_solver == "randomized"


@pytest.mark.parametrize("normalizer,iterated_power", [("LU", "auto"), ("QR", "auto"), ("none", "auto"),
                                                       ("auto", 2), ("auto", 5)])
def test_pca_randomized_normalizers_match_sklearn(normalizer, iterated_power):
    _check_pca(_pca_data(600, 200), n_components=12, svd_solver="randomized",
               power_iteration_normalizer=normalizer, iterated_power=iterated_power, n_oversamples=6)


@pytest.mark.parametrize("n,d,k", [(600, 200, 10), (150, 400, 20), (100, 30, None)])
def test_pca_arpack_matches_sklearn(n, d, k):
    _check_pca(_pca_data(n, d), n_components=k, svd_solver="arpack")


def test_pca_fit_runs_where_jax_runs():
    """`pca_fit` at 2,000 x 300 with 10 components, which scikit-learn's
    "auto" (the JAX package's `pca_fit`) sends to the randomized solver."""
    from spateo_tpu.tools.dimensionality_reduction import pca_fit as jax_pca_fit

    X = _pca_data(2000, 300)
    fa, Pa = jax_pca_fit(X, n_components=10, random_state=0)
    fb, Pb = pca_fit(X, n_components=10, random_state=0, device="cpu")
    assert _scaled(Pb, Pa) <= PCA_TOL and _scaled(fb.components_, fa.components_) <= PCA_TOL
    with pytest.raises(NotImplementedError, match="whole number"):
        PCA(n_components="mle", device="cpu").fit(X)
    with pytest.raises(ValueError, match="strictly below"):
        PCA(n_components=300, svd_solver="arpack", device="cpu").fit(X)
