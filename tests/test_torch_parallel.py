"""The port's distribution layer (`spateo_tpu_torch.parallel`, `config.mesh`),
the sharded Jacobi solve and the sharded SparseVFC, held against the JAX
package on the CPU.

The port's ranks are real processes: gloo groups of 4 and of 3 ranks on the
CPU (`_torch_ranks.run_groups`; 3 makes the row blocks uneven), each running
every job of this file in one start. The JAX side runs here, on the
8-device CPU mesh that `conftest.py` forces. Every job returns the same bits
on every rank, checked for each.

Bars:

- Mesh layer: the same outcome as JAX's for each mesh shape (the axis sizes,
  or MeshError), placements equivalent to JAX's partition specs, DTensors
  holding the input rows.
- Jacobi: the JAX test's raster (`tests/test_digitization.py:236-254`),
  against `spateo_tpu`'s `jacobi_solve` and `jacobi_solve_sharded` on its
  8-device mesh: the same iteration count, fields within 1e-5 (the port's
  halo scheme gives the serial sweeps bit for bit, checked against the
  port's own `jacobi_solve` too).
- SparseVFC: the JAX test's case (`tests/test_tdr.py:44-73`, 397 points, M
  80). Against JAX's unsharded `SparseVFC` (its own slow test holds the
  sharded one equal to it): V within 5e-3 after 5 iterations, shapes (397,
  3) and (397,); the converged field's cosine to the truth above 0.99.
"""

import numpy as np
import pytest
import torch

import jax

import spateo_tpu as st
import spateo_tpu_torch as stt
from _torch_ranks import run_groups, same_bits
from spateo_tpu.ops import stencil as jstencil
from spateo_tpu.ops import vfc as jvfc
from spateo_tpu.parallel import mesh as jmesh
from spateo_tpu_torch.ops import stencil as tstencil
from spateo_tpu_torch.ops import vfc as tvfc
from spateo_tpu_torch.parallel import distributed as D

WORLDS = (4, 3)
JAX_DEVICES = 8


def _jacobi_raster():
    H = W = 60
    field = np.zeros((H, W), np.float32)
    border = np.zeros((H, W), bool)
    mask = np.zeros((H, W), np.float32)
    mask[5:-5, 5:-5] = 1
    field[5, 5:-5] = 1.0
    border[5, 5:-5] = True
    field[-6, 5:-5] = 100.0
    border[-6, 5:-5] = True
    return field, border, mask


JACOBI = dict(max_itr=20000, max_err=1e-8)


def _rotation():
    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, (400, 3)).astype(np.float32)
    V = np.cross(np.broadcast_to(np.array([0.0, 0.0, 1.0]), X.shape), X).astype(np.float32)
    return X[:397], V[:397]  # not a multiple of any world size here


VFC_SHORT = dict(M=80, lambda_=0.1, MaxIter=5)
VFC_FULL = dict(M=80, lambda_=0.1)
JOBS = ["mesh_layer", "config_mesh", "jacobi", "vfc_short", "vfc_full"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    field, border, mask = _jacobi_raster()
    X, V = _rotation()
    jobs = [
        ("mesh_layer", {}),
        ("config_mesh", {}),
        ("jacobi", dict(field=field, border=border, mask=mask, **JACOBI)),
        ("vfc", dict(X=X, V=V, kw=VFC_SHORT)),
        ("vfc", dict(X=X, V=V, kw=dict(VFC_FULL, Grid=X[:20]))),
    ]
    out = run_groups({w: jobs for w in WORLDS}, tmp_path_factory.mktemp("parallel"))
    return {w: {name: [r[i] for r in per_rank] for i, name in enumerate(JOBS)} for w, per_rank in out.items()}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("job", ["config_mesh", "jacobi", "vfc_short", "vfc_full"])
def test_every_rank_returns_the_same_bits(ranks, world, job):
    assert same_bits(ranks[world][job])


# -- the mesh layer ------------------------------------------------------------------------------------------


def _jax_outcome(shape, names, n=JAX_DEVICES):
    try:
        m = jmesh.create_mesh(shape, names, devices=jax.devices()[:n])
        return dict(m.shape)
    except st.MeshError:
        return "MeshError"


def _cases(n):
    """The mesh cases of `_torch_rank_jobs.mesh_layer` at n devices."""
    return {
        "default": (None, ("data", "model")),
        "one axis": (None, ("data",)),
        "2d": ((n // 2, 2) if n % 2 == 0 else (n, 1), ("data", "model")),
        "too many": ((2 * n,), ("data",)),
        "too few": ((n - 1, 1), ("data", "model")),
        "names": ((n,), ("data", "model")),
    }


@pytest.mark.parametrize("world", WORLDS)
def test_create_mesh_matches_jax(ranks, world):
    """Each case has JAX's outcome at its 8 devices and the port's at
    `world` ranks: the same kind (MeshError or a mesh), and a mesh has the
    axis sizes asked for (all devices on 'data' by default)."""
    got = ranks[world]["mesh_layer"][0]["shapes"]
    for key, (shape, names) in _cases(world).items():
        jshape, jnames = _cases(JAX_DEVICES)[key]
        want = _jax_outcome(jshape, jnames)
        if want == "MeshError":
            assert got[key] == "MeshError", key
            continue
        assert list(want) == list(got[key]) == list(names), key
        for out, n, s in ((want, JAX_DEVICES, jshape), (got[key], world, shape)):
            assert tuple(out.values()) == (s if s is not None else (n,) + (1,) * (len(names) - 1)), key
    assert got["global (3, 5)"] == "MeshError"
    with pytest.raises(st.MeshError):
        st.parallel.global_mesh(("data", "model"), shape=(3, 5))
    assert got["global"] == {"data": world}
    assert dict(st.parallel.global_mesh(("data",)).shape) == {"data": jax.device_count()}


def _jax_placements(sharding):
    """A JAX NamedSharding as DTensor placements: per mesh axis, Shard(d)
    for the array dim d that the spec puts on it, else Replicate()."""
    spec = list(sharding.spec)
    out = []
    for name in sharding.mesh.axis_names:
        dims = [d for d, s in enumerate(spec) if s == name]
        out.append(f"Shard(dim={dims[0]})" if dims else "Replicate()")
    return out


def test_placements_match_jax_specs(ranks):
    m = jmesh.create_mesh((4, 2), ("data", "model"))
    want = [_jax_placements(s) for s in (jmesh.row_sharding(m), jmesh.pairwise_sharding(m), jmesh.replicated(m))]
    for world in WORLDS:
        for r in ranks[world]["mesh_layer"]:
            assert [list(p) for p in r["placements"]] == want


@pytest.mark.parametrize("world", WORLDS)
def test_shard_rows_and_global_arrays(ranks, world):
    """`shard_rows` and `make_global_array` hold the input's rows (JAX: the
    same rows, padded to the mesh); rows that are not a DTensor's blocks
    raise; `process_allgather` stacks every rank's array."""
    x = np.arange(10 * world * 3, dtype=np.float32).reshape(-1, 3)
    jarr, jn = jmesh.shard_rows(x, jmesh.create_mesh())
    np.testing.assert_array_equal(np.asarray(jarr)[:jn], x)
    for rank, r in enumerate(ranks[world]["mesh_layer"]):
        shape, n, full = r["shard_rows"]
        assert shape == x.shape and n == jn == len(x)
        np.testing.assert_array_equal(full, x)
        np.testing.assert_array_equal(r["local_rows"], np.array_split(x, world)[rank])
        assert r["global_array"][0] == x.shape
        np.testing.assert_array_equal(r["global_array"][1], x)
        assert r["uneven"] == "MeshError"
        np.testing.assert_array_equal(r["allgather"], 10 * np.arange(1, world + 1, dtype=np.int32)[:, None])
        np.testing.assert_array_equal(r["flags"], (np.arange(world) % 2 == 0)[:, None])
        assert r["distributed"] is True and r["device_count"] == world
    assert st.parallel.process_allgather(np.array([1.5])).shape == (1, 1)


def test_single_process_layer():
    """Without a process group, as JAX's single-host path: nothing starts,
    `process_allgather` returns x[None], and a mesh shape must cover one
    device."""
    D.initialize_distributed()
    assert D.is_distributed() is False and not torch.distributed.is_initialized()
    np.testing.assert_array_equal(stt.parallel.process_allgather(np.array([1.5])), [[1.5]])
    assert stt.parallel.device_count() == 1
    with pytest.raises(stt.MeshError, match="does not cover 1 devices"):
        stt.parallel.create_mesh((2,), ("data",), device="cpu")
    with pytest.raises(stt.MeshError, match="has 1 axes but 2 names"):
        stt.parallel.create_mesh((1,), ("data", "model"), device="cpu")
    with pytest.raises(stt.MeshError, match="multiply out"):
        stt.parallel.global_mesh(("data", "model"), shape=(3, 5), device="cpu")
    assert not torch.distributed.is_initialized()
    assert stt.parallel.pad_to_multiple(10, 4) == jmesh.pad_to_multiple(10, 4) == 12
    x = np.arange(10.0).reshape(5, 2)
    (pt, nt), (pj, nj) = stt.parallel.pad_rows(x, 4, fill=-1.0), jmesh.pad_rows(x, 4, fill=-1.0)
    assert nt == nj == 5
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))


def test_env_driven_bootstrap_branches(monkeypatch):
    """Which environments start a process group, and how, with the group's
    start faked (as `tests/test_tools.py` pins JAX's): none without a
    launcher's variables; ``env://`` under torchrun's; the coordinator from
    ``COORDINATOR_ADDRESS`` or the arguments (``tcp://`` for host:port, a
    URL as given); NCCL for the card and gloo for the CPU unless asked."""
    calls = []
    monkeypatch.setattr(D.dist, "init_process_group", lambda backend, **kw: calls.append(dict(kw, backend=backend)))
    monkeypatch.setattr(D, "_set_device", lambda *a: None)
    monkeypatch.setattr(D, "_initialized", False)
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "COORDINATOR_ADDRESS", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)

    D.initialize_distributed()
    assert calls == [] and D.is_distributed() is False

    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    D.initialize_distributed()
    D.initialize_distributed(device="cpu")
    assert calls == [dict(init_method="env://", backend="nccl"), dict(init_method="env://", backend="gloo")]
    assert D.is_distributed() is False  # the faked start left no group

    calls.clear()
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k)
    monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.1:1234")
    D.initialize_distributed(num_processes=2, process_id=1)
    assert calls == [dict(init_method="tcp://10.0.0.1:1234", world_size=2, rank=1, backend="nccl")]

    calls.clear()
    D.initialize_distributed(coordinator_address="host:9", num_processes=4, process_id=0, backend="gloo")
    D.initialize_distributed(coordinator_address="file:///tmp/s", num_processes=4, process_id=3, device="cpu")
    assert calls == [dict(init_method="tcp://host:9", world_size=4, rank=0, backend="gloo"),
                     dict(init_method="file:///tmp/s", world_size=4, rank=3, backend="gloo")]
    with pytest.raises(ValueError, match="num_processes"):
        D.initialize_distributed(coordinator_address="host:9")

    calls.clear()
    monkeypatch.setattr(D, "_initialized", True)
    D.initialize_distributed()
    assert calls == []


@pytest.mark.parametrize("world", WORLDS)
def test_config_mesh_matches_jax(ranks, world):
    """`config.mesh`: every rank on 'data' (JAX: every device), kept until
    its settings change, MeshError for a shape that does not cover the
    ranks (JAX: the devices)."""
    jcfg = st.configuration.SpateoConfig()
    assert dict(jcfg.mesh.shape) == {"data": jax.device_count(), "model": 1}
    assert jcfg.mesh is jcfg.mesh
    jcfg.mesh_shape = (3 * jax.device_count(),)
    jcfg.mesh_axis_names = ("data",)
    with pytest.raises(st.MeshError):
        jcfg.mesh
    for r in ranks[world]["config_mesh"]:
        assert r == dict(shape={"data": world, "model": 1}, kept=True, bad="MeshError", one_axis={"data": world})


# -- Jacobi --------------------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_jacobi():
    field, border, mask = _jacobi_raster()
    serial = jstencil.jacobi_solve(field, border, mask, **JACOBI)
    sharded = jstencil.jacobi_solve_sharded(field, border, mask, mesh=jmesh.create_mesh(), **JACOBI)
    return serial, sharded


@pytest.mark.parametrize("world", WORLDS)
def test_jacobi_sharded_matches_jax(ranks, jax_jacobi, world):
    (fs, its, _), (fp, itp, _) = jax_jacobi
    f, it, err = ranks[world]["jacobi"][0]
    assert it == its == itp and err <= JACOBI["max_err"]
    np.testing.assert_allclose(f, fs, atol=1e-5)
    np.testing.assert_allclose(f, fp, atol=1e-5)
    field, border, mask = _jacobi_raster()
    ft, itt, _ = tstencil.jacobi_solve(field, border, mask, device="cpu", **JACOBI)
    assert itt == it
    np.testing.assert_array_equal(f, ft)


def test_jacobi_sharded_one_rank_is_the_serial_solve():
    """A one-rank mesh (started here, no launcher) runs `jacobi_solve`."""
    field, border, mask = _jacobi_raster()
    try:
        f1, it1, e1 = tstencil.jacobi_solve_sharded(field, border, mask, max_itr=500, max_err=1e-8,
                                                   mesh=stt.parallel.create_mesh(device="cpu"))
    finally:
        torch.distributed.destroy_process_group()
    f0, it0, e0 = tstencil.jacobi_solve(field, border, mask, max_itr=500, max_err=1e-8, device="cpu")
    assert it1 == it0 and e1 == e0
    np.testing.assert_array_equal(f1, f0)


# -- SparseVFC -----------------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_vfc():
    X, V = _rotation()
    return jvfc.SparseVFC(X, V, **VFC_SHORT)


@pytest.mark.parametrize("world", WORLDS)
def test_sparsevfc_sharded_matches_jax(ranks, jax_vfc, world):
    X, V = _rotation()
    r = ranks[world]["vfc_short"][0]
    assert r["V"].shape == (397, 3) and r["P"].shape == (397,)
    np.testing.assert_allclose(r["V"], jax_vfc["V"], atol=5e-3)
    assert int(r["iteration"]) == jax_vfc["iteration"] == 5
    np.testing.assert_array_equal(r["X_ctrl"], jax_vfc["X_ctrl"])
    np.testing.assert_allclose(r["beta"], jax_vfc["beta"], rtol=1e-5)
    full = ranks[world]["vfc_full"][0]
    cos = np.sum(full["V"] * V, axis=1) / (np.linalg.norm(full["V"], axis=1) * np.linalg.norm(V, axis=1) + 1e-12)
    assert np.mean(cos) > 0.99
    assert full["grid_V"].shape == (20, 3)
    np.testing.assert_allclose(full["grid_V"], full["V"][:20], atol=1e-5)


def test_sparsevfc_refuses_what_is_not_a_mesh():
    X, V = _rotation()
    with pytest.raises(TypeError, match="DeviceMesh"):
        tvfc.SparseVFC(X, V, M=20, MaxIter=5, mesh=object(), device="cpu")
