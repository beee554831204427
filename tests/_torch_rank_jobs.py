"""Jobs that the `test_torch_parallel*` tests run on each rank of a gloo
group on the CPU (`_torch_ranks.run_groups`), and the rank process's entry:

    python tests/_torch_rank_jobs.py RANK WORLD STORE JOBS_PICKLE OUT_DIR

Each job is a function of this module taking keyword arguments (arrays and
scalars) and returning arrays and scalars; the rank writes the list of its
jobs' results to ``OUT_DIR/out{RANK}.pkl``. Nothing here imports JAX or
`spateo_tpu`.
"""

from __future__ import annotations

import pickle
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import spateo_tpu_torch as stt  # noqa: E402
from spateo_tpu_torch import parallel as par  # noqa: E402


def _mesh(shape=None, axis_names=("data", "model")):
    return par.create_mesh(shape, axis_names, device="cpu")


# -- the mesh layer ----------------------------------------------------------------------------------------


def mesh_layer():
    """Mesh shapes and refusals at this world size, the placements, a
    DTensor from `shard_rows` and from `make_global_array`, and
    `process_allgather`."""
    import torch.distributed as dist

    n = dist.get_world_size()
    rank = dist.get_rank()
    shapes = {}
    for key, shape, names in (
        ("default", None, ("data", "model")),
        ("one axis", None, ("data",)),
        ("2d", (n // 2, 2) if n % 2 == 0 else (n, 1), ("data", "model")),
        ("too many", (2 * n,), ("data",)),
        ("too few", (n - 1, 1), ("data", "model")),
        ("names", (n,), ("data", "model")),
    ):
        try:
            m = par.create_mesh(shape, names, device="cpu")
            shapes[key] = {name: par.mesh_axis_size(m, name) for name in names}
        except stt.MeshError:
            shapes[key] = "MeshError"
    try:
        par.global_mesh(("data", "model"), shape=(3, 5), device="cpu")
        shapes["global (3, 5)"] = "no error"
    except stt.MeshError:
        shapes["global (3, 5)"] = "MeshError"
    g = par.global_mesh(("data",), device="cpu")
    shapes["global"] = {"data": par.mesh_axis_size(g, "data")}
    m = _mesh()
    place = [repr(p) for p in par.row_sharding(m)], [repr(p) for p in par.pairwise_sharding(m)], \
        [repr(p) for p in par.replicated(m)]
    x = np.arange(10 * n * 3, dtype=np.float32).reshape(-1, 3)
    dt, rows = par.shard_rows(x, m)
    local = x[rank * 10 : (rank + 1) * 10]
    ga = par.make_global_array(local, g)
    try:
        par.make_global_array(x[: rank + 1], g)
        uneven = "no error"
    except stt.MeshError:
        uneven = "MeshError"
    ag = par.process_allgather(np.array([10 * (rank + 1)], np.int32))
    flags = par.process_allgather(np.array([rank % 2 == 0]))
    return dict(shapes=shapes, placements=place, shard_rows=(tuple(dt.shape), rows, dt.full_tensor().numpy()),
                local_rows=dt.to_local().numpy(), global_array=(tuple(ga.shape), ga.full_tensor().numpy()),
                uneven=uneven, allgather=ag, flags=flags, distributed=par.is_distributed(),
                device_count=par.device_count())


def config_mesh():
    """`config.mesh` on the CPU: its axis sizes, that it is kept, and a
    shape that does not cover the ranks."""
    stt.config.mesh_device = "cpu"
    m1 = stt.config.mesh
    kept = stt.config.mesh is m1
    shape = {name: par.mesh_axis_size(m1, name) for name in m1.mesh_dim_names}
    stt.config.mesh_shape = (3 * par.device_count(),)
    stt.config.mesh_axis_names = ("data",)
    try:
        stt.config.mesh
        bad = "no error"
    except stt.MeshError:
        bad = "MeshError"
    stt.config.mesh_shape = None
    one = {name: par.mesh_axis_size(stt.config.mesh, name) for name in stt.config.mesh.mesh_dim_names}
    stt.config.mesh_axis_names = ("data", "model")
    return dict(shape=shape, kept=kept, bad=bad, one_axis=one)


# -- digitization -----------------------------------------------------------------------------------------------


def jacobi(field, border, mask, max_itr, max_err, check_every=100):
    from spateo_tpu_torch.ops.stencil import jacobi_solve_sharded

    return jacobi_solve_sharded(field, border, mask, max_err=max_err, max_itr=max_itr, check_every=check_every,
                                mesh=_mesh())


# -- Starro ----------------------------------------------------------------------------------------------------


def starro(X, kw):
    from spateo_tpu_torch.segmentation.starro import starro_em_bp_sharded

    return starro_em_bp_sharded(X, mesh=_mesh(), **kw)


def starro_public(X, kw):
    """`cs.score_and_mask_pixels(mesh=)` on an AGG AnnData of `X`: the two
    layers it writes."""
    a = stt.AnnData(X=X)
    stt.SKM.init_adata_type(a, stt.SKM.ADATA_AGG_TYPE)
    stt.cs.score_and_mask_pixels(a, "X", mesh=_mesh(), device="cpu", **kw)
    return a.layers["X_scores"], a.layers["X_mask"]


# -- Morpho ----------------------------------------------------------------------------------------------------


def _slice(pts, X):
    import pandas as pd

    n, g = X.shape
    a = stt.AnnData(X=X.copy(), obs=pd.DataFrame(index=[f"c{i}" for i in range(n)]),
                    var=pd.DataFrame(index=[f"g{j}" for j in range(g)]))
    a.obsm["spatial"] = pts.copy()
    stt.SKM.init_adata_type(a, "UMI")
    return a


def morpho(pts, X, shift, kw):
    """`align.morpho_align(mesh=)` of the slice at `pts` and its copy moved
    by `shift`: the moving slice's coordinates, its fit and the assignment
    (dense; in the sparse calculation mode a scipy matrix, densified)."""
    models, pis = stt.align.morpho_align([_slice(pts, X), _slice(pts + shift, X)], verbose=False, mesh=_mesh(),
                                         device="cpu", **kw)
    v = models[1].uns["VecFld_morpho"]
    P = pis[0]
    return dict(
        align=models[1].obsm["align_spatial"], nonrigid=models[1].obsm["align_spatial_nonrigid"],
        R=v["R"], t=v["t"], optimal_R=v["optimal_R"], Coff=v["Coff"], sigma2=np.float64(v["sigma2"]),
        gamma=np.float64(v["gamma"]), P=P.toarray() if hasattr(P, "toarray") else P.numpy(),
    )


def estep(args, route, sparse_top_k=0):
    """One E-step over this rank's rows of `args`: the kernel route
    (`estep_cuda`, its plain sweeps on the CPU) or `estep_reduced`'s dense
    or column-chunked route (with `sparse_top_k`, the sparse calculation
    mode's column top-k). The whole-slice sums and every rank's per-row
    outputs gathered."""
    from spateo_tpu_torch.alignment.methods.math import estep_reduced
    from spateo_tpu_torch.ops import estep_cuda as ec
    from spateo_tpu_torch.parallel._collectives import RowShard

    sh = RowShard(_mesh(), args["XAHat"].shape[0])
    t = {k: torch.as_tensor(v) for k, v in args.items()}
    for k in ("XAHat", "coordsA", "a_rows", "A_feats", "model_mul_vec"):
        t[k] = sh.take(t[k])
    scalars = [t[k] for k in ("sigma2", "gamma", "samples_s", "sigma2_variance")]
    if route == "kernel":
        out = ec.estep_cuda(t["XAHat"], t["coordsA"], t["coordsB"], t["a_rows"], t["b_cols"], t["A_feats"],
                            t["B_feats"], t["model_mul_vec"], *scalars, t["p"], shard=sh)
    else:
        out = estep_reduced(2.0, t["XAHat"], t["coordsA"], t["coordsB"], (t["a_rows"],), (t["b_cols"],),
                            (t["A_feats"],), (t["B_feats"],), scalars[0], t["model_mul_vec"], scalars[1],
                            scalars[2], scalars[3], ["gauss"], [t["p"]], n_chunks=1 if route == "dense" else 3,
                            sparse_top_k=sparse_top_k, shard=sh)
    return {k: (sh.gather_rows(v) if k in ("K_NA", "K_NA_spatial", "K_NA_sigma2", "PXB") else v).numpy()
            for k, v in out.items()}


# -- morphofields ----------------------------------------------------------------------------------------------


def vfc(X, V, kw):
    """`ops.vfc.SparseVFC(mesh=)`: its host-facing results."""
    from spateo_tpu_torch.ops.vfc import SparseVFC

    r = SparseVFC(X, V, mesh=_mesh(), device="cpu", **kw)
    keys = ("V", "P", "C", "X_ctrl", "VFCIndex", "beta", "gamma", "sigma2", "iteration", "E_traj", "grid_V")
    return {k: np.asarray(r[k]) for k in keys if r[k] is not None}


# -- MuSIC's local fits, the SVG scan, merfishVI ----------------------------------------------------------


def iwls(y, X, W, distr):
    """`iwls_batch_sharded` on the "data" axis: (betas, hats)."""
    from spateo_tpu_torch.tools.CCI_effects_modeling.regression_utils import iwls_batch_sharded

    return iwls_batch_sharded(y, X, W, mesh=_mesh(), distr=distr)


def wass(M, A, b=None, eps=None):
    """`cal_wass_dis_batch_sharded`: the distances and the sweeps run."""
    from spateo_tpu_torch.svg import utils as su

    r0 = su._sinkhorn_batch_run.host_reads
    d = su.cal_wass_dis_batch_sharded(M, A, b=b, eps=eps, mesh=_mesh())
    return d, 10 * (su._sinkhorn_batch_run.host_reads - r0)


def merfishvi(X, params, epochs, kw, noise=None, batch_indices=None, coords=None):
    """`MERFISHVI(...).train(mesh=)` from the weights `params` (a nested
    dict of arrays), replaying `noise` ([epochs, rows, latent]) and
    `batch_indices`: the losses, the latent and the trained weights."""
    import pandas as pd

    from spateo_tpu_torch.core.bridge import merfishvi_params_from_reference
    from spateo_tpu_torch.external.merfishvi import MERFISHVI

    n, g = X.shape
    a = stt.AnnData(X=X.copy(), obs=pd.DataFrame(index=[f"c{i}" for i in range(n)]),
                    var=pd.DataFrame(index=[f"g{j}" for j in range(g)]))
    if coords is not None:
        a.obsm["spatial"] = coords
    m = MERFISHVI(a, n_latent=4, n_hidden=16, device="cpu", **kw)
    if params is not None:
        merfishvi_params_from_reference(params, model=m)
    losses = m.train(max_epochs=epochs, mesh=_mesh(),
                     noise=None if noise is None else [[torch.from_numpy(e)] for e in noise],
                     batch_indices=None if batch_indices is None else torch.from_numpy(batch_indices))
    weights = {k: v.detach().numpy() for k, v in m.params.named_parameters()}
    return dict(losses=losses, latent=m.get_latent_representation(), weights=weights)


def main(argv):
    rank, world, store, jobs_file, out_dir = int(argv[0]), int(argv[1]), argv[2], argv[3], Path(argv[4])
    torch.set_num_threads(1)
    par.initialize_distributed(f"file://{store}", world, rank, device="cpu")
    results = []
    for name, kwargs in pickle.loads(Path(jobs_file).read_bytes()):
        results.append(globals()[name](**kwargs))
    (out_dir / f"out{rank}.pkl").write_bytes(pickle.dumps(results))
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
