"""Two numerical probes of `chip_smoke.py` phases 18-19 on the CPU.

`paste`: PASTE (`paste_align_ref`, its defaults, TRN references) on
`chip_smoke.paste_sections` at the sizes given, printing for each the
rotation error against the planted 30 deg, the plan's hardness (median share
of a row's mass on its largest entry) and how far each reference cell's
matched position (the plan's barycentre, the planted transform undone) lies
from the cell itself, in coordinate units of the 10 x 6 domain.

`gw`: the between-slice GW scan's solves (`cal_gw_dis_on_genes` on phase
18d's pseudocounted 400-cell samples, 20 genes, the observed round and one
bootstrap round) cut to one outer iteration, printing how far the GW values
move when either cost matrix moves by one float32 ulp; then the same on two
genes with the costs divided by their largest entry at all 30 outer
iterations.

Run from the repository root:

    python3 scripts/svg_paste_probe.py paste 20000,4000,2000 2000,64,300
    python3 scripts/svg_paste_probe.py gw
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402


def paste(n_cells, n_genes, n_sampling):
    a, b = cs.paste_sections(n_cells, n_genes)
    _, refs, pi, log, _ = cs.paste_main((a, b), "cpu", n_sampling=n_sampling)
    ra, rb = refs
    ca = np.asarray(a.obsm["spatial"])[[a.obs_names.get_loc(n) for n in ra.obs_names]]
    cb = np.asarray(b.obsm["spatial"])[[b.obs_names.get_loc(n) for n in rb.obs_names]]
    th = np.deg2rad(cs.PASTE_ANGLE)
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    centre = np.array(cs.SVG_DOMAIN) / 2 / cs.PASTE_UNIT
    cb0 = (cb - np.asarray(cs.PASTE_SHIFT) - centre) @ R + centre
    off = np.linalg.norm((pi / pi.sum(1, keepdims=True)) @ cb0 - ca, axis=1)
    print(f"paste {n_cells} cells x {n_genes} genes through {n_sampling} references: rotation error "
          f"{cs.rotation_error_deg(rb.uns['models_align']['R'])!r} deg, {log.iterations} outer iterations, a row's "
          f"largest entry {float(np.median(pi.max(1) / pi.sum(1)))!r} of its mass (median), matched positions "
          f"{float(np.median(off))!r} units off (median), {float(np.percentile(off, 90))!r} (90th percentile)",
          flush=True)


def gw():
    import spateo_tpu_torch as stt
    from spateo_tpu_torch.svg.get_svg import bin_scale_adata_get_distance

    small, small2 = (stt.svg.smoothing_and_sampling(cs.cortex_section(seed=s), downsampling=cs.SVG_DOWNSAMPLE,
                                                    device="cpu")[0] for s in (0, 1))
    genes = [g for g in small.var_names if g.startswith("L")][:10] + [f"g{i}" for i in range(190, 200)]
    (b1, C1), (b2, C2) = (bin_scale_adata_get_distance(cs.pseudocounted(x), **cs.SVG_KW) for x in (small, small2))
    C1, C2 = C1.astype(np.float32), C2.astype(np.float32)
    base = cs.gw_scan((C1, C2, b1, b2), genes, "cpu", outer=1)[0]
    for what, c1, c2 in (("C1 one ulp up", np.nextafter(C1, np.float32(np.inf)), C2),
                         ("C2 one ulp down", C1, np.nextafter(C2, np.float32(0)))):
        moved = cs.gw_scan((c1, c2, b1, b2), genes, "cpu", outer=1)[0]
        print(f"gw DNB costs (max {float(max(C1.max(), C2.max()))!r}), one outer iteration, {what}: "
              f"{cs.rel_err(moved, base)!r} of scale", flush=True)
    scale = float(max(C1.max(), C2.max()))
    two = [genes[0], genes[-1]]
    unit, its = cs.gw_scan((C1 / scale, C2 / scale, b1, b2), two, "cpu", seeds=(0,))
    moved, _ = cs.gw_scan((np.nextafter(C1 / scale, np.float32(np.inf)), C2 / scale, b1, b2), two, "cpu", seeds=(0,))
    print(f"gw unit costs, {its} outer iterations, C1 one ulp up: {cs.rel_err(moved, unit)!r} of scale", flush=True)


if __name__ == "__main__":
    torch.backends.cuda.matmul.allow_tf32 = False
    if sys.argv[1] == "paste":
        for arg in sys.argv[2:]:
            paste(*(int(v) for v in arg.split(",")))
    else:
        gw()
