"""SVG layer (`stt.svg`): spatially-variable-gene detection via OT distances,
ported from `spateo_tpu.svg`. The per-gene Wasserstein scan is a batched
log-domain Sinkhorn on the device, the between-slice scan entropic GW on the
device; graphs, loess and statistics stay on the host.
`cal_wass_dis_batch_sharded` splits the scan's genes over the ranks of a
`torch.distributed` mesh."""

from .get_svg import (
    bin_scale_adata_get_distance,
    cal_wass_dis_for_genes,
    cal_wass_dis_nobs,
    cal_wass_dis_target_on_genes,
    cal_wass_dist_bs,
    downsampling,
    get_std_wasserstein,
    smooth,
    smoothing_and_sampling,
    svg_iden_reg,
)
from .get_svg_between_slice import cal_gro_wass_bs, cal_gw_dis_on_genes
from .utils import (
    add_pos_ratio_to_adata,
    bin_adata,
    cal_euclidean_distance,
    cal_geodesic_distance,
    cal_rank_p,
    cal_wass_dis,
    cal_wass_dis_batch,
    cal_wass_dis_batch_sharded,
    cal_wass_dis_exact,
    filter_adata_by_pos_ratio,
    get_genes_by_pos_ratio,
    loess_reg,
    multipletests_bh,
    scale_to,
    shuffle_adata,
)

# reference-named alias (reference get_svg.py:170 names the smoother
# `smoothing`)
smoothing = smooth
