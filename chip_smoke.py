"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it: the Starro
EM+BP slice and the rest of Starro, the Morpho alignment slice, the digitization slice with its
labeling chain, the morphofield slice, the whole atlas chain, MuSIC, and SVG
detection with PASTE, rigid slice alignment with mesh correction, `st.pp`
normalization and the k-means paths, the 3D reconstruction (`stt.tdr`
models and morphometrics), MuSIC's interpretation, the stain <-> RNA
alignment refinement and PASTE's Frobenius center NMF, the interpolation
engines, spatial clustering, UMAP and the two-group CCI test, and the
external models (CAST, STAGATE, merfishVI).
Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases; any failure raises, and the run then exits non-zero without the
final ``ok`` line:

0. environment: a CUDA device is required; prints the card's name and power
   limit, the torch and CUDA versions; TF32 off for matmul and cuDNN.
1. build: compiles every CUDA source of `spateo_tpu_torch/csrc`, one nvcc
   each, all started together.
2. kernel vs plain version: `bp_step` (the kernel) against
   `bp_step_reference` on the card at 2048x2048 and 1000x1500, in f32 and
   bf16, bit for bit, and full 50-iteration `bp_kernel` runs against the
   plain loop on the CPU; per-iteration times of both at 2048x2048 beside
   the previous design's; the fused delta (`bp_step(..., delta=True)`)
   against `delta_reference`, the same bits twice, and its launch timed
   against a plain one.
3. Starro main path: `cs.score_and_mask_pixels` on a 2048x2048 AGG raster
   (k=5, BP 50 iterations, bf16 messages), then four tiles through
   `starro_em_bp_stream`; the launch counts of that run prove the kernel and
   the fused delta's reduction ran.
   A per-stage breakdown of one tile is timed first.
4. Starro CUDA vs CPU: one 512x512 density raster and one NB fit scored on
   the card (kernel) and on the CPU (plain); mask IoU >= 0.999.
5. E-step kernels vs plain versions: `colnorm` and `rowred` (the kernels of
   `csrc/estep.cu`) against `colnorm_reference` and `rowred_reference`, and
   the whole `estep_cuda` against `estep_reference`, at the benchmark's
   20,000 x 2,000 (kl factors, G' = 51), at 100,000 x 10,000 Morton-ordered
   at the solver's sigma2 floor (most tiles skip) and at a ragged shape;
   CUDA-event times of each kernel and plain sweep, the share of tiles
   skipped, the most live tiles one `colnorm` block computes, and each
   kernel's bound and share of it, beside the previous designs' times. Then
   the coarse-init fit `inlier_fit` (the kernel of `csrc/inlier.cu`, all 100
   iterations in one launch of one thread-block cluster) against
   `inlier_reference` at the 20k pair's 20,480 NN matches, with its bound and
   its previous design's time.
6. Morpho main path: `align.morpho_align([fixed, moving])` on the benchmark's
   20,000-cell pair (`bench._make_slice_pair`, 50 genes, kl, SVI batch 2,000,
   200 iterations); warm-up on seed 1, seeds 2-4 timed; pairs per minute,
   stage times, peak memory; each E-step kernel launched 200 times per pair
   and the inlier kernel once; the rotation recovered.
7. Morpho CUDA vs CPU: one 2,000-cell pair aligned on the card (kernels) and
   on the CPU (plain dense E-step), same seed.
8. Jacobi kernel vs plain version: `jacobi_block` (the kernel of
   `csrc/jacobi.cu`) against `jacobi_block_reference` on the card at
   1024x1024, 2048x2048, 4096x4096 and 1000x1500, for 1, T - 1, T, T + 1,
   2T + 3, 100 and 2000 sweeps, and its fused relative change against
   `rel_change_reference`; CUDA-event times per sweep of both, in
   Mpixel-iters/s, beside the previous design's time and the bound.
9. Digitization main path: the JAX benchmark's PDE configuration (1024^2,
   isolines, 100,000 iterations in blocks of 2,000, best of 3 after a
   warm-up) and the atlas configuration (2048^2, Dirichlet stripes, max_err
   1e-6, 20,000 iterations) through `ops.stencil.jacobi_solve`; then
   `dd.digitize` and `dd.gridit` on a 2048x2048 quadrilateral domain with
   262,144 cells on a 4-pixel grid (20,000 iterations for each heat solve),
   stage by stage; then the labeling chain `label_cells_from_mask` on phase
   3's Starro mask. The launch counts prove the kernel ran, ceil(block / T)
   launches per block of each solve and one launch of the fused reduction.
10. Digitization CUDA vs CPU: a 256x256 solve (20,000 iterations), a
   digitize on a 128x128 domain and a labeling chain on a 256x256 mask,
   each on the card and on the CPU.
11. Morphofield main path: `bench.vfc_bench`'s sweep, cut nowhere
   (`SparseVFC_batch` on 4 fields of 100,000 3-D rotation points with
   N(0, 0.05) noise, M 100, 60 iterations, ecr 0, div/curl): warm-up on seed
   0, seeds 1-3 timed, points/s; the EM's host reads (at most
   ceil(60 / `CHECK_EVERY`) + 2); the JAX tests' rotation bars (mean curl
   within 0.3 of [0, 0, 2], mean |div| < 0.8). Then the stages of one sweep
   (control points, upload, beta, EM, div/curl, pull), the EM's device
   time, idle share and launches under the profiler beside its bound;
   `tdr.morphofield_sparsevfc_batch` on 4 AnnData of 100,000 cells; one
   100,000-cell field through `tdr.morphofield_sparsevfc`, the seven
   `morphofield_*` wrappers and `morphopath` (50 steps); `align.
   morpho_align_ref` on the 20,000-cell pair (2,000-cell references, 200
   iterations) and `BA_transform` of its 20,000 cells. No kernel of `csrc/`
   is on this path.
12. Morphofield CUDA vs CPU: `SparseVFC_batch` on 4 x 10,000 points (V within
   1e-3 of max|V|, div/curl within 1e-2, equal iterations) and
   `GPVectorField` Jacobians on 2,000 points, same seed on both.
13. The atlas chain through the port (`atlas_chain`, `bench.atlas_e2e`'s
   stages at 4 slices of 2,048², cut from the benchmark's 8 x 4,096²):
   Starro stream, labeling, `morpho_align` chain (SVI batch 2,000, 100
   iterations), `SparseVFC_batch` (M 100, 60 iterations), `jacobi_solve`
   and layer bins; per-stage seconds, cell-slices/min, peak memory, the last
   slice's median error against the truth (bar 10 px), and the launches of
   all five kernels in the timed stages (counters set to 0 after each
   stage's warm-up), held to the exact counts the chain must give; then the chain again under the profiler for
   each stage's device-busy share.
14. MuSIC main path. (a) `bench.music_bench`'s workload, cut nowhere: 4
   targets of 8,192 cells, K 12, poisson, 25 IRLS iterations, ridge 0, clip
   5, W from the coordinates on the card (untruncated gaussian, bandwidth
   1); warm-up, best and mean of 3 sweeps through the port's
   `_iwls_batch_kernel`; cells/s, peak memory, the sweep under the profiler
   (device busy, idle share, launches per IRLS iteration, ops by time)
   beside its bound; each target's coefficients recover the truth's sign
   (bar from the JAX package's CPU run). (b) `tl.MuSIC(...).fit()` on a
   10,000-cell `lr` slice (`music_slice`): bisquare adaptive weights, one
   target at 20 neighbours, two with the bandwidth search; seconds of
   `define_sig_inputs`, of each search and final fit, `mpi_fit` calls,
   bandwidths, peak memory; each target's driving pair has a positive mean
   coefficient on its receivers. No kernel of `csrc/` is on this path.
15. MuSIC CUDA vs CPU: `iwls_batch_full` at 2,000 cells, k 12, in the
   gaussian, poisson and nb families (1e-4 of scale); the conditioned
   weights, fixed and adaptive, with and without `exclude_self` (2e-3
   absolute, support flips <= 1e-4 of the nonzeros); `moran_i` on 2,000 x 20
   genes, 199 permutations (I within 1e-5, p-values equal except at ties
   within 1e-5); one `MuSIC.fit` on 250 cells at a fixed bandwidth.

16. The Starro tutorial through the port on `two_depth_tile(2048)`
   (`bench.make_raster(2048, 2048, seed=0)` with a second NB(1, 0.5)
   background on its right half), after a warm-up: `segment_densities`
   (binsize 32, k 5, dk 3, the knee), the staged `score_and_mask_pixels`
   (EM+BP with the bins: `bp_step` in f32, its delta read every iteration,
   counted), `find_peaks_from_mask`, `watershed`,
   `label_connected_components`, `expand_labels`; seconds per stage, bins,
   labels, safe_erode's host reads, peak memory; the mask's IoU with the
   planted disks (`planted_disks`). Then EM, EM+gauss, VI+BP and moran on
   the same tile and bins (each warmed up on a 512² corner),
   `mask_nuclei_from_stain` on a stain of the disks, the staged scoring and
   the VI fit under the profiler (idle share, launches, top device ops),
   `starro_em_bp_stream` of four 2048² tiles with `em_batch` 1 and
   4 (identical outputs; Mpixels/s; the EM's launches an iteration under
   the profiler), and a GEM round trip of a 512² tile (`read_bgi_agg`,
   segmentation, `read_bgi` to cells x genes).
17. The rest of Starro, card against CPU at 512² with two bins, a band
   outside them and a certain mask: `_score_pixels` for EM+BP, VI+BP (from
   one CPU fit) and EM (scores within 1e-3, Otsu masks IoU >= 0.999,
   `label_connected_components` equal), the VI fits on both (5e-2
   relative), `bp_kernel` on the binned phi (exact 0/1 outside the bins,
   f32, checked every iteration) bit for bit against the plain loop with
   the same iterations, and `safe_erode`'s bools.
18. SVG detection and PASTE (`cortex_section`: 20,000 cells jittered over a
   10,000 x 6,000 DNB domain, 4,000 genes, 60 planted in 6 bands). (a, b)
   `svg.smoothing_and_sampling` to 400 cells and `svg.svg_iden_reg` over
   all genes (geodesic, 8 neighbours, cutoffs 500 and 1,000): seconds per
   stage, genes/s of the scan, the planted genes' recall in the top 60 by
   z-score (bar from the port's CPU run), the scan alone under the profiler
   (idle share, launches, ops); (c) `cal_wass_dist_bs` over 60 planted +
   140 null genes, 30 rounds, rank p-values; (d) `cal_gro_wass_bs` between
   two sections' samples, 20 genes, 5 rounds (seconds to NaN: every solve
   ends NaN on a zero-count cell), and the same scan on the counts plus 1,
   2 rounds, where every solve runs to its stop (finite, positive, seconds
   a solve, outer iterations); (e) `align.paste_align_ref` on a section and
   its rotated, shifted copy with counts drawn anew and thinned, in units
   of 1,000 DNB (2,000-cell TRN references, 200 outer iterations): seconds
   a pair, FGW outer iterations, the rotation error (PASTE misses this
   rotation in both packages: held to within 1 deg of the port's CPU answer
   on the same pair), the first 20 outer iterations under the profiler; (f) `tdr.cell_directions` between the aligned
   references and `align.paste_center_align` on 3 x 1,000 cells at its
   defaults but 50 FGW outer iterations a solve of 200 (the time limit). No
   kernel of `csrc/` is on this path.
19. SVG and PASTE, card against CPU: the batched scan on 400 cells x 50
   genes (1e-4 relative, the same sweeps; cut from 200 genes, whose CPU
   scan took ~100 s); the between-slice scan's solves
   on 18d's samples plus 1, 4 of its genes x 2 rounds, on DNB costs cut to one
   outer iteration (3x the CPU's own spread when a cost matrix moves by
   one ulp) and 2 genes on the costs over their largest entry (1e-4 of
   scale, the same outer iterations); a 500-cell PASTE pair after 1 outer iteration (plan 1e-4 of
   scale, objective 1e-4) and after 50 (2e-3, the same iterations), and the
   center's KL NMF (W @ H 1e-6, the same iterations).

20. Rigid slice alignment, mesh correction and `st.pp` (`e95_stack`: an
   ellipsoid embryo of semi-axes 1.0, 0.5, 1.6 whose mesh is the convex hull
   of 10,000 surface points, ~20,000 faces, cut into 20 sections of 5,000
   cells, each shifted by up to 0.15 and rotated by up to 5 deg):
   `tl.align_slices_pca` of every section and `tl.procrustes` of one
   section onto its rotated, shifted copy (seconds, the residual against
   the planted transform); `align.Mesh_correction(label_num=15,
   fastpd_iter=100)` with its contours and **2 annealed steps of the
   default 10** (the time limit): seconds a step, ICPs/s, the shares of the
   cost tables, their section extraction and `fastpd`, one step under the
   profiler (idle share, launches), the best loss, and the residual drift
   after `perform_correction`, which must fall below the planted drift;
   `pp.normalize_total` and `pp.calcNormFactors(method="TMM")` on 20,000
   cells x 2,000 genes of sparse Poisson counts, `align.group_pca` of two
   5,000-cell sections (2,000 HVGs of 3,000 genes, 50 components); the
   k-means paths with no scikit-learn on the machine: `KMeans(500,
   n_init=10)` of 10,000 cells, `tl.MuSIC(spatial_subsample=True).fit` on
   them, and `align.morpho_align_ref(sampling_method="kmeans")` on the
   20,000-cell pair (2,000 k-means references). No kernel of `csrc/` is on
   this path.
21. The same, card against CPU on a small case (4 sections of 800 cells,
   L = 5, one step): the ten cost tables (at most 1% of entries may differ,
   where an ICP meets a degenerate covariance) and the `fastpd` labels, TMM
   factors (1e-12), the PCA up to column signs (1e-8 of scale), and both
   k-means' labels (equal) and centres (1e-8).

22. 3D reconstruction (`stt.tdr`) at full width: the cells of phase 20's
   stack with no drift (20 x 5,000 = 100,000 cells, `tdr.construct_pc`)
   and 100,000 points on the ellipsoid's surface. `construct_surface(
   cs_method="poisson", max_resolution=128)` with estimated normals: res,
   CG iterations and host reads, ms of the splat + solve (CUDA events), of
   marching tetrahedra and of the normals, the solve's idle share under the
   profiler; the mesh's volume within 1% of 4/3 pi 0.8, and the splat equal
   bit for bit on two runs. The alpha shape and `voxelize_mesh` (host) on a
   **20,000-cell subsample** (a cut: host scipy). `construct_backbone` by
   ElPiGraph at 50 nodes on the 100,000 cells (seconds, growth steps,
   candidate fits, host reads, mean cell-to-node distance), and the port's
   CPU path against the card at 20,000 cells x 10 nodes (edges equal);
   SimplePPT and PrinCurve (500 epochs; ms an Adam epoch);
   `model_morphology`, `pc_KDE` of the 100,000 cells, a SparseVFC field of
   the cloud and `construct_field_streams` (100 x 100),
   `pairwise_shape_similarity`. No kernel of `csrc/` is on this path.
23. The same, card against CPU at a small size: Poisson at res 32 on 5,000
   points (chi and rho 1e-5 of scale, CG iterations within 1, meshes within
   a Chamfer distance of 1e-3 of a cell), ElPiGraph on 5,000 cells x 15
   nodes (edges equal, nodes 1e-9), SimplePPT (nodes 1e-4 of scale) and
   NLPCA after 100 epochs (weights 1e-4) in float32, `pc_KDE` (1e-10
   relative).

24. MuSIC's interpretation, `refine_alignment` and the Frobenius center NMF
   at full width. `music_slice(10,000)` with `music_tf_slice`'s genes (STAT3
   and MYC tracking the ligands TGFB1 and DLL1, JUN unrelated, GAPDH), fitted
   for TGT1 at 20 neighbours; `tl.MuSIC_Interpreter` around the fit's output
   directory: `compute_coeff_significance`, `get_effect_potential` of TGT1's
   planted pair (senders send more), `CCI_deg_detection_setup` and
   `CCI_deg_detection(fit_all=True)` on the TFs (the tracked TF is the
   significant one of largest coefficient, one set of weights a design),
   `permutation_test` of TGT1 at 40 permutations (its default 100, cut for the
   time limit; fits/s; by
   `eval_permutation_test` the fit's Pearson correlation with TGT1 beats
   every permutation's, t-test p <= 0.05), `tl.MuSIC_Molecule_Selector.
   find_targets` (TGT1-3 found, GAPDH dropped). `cs.refine_alignment`,
   rigid then non-rigid, 100 epochs each, on a 4,096² pair from
   `planted_disks(4096)`, the stain moved by a planted 0.3 deg and (3, -2)
   px: at its own Adam lr of 0.1 (the JAX package's) theta is reported; the
   refiners through their own API at lr 1e-3, where the planted transform is
   recovered within 1 px. `FrobeniusNMF(15)` of a 1,000-cell x 4,000-gene
   section (`cortex_section`). Each stage's seconds, and its idle share and
   launches under the profiler. No kernel of `csrc/` is on this path.
25. The same, card against CPU at a small size: the CCI DEG table of 600
   cells (1e-4 of scale), 20 permutations (the same scrambles, effects 1e-4,
   comparisons flipped only at ties), the affine warp at 256² (1e-5), 100
   epochs on smooth blobs (theta 1e-2, displacements 1e-5), the Frobenius
   NMF of 300 x 200 (W and H 1e-8, the same iterations).

26. Interpolation, clustering and embedding at full width. (a) The E9.5
   cloud's 100,000 cells (`e95_cloud`) with 50 genes planted as smooth
   functions of position plus N(0, 0.1) noise (`interp_source`),
   interpolated onto ~200,000 grid points inside the ellipsoid
   (`ellipsoid_grid`): `tdr.vtk_interpolation` (Shepard, the default
   radius), `tdr.gp_interpolation` at the JAX defaults (512 inducing
   points, 50 Adam steps) on 10 genes, `tdr.deep_intepretation` at its
   defaults (hidden 256, depth 4, batch 4,096, 1,000 steps) on all 50: each
   engine's seconds, idle share and launches (under the profiler, a shorter
   window), peak memory, and mean error against the planted field (bars
   `INTERP_ERR_BAR`). (b) `cortex_section(20,000 cells, 4,000 genes, 6
   planted bands)` after `normalize_total`, log1p and `pca(30)`
   (`cluster_section`): `tl.neighbors` (expression 30, spatial 6),
   `tl.scc` (Louvain, its host seconds), `tl.mclust_py(6)`,
   `tl.kmeans_clustering(6)`, `tl.spagcn_pyg(6)`,
   `tl.perform_dimensionality_reduction("umap")` (200 epochs),
   `tl.cellbin_morani` of the bands and `tl.find_cci_two_group` between
   bands 0 and 1 at 1,000 permutations with a planted ligand-receptor pair:
   each stage's seconds, idle share, launches and peak memory, the ARI of
   each clustering against the bands, UMAP's 15-NN preservation, the bands'
   Moran's I, the pair's p-value and permutations/s (bars from the port's
   CPU run, `scripts/interp_cluster_bars.py`). Then `tdr.backbone_scc` of
   20,000 of the cloud's cells along phase 22's backbone (built here when
   phase 22 did not run). No kernel of `csrc/` is on this path.
27. The same, card against CPU at 2,000 cells (`interp_cluster_cuda_vs_cpu`,
   bars `CVC_*`): the three kernels' VTK fields, the SGPR's and the SIREN's
   first 10 Adam steps from one start, SpaGCN's length scale and GC-DEC's
   q, the GMM, UMAP after 3 epochs from one init and negatives and after
   all (15-NN preservation), the CCI null scores.

28. The external models at full width, each stage after a warm-up at a
   small size, with its seconds, idle share and launches (under the
   profiler, a shorter window) and peak GB. (a) CAST on two
   `cortex_section(20,000, 4,000)`s, the query from seed 1 (expression seed
   0) rotated by 10 deg and shifted by (300, -200) DNB, both through
   normalize_total and log1p into norm_1e4: `cast_mark` at the JAX defaults
   (k 10, 256 -> 64, 200 epochs, PCA 50) on both sections in one model,
   CAST_STACK at `reg_params`' defaults (500 affine, 400 FFD iterations at
   mesh 8, ``rescale=True``) with the median distance of the aligned query
   to its planted positions and across the bands (which vary in y only),
   each beside the unaligned one, CAST_PROJECT onto the reference by a joint
   PCA with the share of cells projected into their own band; (b) STAGATE on
   `cortex_section(3,639, 3,000)`: `Cal_Spatial_Net` (Radius, ~6 neighbours a
   spot), `train_STAGATE` at its defaults, `mclust_R(EEE)` at the 6 bands
   (ARI), then `tl.pySTAGATE(...).train()` (100 epochs); (c) MERFISHVI at its
   defaults on 50,000 x 500 and with the spatial encoder on 10,000 cells:
   the loss at the first and last epoch and the latent's k-means ARI. Then
   `tl.CAST` on (a)'s reference section. No kernel of `csrc/` is on this
   path.
29. The same, card against CPU at 1,000 cells (`external_cuda_vs_cpu`, bars
   `EXT_CVC_BAR`): CAST-Mark's, STAGATE's and merfishVI's (spatial encoder)
   first 10 Adam steps from one init and one set of draws, a CAST-Stack pair
   (affine 50 iterations, FFD 20, the card's FFD mesh the same bits on a
   second run, the points whose cost differs at the same coordinates), the
   projection (index flips, weights).

`python3 chip_smoke.py --phases 20,21` runs the chosen phases besides 0-2, 5
and 8 (the environment, the build, and the kernels' checks against their
plain versions that the kernels line reports); the launches of a main path
not run are 0 there. With no arguments every phase runs.

The last three lines are the card line from nvidia-smi, a JSON line with
each kernel's launches, error, times, bound (`bound_ms`, `bound_by`: the
larger of its operations at the f32 peak and its bytes at the memory rate of
an H100 SXM at 700 W) and share of the bound (for `jacobi_block`: the
largest error of phase 8, and ms per sweep at 1024x1024), and the ``ok``
JSON line.
"""

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

BP_P, BP_Q = 0.6, 0.4
TILE = 2048
#: H100 SXM peaks at 700 W (NVIDIA's data sheet): f32 outside the tensor
#: cores, and HBM3 bandwidth. The bounds below are against these.
F32_FLOPS, HBM_BYTES_PER_S = 67e12, 3.35e12
#: The previous designs' times on an H100 80GB HBM3 at 700 W (PERF.md's
#: table; the designs are kept in scripts/baseline/), printed beside the
#: redesigned kernels'. `inlier`'s is `inlier_fit` with its prologue.
PREV_ROWRED_MS, PREV_JACOBI_US = 0.46824, {1024: 2.473, 2048: 7.153}
PREV_COLNORM_MS = {"20000x2000": 0.33308, "100000x10000": 1.98765}
PREV_INLIER_MS = 3.7473
PREV_BP_MS = {torch.float32: 0.09278, torch.bfloat16: 0.07504}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def cuda_ms(fn, n=20):
    """Mean device time of `fn` over `n` back-to-back calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def bound(flops, nbytes):
    """The least time (ms) the card could take for `flops` operations and
    `nbytes` bytes, and which of the two sets it."""
    t_ops, t_bytes = flops / F32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=t_ops, bound_by="operations") if t_ops >= t_bytes else dict(bound_ms=t_bytes,
                                                                                       bound_by="bytes")


def with_bound(stats, b):
    """A kernel's JSON entry: its stats, its bound and its share of it."""
    return dict(stats, **b, share_of_bound=b["bound_ms"] / stats["ms"], library_ms=None)


def host_ms(fn):
    """Host time of `fn` run to completion on the card, and its result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def iou(a, b):
    a, b = np.asarray(a, bool), np.asarray(b, bool)
    return float(np.logical_and(a, b).sum() / max(np.logical_or(a, b).sum(), 1))


def phase_kernel_vs_plain(bp_cuda):
    """Phase 2. Returns the 2048^2 bf16 step's error and times (ms)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    tol_marg = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
    result = {}
    for H, W in ((TILE, TILE), (1000, 1500)):
        phi = torch.rand((2, H, W), generator=gen, device="cuda") + 0.05
        phi = (phi / phi.sum(0, keepdim=True)).contiguous()
        M32 = torch.rand((4, H, W), generator=gen, device="cuda") * 0.96 + 0.02
        for dt in (torch.float32, torch.bfloat16):
            M = M32.to(dt)
            before = bp_cuda.bp_step.launches
            out_k = bp_cuda.bp_step(phi, M, BP_P, BP_Q)
            torch.cuda.synchronize()
            check(bp_cuda.bp_step.launches == before + 1, "bp_step did not count its launch")
            out_r = bp_cuda.bp_step_reference(phi, M, BP_P, BP_Q)
            check(out_k.dtype == dt and out_k.shape == (4, H, W), f"bp_step output {out_k.dtype} {tuple(out_k.shape)}")
            err = float((out_k.float() - out_r.float()).abs().max())
            edges = torch.cat([out_k[0, -1], out_k[1, 0], out_k[2, :, -1], out_k[3, :, 0]]).float()
            check(bool((edges == 0.5).all()), f"edge planes not 0.5 at {H}x{W} {dt}")
            # the same f32 operations in the same order: equal bits expected
            exact = bool(torch.equal(out_k, out_r))
            check(exact, f"bp_step vs plain at {H}x{W} {dt}: not bit-identical, max_abs_err {err}")
            print(f"phase 2: bp_step {H}x{W} {dt}: max_abs_err={err!r}, bit-identical={exact}")

            # full loops: the kernel on the card against the plain loop on the CPU
            phi_hw = phi.permute(1, 2, 0).contiguous()
            msg = "float32" if dt == torch.float32 else "bfloat16"
            marg_k = bp_cuda.bp_kernel(phi_hw, BP_P, BP_Q, 1e-6, 50, check_every=10, msg_dtype=msg)
            marg_r = bp_cuda.bp_kernel(phi_hw.cpu(), BP_P, BP_Q, 1e-6, 50, check_every=10, msg_dtype=msg)
            merr = float((marg_k.cpu() - marg_r).abs().max())
            check(merr <= tol_marg[dt], f"bp_kernel marginals at {H}x{W} {dt}: {merr} > {tol_marg[dt]}")
            print(f"phase 2: bp_kernel 50 it {H}x{W} {msg}: marginal max_abs_err={merr!r} (tol {tol_marg[dt]})")

            if H == TILE:
                ms_k = cuda_ms(lambda: bp_cuda.bp_step(phi, M, BP_P, BP_Q))
                ms_r = cuda_ms(lambda: bp_cuda.bp_step_reference(phi, M, BP_P, BP_Q))
                gbytes = (2 * 4 + 8 * M.element_size()) * H * W / 1e9
                print(
                    f"phase 2: per-iteration time {H}x{W} {msg}: kernel {ms_k!r} ms "
                    f"({gbytes / ms_k * 1e3!r} GB/s), plain {ms_r!r} ms"
                )
                # each input read once, each output written once; ~40 flops a pixel
                b = bound(40 * H * W, gbytes * 1e9)
                print(f"phase 2: bp_step {H}x{W} {msg}: bound {b['bound_ms']!r} ms ({b['bound_by']}), share of "
                      f"the bound {b['bound_ms'] / ms_k!r}; previous design {PREV_BP_MS[dt]} ms")
                # the fused delta: bar 1e-5 relative, f64 sums in the
                # kernel's order against the plain version's f32 sum
                before = bp_cuda.bp_step.delta_launches
                out_d, d = bp_cuda.bp_step(phi, M, BP_P, BP_Q, delta=True)
                torch.cuda.synchronize()
                check(bp_cuda.bp_step.delta_launches == before + 1, "bp_step did not count its delta launch")
                check(torch.equal(out_d, out_k), f"bp_step(delta=True) messages differ at {H}x{W} {dt}")
                d_r = float(bp_cuda.delta_reference(out_d, M))
                rel = abs(float(d) - d_r) / d_r
                same = bool(torch.equal(bp_cuda.bp_step(phi, M, BP_P, BP_Q, delta=True)[1], d))
                check(rel <= 1e-5 and same, f"fused delta {float(d)!r} vs plain {d_r!r} ({rel}), same bits {same}")
                ms_d = cuda_ms(lambda: bp_cuda.bp_step(phi, M, BP_P, BP_Q, delta=True))
                print(f"phase 2: fused delta {H}x{W} {msg}: {float(d)!r} vs plain {d_r!r} (relative difference "
                      f"{rel!r}, bar 1e-5), same bits twice {same}; launch with the delta {ms_d!r} ms, without "
                      f"{ms_k!r} ms")
                if dt == torch.bfloat16:
                    result = with_bound(dict(max_abs_err=err, ms=ms_k, plain_ms=ms_r, delta_rel_err=rel,
                                             delta_ms=ms_d), b)
    return result


def phase_stages(X, ts, em, bp_cuda, report):
    """Phase 3a: one tile stage by stage, synchronised between stages."""
    stages = {}
    t, dev = host_ms(lambda: ts._upload(X, "cuda"))
    stages["upload"] = t
    n_samples = ts._n_samples(X.size, 0.001)
    t, (res, samp, w0, mu0, var0, _) = host_ms(lambda: ts._starro_density_init_sample(dev, 5, n_samples, seed=0))
    stages["density_init_sample"] = t
    stats = {}
    ones = torch.ones((1, n_samples), dtype=torch.bool, device="cuda")
    t, (w, r, p) = host_ms(
        lambda: em._nbn_em_batched(samp[None], ones, w0[None], mu0[None], var0[None], 2000, 1e-6, stats=stats)
    )
    stages["em"] = t
    t, phi = host_ms(lambda: ts._starro_conditionals(res, r[0], p[0]))
    stages["conditionals"] = t
    before = (bp_cuda.bp_step.launches, bp_cuda.bp_step.delta_launches)
    t, scores = host_ms(lambda: bp_cuda.bp_kernel(phi, BP_P, BP_Q, 1e-6, 50, check_every=10, msg_dtype="bfloat16"))
    stages["bp"] = t
    bp_iters = bp_cuda.bp_step.launches - before[0]
    bp_checks = bp_cuda.bp_step.delta_launches - before[1]
    t, mask = host_ms(lambda: ts._starro_threshold_mask(scores, 7))
    stages["threshold_morphology"] = t
    if report:
        print(
            "phase 3: stages of one 2048x2048 tile (ms, host clock, synchronised): "
            + ", ".join(f"{k}={v!r}" for k, v in stages.items())
            + f"; EM iterations={stats['n_iter']}, BP iterations={bp_iters} with {bp_checks} fused delta "
            f"checks, total={sum(stages.values())!r}"
        )
    return bp_iters, mask.cpu().numpy()


ESTEP_KEYS = ("K_NA", "K_NA_spatial", "K_NA_sigma2", "K_NB", "Sp", "sigma2_related", "PXB", "M1")


def scaled_err(ref, out):
    return float((out.float() - ref.float()).abs().max() / (ref.float().abs().max() + 1e-30))


def estep_case(NA, B, sigma2, seed):
    """E-step inputs as the solver builds them: both slices normalised
    together, the moving slice's rows and the batch Morton-ordered, kl
    factors of 50 Poisson genes (G' = 51), the probability parameter from
    the solver's order statistic."""
    from bench import _make_slice_pair
    from spateo_tpu_torch.alignment.methods import math as tm

    pts, ptsA, X = _make_slice_pair(NA, seed=seed)
    rng = np.random.default_rng(seed)
    bidx = rng.choice(NA, B, replace=False)
    (cA, cB), _, _ = tm.normalize_coords([ptsA, pts])
    oA = np.argsort(tm.morton_code(cA), kind="stable")
    bidx = bidx[np.argsort(tm.morton_code(cB)[bidx], kind="stable")]
    T = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to("cuda")
    XA, XB = T(X[oA]), T(X[bidx])
    a, b, A, Bf = tm.factorize_distance(XA, XB, "kl")
    p = torch.clamp_min(tm.min_dist_order_stat(XA[:20000], XB, int(min(NA, 20000) * 0.05)) / 5, 0.01)
    s = lambda v: torch.tensor(v, dtype=torch.float32, device="cuda")
    mm = T(rng.uniform(0.5, 1.0, NA).astype(np.float32))
    coordsA = T(cA[oA])
    return (coordsA, coordsA, T(cB[bidx]), a, b, A, Bf, mm, s(sigma2), s(0.5), s(11.0), s(2.0), p)


def tile_compute_share(xa, cb, sigma2, skip):
    """Share of 64 x 64 tiles the kernels compute: not flagged by the bbox
    mask and with some pair at d < 80 sigma2 (the kernels' own test)."""
    from spateo_tpu_torch.ops import estep_cuda as ec

    NA, B = xa.shape[0], cb.shape[0]
    n_ta, n_tb = -(-NA // ec.TM), -(-B // ec.TN)
    cbp = torch.cat([cb, torch.full((n_tb * ec.TN - B, 2), 1e6, device=cb.device)])
    xap = torch.cat([xa, torch.full((n_ta * ec.TM - NA, 2), -1e6, device=xa.device)])
    live = torch.empty((n_ta, n_tb), dtype=torch.bool, device=xa.device)
    step = 64
    for i in range(0, n_ta, step):
        rows = xap[i * ec.TM:(i + step) * ec.TM]
        d = (rows[:, None, :] - cbp[None, :, :]).pow(2).sum(-1)
        live[i:i + step] = d.reshape(-1, ec.TM, n_tb, ec.TN).amin((1, 3)) < ec._SKIP_MULT * sigma2
    live &= skip.reshape(n_ta, n_tb) == 0
    return float(live.float().mean())


def phase_estep_kernels():
    """Phase 5. Returns each E-step kernel's error and times at 20k x 2k."""
    from spateo_tpu_torch.ops import estep_cuda as ec

    # scaled-error bars: 1e-4 at sigma2 >= 0.05; 2e-3 at the solver's floor
    # 1e-3, where one ulp of |a|^2 in the distance expansion moves
    # exp(-d s2v / (2 sigma2)) by ~1e-4 relative and the kernel and the plain
    # version round the expansion differently
    cases = (("20000x2000", 20000, 2000, 0.05, 1, 1e-4), ("100000x10000", 100000, 10000, 1e-3, 2, 2e-3),
             ("1000x333", 1000, 333, 0.05, 3, 1e-4))
    result = {}
    for name, NA, B, sigma2, seed, tol in cases:
        args = estep_case(NA, B, sigma2, seed)
        xa, cb, fat, fbt, bt, mm, scal, skip = ec.prepare(*args[:1], *args[2:])
        before = (ec.colnorm.launches, ec.rowred.launches)
        col_k = ec.colnorm(xa, cb, fat, fbt, bt, mm, scal, skip)
        torch.cuda.synchronize()
        check((ec.colnorm.launches, ec.rowred.launches) == (before[0] + 1, before[1]), "colnorm did not count")
        col_r = ec.colnorm_reference(xa, cb, fat, fbt, bt, mm, scal)
        row_k = ec.rowred(xa, cb, fat, fbt, bt, col_r, scal, skip)
        torch.cuda.synchronize()
        check(ec.rowred.launches == before[1] + 1, "rowred did not count")
        row_r = ec.rowred_reference(xa, cb, fat, fbt, bt, col_r, scal)
        col_errs = [scaled_err(col_r[q], col_k[q]) for q in range(5)]
        row_errs = [scaled_err(row_r[q], row_k[q]) for q in range(6)]
        check(max(col_errs) <= tol, f"colnorm vs plain at {name}: {col_errs} > {tol}")
        check(max(row_errs) <= tol, f"rowred vs plain at {name}: {row_errs} > {tol}")
        out_k, out_r = ec.estep_cuda(*args), ec.estep_reference(*args)
        whole = {k: scaled_err(out_r[k], out_k[k]) for k in ESTEP_KEYS}
        check(all(bool(torch.isfinite(out_k[k]).all()) for k in ESTEP_KEYS), f"estep_cuda not finite at {name}")
        check(max(whole.values()) <= tol, f"estep_cuda vs estep_reference at {name}: {whole} > {tol}")
        again = ec.estep_cuda(*args)
        same = all(torch.equal(again[k], out_k[k]) for k in ESTEP_KEYS)
        check(same, f"estep_cuda is not deterministic at {name}")
        knb_err = float((col_k[4] - col_r[4]).abs().max())
        kna_err = float((row_k[0] - row_r[0]).abs().max())
        col_abs = float((col_k - col_r).abs().max())
        row_abs = float((row_k - row_r).abs().max())
        print(
            f"phase 5: E-step {name}, sigma2 {sigma2}: colnorm scaled errs {col_errs!r}, rowred scaled errs "
            f"{row_errs!r} (tol {tol}); estep_cuda vs estep_reference {json.dumps(whole)}; same bits twice {same}; "
            f"max_abs_err over the outputs: colnorm {col_abs!r}, rowred {row_abs!r}; K_NB {knb_err!r}, row sums of "
            f"P3 {kna_err!r}"
        )
        if name == "1000x333":
            continue
        bbox_share = float(skip.float().mean())
        live = tile_compute_share(xa, cb, float(args[8]), skip)
        n = 20 if NA <= 20000 else 5
        t = dict(
            colnorm=cuda_ms(lambda: ec.colnorm(xa, cb, fat, fbt, bt, mm, scal, skip), n),
            colnorm_plain=cuda_ms(lambda: ec.colnorm_reference(xa, cb, fat, fbt, bt, mm, scal), n),
            rowred=cuda_ms(lambda: ec.rowred(xa, cb, fat, fbt, bt, col_r, scal, skip), n),
            rowred_plain=cuda_ms(lambda: ec.rowred_reference(xa, cb, fat, fbt, bt, col_r, scal), n),
            estep_cuda=cuda_ms(lambda: ec.estep_cuda(*args), n),
            estep_reference=cuda_ms(lambda: ec.estep_reference(*args), n),
        )
        bounds = estep_bounds(NA, B, fat.shape[0], live)
        print(
            f"phase 5: E-step {name} times (ms, CUDA events): " + ", ".join(f"{k}={v!r}" for k, v in t.items())
            + f"; tiles flagged by the bbox mask {bbox_share!r}, tiles computed {live!r}"
        )
        splits = ec.colnorm_splits(NA, B)
        busiest = max(len(tiles) for per in ec.colnorm_assignment(skip, NA, B, splits) for tiles in per)
        print(f"phase 5: E-step {name} colnorm: {splits} blocks per column tile, the busiest computes {busiest} "
              f"live row tiles")
        prev = dict(colnorm=PREV_COLNORM_MS.get(name), rowred=PREV_ROWRED_MS if name == "20000x2000" else None)
        for k in ("colnorm", "rowred"):
            b = bounds[k]
            print(f"phase 5: E-step {name} {k}: {t[k]!r} ms, bound {b['bound_ms']!r} ms ({b['bound_by']}, the pairs "
                  f"of the tiles computed), share of the bound {b['bound_ms'] / t[k]!r}"
                  + (f"; previous design {prev[k]} ms" if prev[k] else ""))
        if name == "20000x2000":
            result = dict(
                colnorm=with_bound(dict(max_abs_err=col_abs, ms=t["colnorm"], plain_ms=t["colnorm_plain"]),
                                   bounds["colnorm"]),
                rowred=with_bound(dict(max_abs_err=row_abs, ms=t["rowred"], plain_ms=t["rowred_plain"]),
                                  bounds["rowred"]),
            )
    return result


def estep_bounds(NA, B, G1, live):
    """Each E-step sweep's bound on the pairs of the tiles it computes:
    sweep 1 ~(2 G1 + 19) flops a pair (the expression dot, the distance, 3
    exp, the scalings and 4 column sums), sweep 2 ~(2 G1 + 27) (6 row sums);
    bytes: each input read once, each output written once."""
    pairs = live * NA * B
    n_tiles = -(-NA // 64) * -(-B // 64)
    shared = 4 * (2 * NA + 2 * B + G1 * NA + G1 * B + B) + n_tiles  # xa, cb, fat, fbt, bt, skip
    return dict(colnorm=bound((2 * G1 + 19) * pairs, shared + 4 * NA + 4 * 5 * B),  # mm; [5, B]
                rowred=bound((2 * G1 + 27) * pairs, shared + 4 * 5 * B + 4 * 6 * NA))  # colstats; [6, NA]


def inlier_case(n, N):
    """NN matches of a planted rigid motion (0.4 rad, shift (1, -2)), a
    third of the n valid rows outliers, rows past n padding copies of row 0:
    the fit's arguments on the card and the planted rotation."""
    rng = np.random.default_rng(0)
    th = 0.4
    R_true = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]], np.float32)
    tx = rng.uniform(0, 5, (N, 2)).astype(np.float32)
    ty = (tx @ R_true.T + np.array([1.0, -2.0], np.float32)).astype(np.float32)
    ty[: n // 3] += rng.normal(0, 2.0, (n // 3, 2)).astype(np.float32)
    dist = rng.uniform(0, 3, (N, 1)).astype(np.float32)
    tx[n:], ty[n:], dist[n:] = tx[0], ty[0], dist[0]
    mask = np.zeros((N, 1), np.float32)
    mask[:n] = 1.0
    T = lambda x: torch.from_numpy(x).to("cuda")
    return (T(tx), T(ty), T(dist), T(mask), float(n)), R_true


def phase_inlier_kernel():
    """Phase 5, the coarse fit: the kernel against the plain loop at the
    row count the 20k pair gives it (two voxel sets of 1,024 rows, 10
    matches each way). Returns its error and times."""
    from spateo_tpu_torch.ops import inlier_cuda

    N = 20480
    args, R_true = inlier_case(20000, N)
    before = inlier_cuda.inlier_fit.launches
    P, R, t, w, s2, g = inlier_cuda.inlier_fit(*args)
    torch.cuda.synchronize()
    check(inlier_cuda.inlier_fit.launches == before + 1, "inlier_fit did not count its launch")
    Pr, Rr, tr, wr, s2r, gr = inlier_cuda.inlier_reference(*args)
    errs = dict(R=float((R - Rr).abs().max()), t=float((t - tr).abs().max()), P=float((P - Pr).abs().max()),
                weight0=float((w - wr).abs().max()), sigma2_rel=abs(float(s2) - float(s2r)) / max(float(s2r), 1e-3),
                gamma=abs(float(g) - float(gr)))
    # the bars tests/test_ops.py:319-324 hold the TPU kernel to
    bars = dict(R=2e-5, t=2e-4, P=1e-3, weight0=1e-5, sigma2_rel=1e-3, gamma=1e-3)
    check(all(errs[k] <= bars[k] for k in bars), f"inlier_fit vs plain: {errs} (bars {bars})")
    check(float(np.abs(R.cpu().numpy() - R_true).max()) < 0.05, "inlier_fit did not recover the rotation")
    prep = inlier_cuda.kernel_inputs(*args)[:5]
    ms_k = cuda_ms(lambda: inlier_cuda.launch(*prep), 10)  # the kernel alone
    ms_w = cuda_ms(lambda: inlier_cuda.inlier_fit(*args), 10)  # with its PyTorch prologue
    ms_r = cuda_ms(lambda: inlier_cuda.inlier_reference(*args), 3)
    # ~45 flops a row per iteration; rows read once (tx, ty, dist, mask), P and weights written once
    b = bound(45 * N * 100, N * (8 + 8 + 4 + 4 + 4 + 4))
    again = inlier_cuda.inlier_fit(*args)
    same = torch.equal(again[0], P) and torch.equal(again[1], R)
    check(same, "inlier_fit is not deterministic")
    print(f"phase 5: inlier_fit {N} rows, 100 iterations: errors {json.dumps(errs)} (bars {json.dumps(bars)}); "
          f"same bits twice {same}; launch (cluster, threads, rows a thread) {inlier_cuda.inlier_layout(N)[:3]}; "
          f"kernel {ms_k!r} ms, `inlier_fit` with its prologue {ms_w!r} ms (previous design's {PREV_INLIER_MS} ms), "
          f"plain loop {ms_r!r} ms (CUDA events); bound "
          f"{b['bound_ms']!r} ms ({b['bound_by']}; 3 x 100 + 2 dependent cluster reductions), share of the bound "
          f"{b['bound_ms'] / ms_k!r}")
    return with_bound(dict(max_abs_err=errs["P"], ms=ms_k, plain_ms=ms_r), b)


def phase_morpho_main():
    """Phase 6. Returns each E-step kernel's launches over the timed pairs."""
    import bench
    import spateo_tpu_torch as stt
    from spateo_tpu_torch.alignment.methods import morpho as tmorpho
    from spateo_tpu_torch.ops import estep_cuda as ec
    from spateo_tpu_torch.ops import inlier_cuda

    runs = []
    real_run = tmorpho.Morpho_pairwise.run

    def run_and_record(self):
        out = real_run(self)
        runs.append(self)
        return out

    tmorpho.Morpho_pairwise.run = run_and_record
    try:
        pairs = {s: bench._make_slice_pair(20000, seed=s) for s in (1, 2, 3, 4)}

        def align(s):
            pts, ptsA, X = pairs[s]
            fixed, moving = bench._mk_adata(stt, pts, X), bench._mk_adata(stt, ptsA, X)
            return stt.align.morpho_align([fixed, moving], spatial_key="spatial", key_added="align", max_iter=200,
                                          verbose=False)

        align(1)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        ec.colnorm.launches = ec.rowred.launches = inlier_cuda.inlier_fit.launches = 0
        times, per_pair = [], []
        for s in (2, 3, 4):
            before = (ec.colnorm.launches, ec.rowred.launches, inlier_cuda.inlier_fit.launches)
            t, (out, pis) = host_ms(lambda: align(s))
            times.append(t)
            per_pair.append((ec.colnorm.launches - before[0], ec.rowred.launches - before[1],
                             inlier_cuda.inlier_fit.launches - before[2]))
            pts = pairs[s][0]
            aligned = out[1].obsm["align"]
            rms = float(np.sqrt(((aligned - pts) ** 2).sum(1).mean()))
            check(aligned.shape == pts.shape and bool(np.isfinite(aligned).all()), "aligned coordinates")
            check(rms < 0.1, f"seed {s}: rigid result RMS {rms} >= 0.1 (1% of the 10-unit box)")
            n = len(pts)
            check(tuple(pis[0].shape) == (min(max(n // 10, 1000), n), n) and bool(torch.isfinite(pis[0]).all()),
                  f"assignment P.T {tuple(pis[0].shape)}")
            R = out[1].uns["VecFld_morpho"]
            print(f"phase 6: seed {s}: {t!r} ms, RMS to the truth {rms!r}, optimal_R {R['optimal_R'].tolist()}, "
                  f"sigma2 {R['sigma2']!r}, gamma {R['gamma']!r}")
        launches = dict(colnorm=ec.colnorm.launches, rowred=ec.rowred.launches,
                        inlier=inlier_cuda.inlier_fit.launches)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        tmorpho.Morpho_pairwise.run = real_run
    check(all(pp == (200, 200, 1) for pp in per_pair),
          f"kernel launches per pair (colnorm, rowred, inlier) {per_pair}, expected (200, 200, 1)")
    check(launches == dict(colnorm=600, rowred=600, inlier=3), f"Morpho launches in the main path {launches}")
    marks = ("start", "initp_done", "sigma2_samples_done", "U_guidance_done", "factorize_done", "preem_done",
             "em_dispatched", "pull_done", "P_done")
    names = ("coarse_init", "prob_params_sigma2", "U", "factorise", "pre_em", "em", "pull", "P")
    for m in runs[1:]:
        pt = m._phase_times
        stages = {n: (pt[b] - pt[a]) * 1e3 for n, a, b in zip(names, marks[:-1], marks[1:])}
        print("phase 6: stages of one pair (ms, synchronised): " + ", ".join(f"{k}={v!r}" for k, v in stages.items()))
    best = min(times)
    print(f"phase 6: morpho_align 20000-cell pair: {times!r} ms; {60e3 / best!r} pairs/min (best of 3), "
          f"{60e3 * 3 / sum(times)!r} pairs/min (mean); peak device memory {peak_gb!r} GB; "
          f"kernel launches per pair (colnorm, rowred, inlier) {per_pair}, in the main path {launches}")
    return launches


def phase_morpho_cuda_vs_cpu():
    """Phase 7: one 2,000-cell pair on the card and on the CPU."""
    import bench
    import spateo_tpu_torch as stt

    pts, ptsA, X = bench._make_slice_pair(2000, seed=7)
    res = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        out, _ = stt.align.morpho_align([bench._mk_adata(stt, pts, X), bench._mk_adata(stt, ptsA, X)],
                                        spatial_key="spatial", key_added="align", max_iter=200, verbose=False,
                                        device=dev)
        res[dev] = (out[1], time.perf_counter() - t0)
    (g, tg), (c, tc) = res["cuda"], res["cpu"]
    r_err = float(np.abs(g.uns["VecFld_morpho"]["optimal_R"] - c.uns["VecFld_morpho"]["optimal_R"]).max())
    x_err = float(np.abs(g.obsm["align"] - c.obsm["align"]).max())
    nr_err = float(np.abs(g.obsm["align_nonrigid"] - c.obsm["align_nonrigid"]).max())
    # bars: rotations 1e-3, coordinates 1e-2 on the 10-unit box (0.1%): the
    # card's kernels and the CPU's dense E-step sum in other orders over
    # 200 iterations
    check(r_err <= 1e-3, f"CUDA vs CPU optimal_R differs by {r_err}")
    check(x_err <= 1e-2 and nr_err <= 1e-2, f"CUDA vs CPU aligned coordinates differ by {x_err} / {nr_err}")
    print(f"phase 7: 2000-cell pair, CUDA (kernels) vs CPU (plain): optimal_R max_abs_err {r_err!r}, rigid coords "
          f"max_abs_err {x_err!r}, non-rigid coords max_abs_err {nr_err!r}; {tg!r} s on the card, {tc!r} s on the CPU")


def jacobi_case(H, W, seed=0):
    """A random field in [0, 100) and the solver's moving set: the interior
    window minus 1% scattered Dirichlet pixels."""
    rng = np.random.default_rng(seed)
    f = torch.from_numpy(rng.uniform(0, 100, (H, W)).astype(np.float32)).to("cuda")
    upd = torch.zeros((H, W), dtype=torch.uint8, device="cuda")
    upd[1:-1, 1:-1] = 1
    upd[torch.from_numpy(rng.uniform(size=(H, W)) < 0.01).to("cuda")] = 0
    return f, upd


def phase_jacobi_kernel():
    """Phase 8. Returns the kernel's error, and its and the plain version's
    time per sweep (ms) at 1024^2, the PDE benchmark's raster, with its
    bound."""
    from spateo_tpu_torch.ops import jacobi_cuda as jc

    T = jc.sweeps_per_launch()
    # bar: a few ulp of the field's scale 100; the two do the same float32
    # operations in the same order, so equal bits are expected
    tol = 1e-4
    result, worst = {}, 0.0
    for H, W in ((1024, 1024), (2048, 2048), (4096, 4096), (1000, 1500)):
        f, upd = jacobi_case(H, W, seed=H + W)
        for n in (1, T - 1, T, T + 1, 2 * T + 3, 100, 2000):
            before = jc.jacobi_block.launches
            out_k = jc.jacobi_block(f, upd, n)
            torch.cuda.synchronize()
            check(jc.jacobi_block.launches == before + -(-n // T), f"jacobi_block launches for n={n}")
            out_r = jc.jacobi_block_reference(f, upd, n)
            err = float((out_k - out_r).abs().max())
            worst = max(worst, err)
            check(err <= tol, f"jacobi_block vs plain at {H}x{W}, n={n}: {err} > {tol}")
            print(f"phase 8: jacobi_block {H}x{W} n={n}: max_abs_err={err!r} (tol {tol}), "
                  f"bit-identical={bool(torch.equal(out_k, out_r))}")
        # the fused relative change of a block against the plain reduction;
        # bar 1e-5 relative: f64 sums in the kernel's order against f32 sums
        weight = (torch.arange(H * W, device="cuda").reshape(H, W) % 7 != 0).float()
        before = jc.jacobi_block.err_launches
        out_k, err_k = jc.jacobi_block(f, upd, 100, weight=weight)
        torch.cuda.synchronize()
        check(jc.jacobi_block.err_launches == before + 1, "jacobi_block did not count its reduction launch")
        err_r = float(jc.rel_change_reference(out_k, f, weight))
        rel = abs(float(err_k) - err_r) / err_r
        check(rel <= 1e-5, f"fused err {float(err_k)!r} vs plain {err_r!r} at {H}x{W}: {rel} > 1e-5")
        print(f"phase 8: fused relative change {H}x{W}, 100 sweeps: {float(err_k)!r} vs plain {err_r!r} "
              f"(relative difference {rel!r}, bar 1e-5)")
        ms_k = cuda_ms(lambda: jc.jacobi_block(f, upd, 2000), 3) / 2000
        ms_r = cuda_ms(lambda: jc.jacobi_block_reference(f, upd, 100), 3) / 100
        # per sweep: 5 flops a moving pixel; the field in and out and upd in
        # once per call of 2000 sweeps
        b = bound(5 * float(upd.sum()), 9 * H * W / 2000)
        prev = f", previous design {PREV_JACOBI_US[H]} us" if H in PREV_JACOBI_US else ""
        print(f"phase 8: per-sweep time {H}x{W} (CUDA events): kernel {ms_k * 1e3!r} us "
              f"({H * W / ms_k / 1e3!r} Mpixel-iters/s, blocks of 2000){prev}, plain {ms_r * 1e3!r} us "
              f"({H * W / ms_r / 1e3!r} Mpixel-iters/s, blocks of 100); bound {b['bound_ms'] * 1e3!r} us "
              f"({b['bound_by']}), share of the bound {b['bound_ms'] / ms_k!r}")
        if H == 1024:
            result = with_bound(dict(ms=ms_k, plain_ms=ms_r), b)
    print(f"phase 8: kernel config {jc.kernel_config()}")
    return dict(max_abs_err=worst, **result)


def phase_pde_configs():
    """Phase 9a/9b: the JAX benchmark's PDE and atlas configurations through
    `jacobi_solve` on the card. Returns the kernel's launches."""
    from spateo_tpu_torch.ops import jacobi_cuda as jc
    from spateo_tpu_torch.ops.stencil import jacobi_solve

    T = jc.sweeps_per_launch()
    H = W = 1024
    field = np.zeros((H, W), np.float32)
    border = np.zeros((H, W), bool)
    mask = np.zeros((H, W), np.float32)
    mask[1:-1, 1:-1] = 1
    field[1, 1:-1], field[-2, 1:-1] = 1.0, 100.0
    border[1, 1:-1] = border[-2, 1:-1] = True
    kw = dict(max_err=0.0, max_itr=100_000, check_every=2000, device="cuda")
    jacobi_solve(field, border, mask, **kw)  # warm-up
    launches0 = jc.jacobi_block.launches
    err0 = jc.jacobi_block.err_launches
    times = []
    for _ in range(3):
        before = jc.jacobi_block.launches
        t, (sol, it, err) = host_ms(lambda: jacobi_solve(field, border, mask, **kw))
        times.append(t)
        check(it == 102_000, f"PDE configuration ran {it} iterations, expected 102,000 (51 blocks of 2,000)")
        check(jc.jacobi_block.launches - before == -(-2000 // T) * 51, "jacobi_block launches per PDE solve")
    check(jc.jacobi_block.err_launches - err0 == 3 * 51, "fused-reduction launches per PDE solve")
    # 102,000 sweeps do not reach the steady state of a 1024-row raster:
    # heat spreads from both isolines into a middle still near 0
    mid = sol[1:-1, W // 2]
    check(sol.shape == (H, W) and bool(np.isfinite(sol).all()) and 0.0 <= sol.min() and sol.max() <= 100.0,
          "PDE field not finite or outside [0, 100]")
    check(mid[0] == 1.0 and mid[-1] == 100.0 and bool(np.all(np.diff(mid[H // 2:]) >= 0)),
          "PDE field: isolines moved, or heat not falling away from the hot isoline")
    best = min(times)
    print(f"phase 9: PDE configuration 1024x1024, 102,000 iterations (max_err 0, blocks of 2,000): {times!r} ms; "
          f"best {H * W * it / best / 1e3!r} Mpixel-iters/s (host clock, H*W*it/seconds); final err {err!r}; "
          f"jacobi_block launches per solve {-(-2000 // T) * 51}, fused-reduction launches per solve 51")

    P = 2048
    field = np.zeros((P, P), np.float32)
    border = np.zeros((P, P), bool)
    dom = np.ones((P, P), np.float32)
    field[:, :4], field[:, -4:] = 1.0, 100.0
    border[:, :4] = border[:, -4:] = True
    jacobi_solve(field, border, dom, max_err=1e9, max_itr=20_000, check_every=2000, device="cuda")  # warm-up
    before = jc.jacobi_block.launches
    err_before = jc.jacobi_block.err_launches
    t, (sol, it, err) = host_ms(
        lambda: jacobi_solve(field, border, dom, max_err=1e-6, max_itr=20_000, check_every=2000, device="cuda"))
    check(jc.jacobi_block.launches - before == -(-2000 // T) * (it // 2000), "jacobi_block launches per atlas solve")
    check(jc.jacobi_block.err_launches - err_before == it // 2000, "fused-reduction launches per atlas solve")
    row = sol[P // 2]
    check(bool(np.isfinite(sol).all()) and 0.0 <= sol.min() and sol.max() <= 100.0 and row[0] == 1.0
          and row[-1] == 100.0 and bool(np.all(np.diff(row[P // 2:]) >= 0)), "atlas field")
    print(f"phase 9: atlas digitization configuration 2048x2048, stripes, max_err 1e-6: {it} iterations, "
          f"{t!r} ms, final err {err!r}, {P * P * it / t / 1e3!r} Mpixel-iters/s")
    return jc.jacobi_block.launches - launches0


def quad_domain(P, inset, step, offset):
    """A quadrilateral domain on a PxP raster, its cv2 contour and corner
    points (the contour points nearest the polygon's vertices, in (x, y)
    order xy, Xy, xY, XY), and cells on a `step`-pixel grid over the raster."""
    import cv2

    v = np.array([[inset + P // 40, inset], [P - 1 - inset, inset + P // 60], [P - 1 - inset - P // 50, P - 1 - inset],
                  [inset, P - 1 - inset - P // 30]], np.int32)  # (x, y): top-left, top-right, bottom-right, bottom-left
    img = np.zeros((P, P), np.uint8)
    cv2.fillPoly(img, [v], 255)
    ctrs, _ = cv2.findContours(img, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)
    pts = ctrs[0][:, 0]
    near = lambda p: tuple(int(c) for c in pts[np.argmin(((pts - p) ** 2).sum(1))])
    corners = (near(v[0]), near(v[1]), near(v[3]), near(v[2]))
    g = np.arange(offset, P, step)
    yy, xx = np.meshgrid(g, g, indexing="ij")
    coords = np.c_[yy.ravel(), xx.ravel()].astype(np.float64)  # spatial[:, 0] is the row
    return ctrs, corners, coords, img


def digitize_adata(stt, coords):
    adata = stt.AnnData(X=np.ones((len(coords), 1), np.float32))
    adata.obsm["spatial"] = coords
    stt.SKM.init_adata_type(adata, stt.SKM.ADATA_UMI_TYPE)
    return adata


def phase_digitize(stt):
    """Phase 9c: `dd.digitize` then `dd.gridit` at 2048^2, stage by stage
    (each heat solve timed by wrapping the solver `digitize` calls). Returns
    the kernel's launches."""
    from spateo_tpu_torch.digitization import utils as tutils
    from spateo_tpu_torch.ops import jacobi_cuda as jc

    T = jc.sweeps_per_launch()
    P = 2048
    t_ctr, (ctrs, corners, coords, img) = host_ms(lambda: quad_domain(P, 24, 4, 3))
    adata = digitize_adata(stt, coords)
    solves, real_solve = [], tutils.jacobi_solve

    def timed_solve(*a, **k):
        t, out = host_ms(lambda: real_solve(*a, **k))
        solves.append((t, out[1], out[2]))
        return out

    tutils.jacobi_solve = timed_solve
    try:
        before, err_before = jc.jacobi_block.launches, jc.jacobi_block.err_launches
        t_dig, _ = host_ms(lambda: stt.dd.digitize(adata, ctrs, 0, *corners, max_itr=20_000, device="cuda"))
        launches, err_launches = jc.jacobi_block.launches - before, jc.jacobi_block.err_launches - err_before
    finally:
        tutils.jacobi_solve = real_solve
    t_grid, _ = host_ms(lambda: stt.dd.gridit(adata, layer_num=10, column_num=10))

    check(len(solves) == 2, f"digitize ran {len(solves)} heat solves, expected 2")
    blocks = sum(it // 100 for _, it, _ in solves)
    check(launches == -(-100 // T) * blocks, f"jacobi_block launches in digitize {launches}, expected "
                                             f"{-(-100 // T)} per block of 100 over {blocks} blocks")
    check(err_launches == blocks, f"fused-reduction launches in digitize {err_launches}, expected {blocks}")
    layer = np.asarray(adata.obs["digital_layer"], float)
    column = np.asarray(adata.obs["digital_column"], float)
    inside = img[coords[:, 0].astype(int), coords[:, 1].astype(int)] > 0
    check(bool(np.isfinite(layer).all() and np.isfinite(column).all()), "digitize heat not finite")
    # 20,000 sweeps do not reach the steady state of a 2048^2 domain: the
    # heat is in [0, 100], rises from the min isoline (top) to the max one
    # (bottom) and from the left edge to the right one
    for heat in (layer, column):
        check(float(heat.min()) >= 0.0 and float(heat.max()) <= 100.0, "digitize heat outside [0, 100]")
        check(float(np.mean(heat[~inside] == 0)) > 0.99, "cells outside the domain got heat")
    top, bottom = inside & (coords[:, 0] < 0.2 * P), inside & (coords[:, 0] > 0.8 * P)
    left, right = inside & (coords[:, 1] < 0.2 * P), inside & (coords[:, 1] > 0.8 * P)
    check(layer[bottom].mean() > layer[top].mean() and column[right].mean() > column[left].mean(),
          "heat does not rise from the min to the max isoline")
    lay_lab, col_lab = np.asarray(adata.obs["layer_label"]), np.asarray(adata.obs["column_label"])
    check(set(np.unique(lay_lab)) <= set(range(11)) and set(np.unique(col_lab)) <= set(range(11)), "gridit labels")
    rest = t_dig - sum(t for t, _, _ in solves)
    print(f"phase 9: digitize + gridit {P}x{P}, {len(coords)} cells ({int(inside.sum())} inside the domain): "
          f"stages (ms, host clock, synchronised): contours={t_ctr!r}, layer_solve={solves[0][0]!r} "
          f"({solves[0][1]} iterations, err {solves[0][2]!r}), column_solve={solves[1][0]!r} ({solves[1][1]} "
          f"iterations, err {solves[1][2]!r}), borders_arcs_lookups={rest!r}, gridit={t_grid!r}; "
          f"share of cells with layer > 0 {float(np.mean(layer > 0))!r}, column > 0 {float(np.mean(column > 0))!r}; "
          f"jacobi_block launches {launches}, fused-reduction launches {err_launches}")
    return launches


def phase_labeling(mask):
    """Phase 9d: the labeling chain on a 2048^2 Starro mask."""
    from spateo_tpu_torch.ops import labels

    labels.label_cells_from_mask(mask[:256, :256], 3, device="cuda")  # warm-up
    t, (lab, cents) = host_ms(lambda: labels.label_cells_from_mask(mask, 3, device="cuda"))
    n_lab = int(torch.unique(lab).numel()) - int(bool((lab == 0).any()))
    check(lab.shape == mask.shape and lab.dtype == torch.int32, "label raster")
    check(bool(((lab > 0).cpu().numpy() <= mask).all()), "labels outside the mask")
    check(n_lab == len(cents) and bool(np.isfinite(cents).all()), f"{n_lab} labels but {len(cents)} centroids")
    print(f"phase 9: label_cells_from_mask on the 2048x2048 Starro mask (min_distance 3): {n_lab} labels, "
          f"{len(cents)} centroids, {t!r} ms; foreground share {float(mask.mean())!r}")


def phase_digitization_cuda_vs_cpu(stt):
    """Phase 10: a 256^2 solve, a digitize on a 128^2 domain and a labeling
    chain on a 256^2 mask, on the card and on the CPU."""
    from spateo_tpu_torch.ops import labels
    from spateo_tpu_torch.ops.stencil import jacobi_solve

    H = W = 256
    field = np.zeros((H, W), np.float32)
    border = np.zeros((H, W), bool)
    mask = np.zeros((H, W), np.float32)
    mask[8:-8, 8:-8] = 1
    field[8, 8:-8], field[-9, 8:-8] = 1.0, 100.0
    border[8, 8:-8] = border[-9, 8:-8] = True
    res = {dev: host_ms(lambda: jacobi_solve(field, border, mask, max_err=1e-8, max_itr=20_000, device=dev))
           for dev in ("cuda", "cpu")}
    (tg, (fg, itg, eg)), (tc, (fc, itc, ec)) = res["cuda"], res["cpu"]
    ferr = float(np.abs(fg - fc).max())
    # bar: the same float32 sweeps on both, so equal bits are expected; a
    # few ulp of 100 allowed
    check(itg == itc and ferr <= 1e-4, f"256x256 solve: CUDA {itg} / CPU {itc} iterations, field differs by {ferr}")
    print(f"phase 10: 256x256 solve CUDA (kernel) vs CPU (plain): iterations {itg} / {itc}, field max_abs_err "
          f"{ferr!r} (bar 1e-4), bit-identical {bool(np.array_equal(fg, fc))}, err {eg!r} / {ec!r}; {tg!r} ms on the "
          f"card, {tc!r} ms on the CPU")

    ctrs, corners, coords, _ = quad_domain(128, 6, 2, 1)
    outs = {}
    for dev in ("cuda", "cpu"):
        a = digitize_adata(stt, coords)
        stt.dd.digitize(a, ctrs, 0, *corners, max_itr=20_000, device=dev)
        stt.dd.gridit(a, layer_num=5, column_num=5)
        outs[dev] = a.obs
    herr = max(float(np.abs(np.asarray(outs["cuda"][k], float) - np.asarray(outs["cpu"][k], float)).max())
               for k in ("digital_layer", "digital_column"))
    same_labels = all(np.array_equal(np.asarray(outs["cuda"][k]), np.asarray(outs["cpu"][k]))
                      for k in ("layer_label", "column_label", "grid_label"))
    check(herr <= 1e-4 and same_labels, f"128x128 digitize: heat differs by {herr}, labels equal {same_labels}")
    print(f"phase 10: digitize + gridit 128x128 ({len(coords)} cells) CUDA vs CPU: heat max_abs_err {herr!r} "
          f"(bar 1e-4), labels equal {same_labels}")

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:256, :256]
    m = np.zeros((256, 256), bool)
    for cy, cx, r in zip(rng.uniform(8, 248, 150), rng.uniform(8, 248, 150), rng.uniform(3, 7, 150)):
        m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    lg, cg = labels.label_cells_from_mask(m, 3, device="cuda")
    lc, cc = labels.label_cells_from_mask(m, 3, device="cpu")
    same = bool(np.array_equal(lg.cpu().numpy(), lc.numpy()) and np.array_equal(cg, cc))
    check(same, "256x256 labeling chain differs between CUDA and CPU")
    print(f"phase 10: label_cells_from_mask 256x256 CUDA vs CPU: labels and centroids equal ({len(cg)} cells)")


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def device_profile(fn):
    """Run `fn` under torch.profiler: its result, the wall ms under the
    profiler, the device's busy ms (kernels and copies), the kernel launches
    the host made, and the busy ms and event count of each device op by name,
    the largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    by_name = {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy = sum(ms for ms, _ in by_name.values())
    launches = sum(1 for e in events if e.name == "cudaLaunchKernel")
    return out, wall, busy, launches, dict(sorted(by_name.items(), key=lambda kv: -kv[1][0]))


def vfc_fields(N, F, seed=0):
    """`bench.vfc_bench`'s fields: F rotations v = [0, 0, 1] x r of N uniform
    3-D points, plus N(0, 0.05) noise."""
    rng = np.random.default_rng(seed)
    Xs, Vs = [], []
    for _ in range(F):
        Xt = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
        Vt = np.cross(np.broadcast_to([0.0, 0.0, 1.0], Xt.shape), Xt).astype(np.float32)
        Vt += rng.normal(0, 0.05, Vt.shape).astype(np.float32)
        Xs.append(Xt)
        Vs.append(Vt)
    return np.stack(Xs), np.stack(Vs)


def check_rotation_field(r, what):
    """The JAX tests' bars for a learned rotation field (tests/test_tdr.py:
    104-123): mean curl within 0.3 of [0, 0, 2], mean |div| < 0.8, finite."""
    curl_mean = np.asarray(r["curl"]).mean(0)
    div_abs = float(np.abs(r["div"]).mean())
    check(all(bool(np.isfinite(np.asarray(r[k])).all()) for k in ("V", "C", "P", "div", "curl")),
          f"{what}: outputs not finite")
    check(bool(np.abs(curl_mean - [0.0, 0.0, 2.0]).max() <= 0.3) and div_abs < 0.8,
          f"{what}: mean curl {curl_mean}, mean |div| {div_abs}")
    return curl_mean, div_abs


def vfc_adata(stt, X, V):
    import pandas as pd

    a = stt.AnnData(X=np.ones((len(X), 1), np.float32), obs=pd.DataFrame(index=np.arange(len(X)).astype(str)))
    stt.SKM.init_adata_type(a, stt.SKM.ADATA_UMI_TYPE)
    a.obsm["align_spatial"] = X
    a.obsm["V_mapping"] = V
    return a


def phase_morphofield_main(stt):
    """Phase 11: `bench.vfc_bench`'s sweep (4 fields of 100,000 points, M
    100, 60 iterations, ecr 0, div/curl) through `SparseVFC_batch`, its
    stages, the AnnData wrappers and the Morpho field transforms."""
    import bench
    from spateo_tpu_torch.core.bridge import to_device
    from spateo_tpu_torch.ops import vfc

    check(torch.get_float32_matmul_precision() == "highest" and not torch.backends.cuda.matmul.allow_tf32,
          "TF32 must stay off for SparseVFC (con_K takes precision='highest' in the JAX package)")
    N, M, MAXIT, F = 100_000, 100, 60, 4
    Xs, Vs = vfc_fields(N, F)
    run = lambda seed: vfc.SparseVFC_batch(Xs, Vs, M=M, MaxIter=MAXIT, ecr=0.0, seed=seed, morphometrics=True)
    run(0)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    times, reads = [], []
    max_reads = -(-MAXIT // vfc.CHECK_EVERY) + 2
    for seed in (1, 2, 3):
        before = vfc._run_em.host_reads
        t, res = host_ms(lambda: run(seed))
        times.append(t)
        reads.append(vfc._run_em.host_reads - before)
        for f, r in enumerate(res):
            check(r["iteration"] == MAXIT and r["V"].shape == (N, 3) and r["curl"].shape == (N, 3),
                  f"field {f}: {r['iteration']} iterations, V {r['V'].shape}")
            curl_mean, div_abs = check_rotation_field(r, f"SparseVFC_batch seed {seed} field {f}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(n <= max_reads for n in reads), f"EM host reads {reads} > ceil({MAXIT} / {vfc.CHECK_EVERY}) + 2")
    best = min(times)
    print(f"phase 11: SparseVFC_batch 4 x 100,000 points, M {M}, {MAXIT} iterations, div/curl: {times!r} ms; "
          f"{F * N / best * 1e3!r} points/s (best of 3), {F * N * 3 / sum(times) * 1e3!r} points/s (mean); peak "
          f"device memory {peak_gb!r} GB; EM host reads per sweep {reads} (bound {max_reads}); last field's mean curl "
          f"{curl_mean.tolist()}, mean |div| {div_abs!r}")

    # the stages of one sweep, synchronised between stages
    stages = {}
    stages["ctrl_draws"], (ctrl_idx, ctrls, subs) = host_ms(lambda: vfc._batch_ctrl_draws(Xs, M, 4, True))
    stages["upload"], (Xj, Yj, cj, sj) = host_ms(lambda: tuple(to_device(a, "cuda") for a in (Xs, Vs, ctrls, subs)))
    stages["beta"], betas = host_ms(lambda: vfc._beta_from_h2(vfc._median_positive_sqdist(sj)))
    em = lambda: vfc._sparsevfc_em_batch(Xj, Yj, cj, betas, 0.9, 5.0, 3.0, 0.0, 1e-5, MAXIT, with_morphometrics=False)
    stages["em"], out = host_ms(em)
    stages["div_curl"], (_, div, curl) = host_ms(lambda: vfc._field_jacobian(Xj, cj, out["C"], betas, out["y_scale"]))
    pull = {k: out[k] for k in ("sigma2", "gamma", "i", "tecr", "E", "y_scale", "V", "C", "P")}
    stages["pull"], _ = host_ms(lambda: vfc._to_host(dict(pull, div=div, curl=curl, betas=betas)))
    em_dev_ms = cuda_ms(em, 3)
    _, em_wall, em_busy, em_launches, em_ops = device_profile(em)
    jac_dev_ms = cuda_ms(lambda: vfc._field_jacobian(Xj, cj, out["C"], betas, out["y_scale"]), 3)
    # one EM iteration: K read for KP, KP written, both read for K^T KP, K
    # read for K C, KP read for KP^T Y; the products' flops
    it_bound = bound(2 * F * N * M * M + 4 * F * N * M * 3, 6 * F * N * M * 4)
    # the Jacobian: pts and ctrl in, the [F, N, M, D] terms, div and curl out
    jac_bound = bound(F * N * M * (3 * 3 * 2 + 10), 4 * F * N * (3 + 1 + 3))
    print("phase 11: stages of one sweep (ms, host clock, synchronised): "
          + ", ".join(f"{k}={v!r}" for k, v in stages.items()) + f", total={sum(stages.values())!r}")
    print(f"phase 11: EM of 60 iterations: {em_dev_ms!r} ms between CUDA events; under the profiler {em_wall!r} ms "
          f"wall, device busy {em_busy!r} ms (idle share {1 - em_busy / em_wall!r}), {em_launches} kernel launches "
          f"({em_launches / MAXIT!r} an iteration); bound {it_bound['bound_ms'] * MAXIT!r} ms ({it_bound['bound_by']}, "
          f"{it_bound['bound_ms']!r} ms an iteration); div/curl {jac_dev_ms!r} ms (CUDA events, the [4, 100000, 100, 3] "
          f"einsum), bound {jac_bound['bound_ms']!r} ms ({jac_bound['bound_by']})")
    print("phase 11: the EM's device ops by busy time under the profiler (ms, events): "
          + "; ".join(f"{name[:90]} {ms!r} ({n})" for name, (ms, n) in list(em_ops.items())[:12]))

    # the AnnData wrappers
    adatas = [vfc_adata(stt, Xs[f], Vs[f]) for f in range(F)]
    t_batch, _ = host_ms(lambda: stt.tdr.morphofield_sparsevfc_batch(adatas, M=M, MaxIter=MAXIT, ecr=0.0, seed=0))
    for a in adatas:
        check(bool(np.isfinite(a.obs["divergence"]).all()) and a.obsm["curl"].shape == (N, 3),
              "morphofield_sparsevfc_batch outputs")
        check_rotation_field(dict(a.uns["VecFld_morpho"], div=np.asarray(a.obs["divergence"]), curl=a.obsm["curl"]),
                             "morphofield_sparsevfc_batch")
    a = vfc_adata(stt, Xs[0], Vs[0])
    wtimes = {}
    wtimes["morphofield_sparsevfc"], _ = host_ms(lambda: stt.tdr.morphofield_sparsevfc(a, NX=Xs[0][:1000], M=M))
    vf = a.uns["VecFld_morpho"]
    wrappers = {
        "velocity": lambda: stt.tdr.morphofield_velocity(a),
        "acceleration": lambda: stt.tdr.morphofield_acceleration(a),
        "curvature": lambda: stt.tdr.morphofield_curvature(a),
        "curl": lambda: stt.tdr.morphofield_curl(a),
        "torsion": lambda: stt.tdr.morphofield_torsion(a),
        "divergence": lambda: stt.tdr.morphofield_divergence(a),
        "jacobian": lambda: stt.tdr.morphofield_jacobian(a),
        "morphopath_50": lambda: stt.tdr.morphopath(a, interpolation_num=50),
    }
    for name, fn in wrappers.items():
        wtimes[name], _ = host_ms(fn)
    check(vf["iteration"] > 0 and "_device" not in vf, "morphofield_sparsevfc vecfld")
    check_rotation_field(dict(vf, div=np.asarray(a.obs["divergence"]), curl=a.obsm["curl"]), "morphofield wrappers")
    for key in ("acceleration", "curvature", "torsion"):
        check(bool(np.isfinite(np.asarray(a.obs[key])).all()), f"{key} not finite")
    check(a.uns["jacobian"].shape == (N, 3, 3) and a.uns["torsion"].shape == (N, 3, 3), "jacobian/torsion shapes")
    traj = np.asarray(a.uns["fate_morpho"]["prediction"][0]).T
    r0, r1 = np.linalg.norm(traj[0, :2]), np.linalg.norm(traj[-1, :2])
    check(traj.shape == (51, 3) and abs(r1 - r0) / (r0 + 1e-9) < 0.3, "morphopath leaves the rotation's circle")
    print(f"phase 11: morphofield_sparsevfc_batch 4 x 100,000 cells {t_batch!r} ms; one 100,000-cell field "
          f"({vf['iteration']} iterations, ecr 1e-5): " + ", ".join(f"{k}={v!r}" for k, v in wtimes.items()) + " ms")

    # the Morpho users of the field
    pts, ptsA, Xg = bench._make_slice_pair(20000, seed=2)
    ref_run = lambda: stt.align.morpho_align_ref([bench._mk_adata(stt, pts, Xg), bench._mk_adata(stt, ptsA, Xg)],
                                                 n_sampling=2000, spatial_key="spatial", key_added="align",
                                                 max_iter=200, verbose=False)
    ref_run()  # warm-up
    t_ref, (aligned, aligned_ref, _, _) = host_ms(ref_run)
    vecfld = aligned[1].uns["VecFld_morpho"]
    t_ba, (nonrigid, _, rigid) = host_ms(lambda: stt.align.BA_transform(vecfld, ptsA))
    rms = float(np.sqrt(((aligned[1].obsm["align"] - pts) ** 2).sum(1).mean()))
    rms_ba = float(np.sqrt(((rigid - pts) ** 2).sum(1).mean()))
    check(aligned[1].obsm["align"].shape == pts.shape and rms < 0.1 and rms_ba < 0.1 and len(aligned_ref[1]) == 2000,
          f"morpho_align_ref: RMS to the truth {rms} / {rms_ba}")
    check(bool(np.isfinite(nonrigid).all()), "BA_transform non-rigid coordinates not finite")
    print(f"phase 11: morpho_align_ref 20,000-cell pair through 2,000-cell references (200 iterations): {t_ref!r} ms, "
          f"RMS to the truth {rms!r}; BA_transform of 20,000 cells {t_ba!r} ms (RMS {rms_ba!r})")


def phase_morphofield_cuda_vs_cpu(stt):
    """Phase 12: `SparseVFC_batch` on 4 x 10,000 points and `GPVectorField`
    Jacobians on 2,000 points, on the card and on the CPU."""
    from spateo_tpu_torch.ops import vfc
    from spateo_tpu_torch.tdr.morphometrics.morphofield_dg.GPVectorField import GPVectorField

    Xs, Vs = vfc_fields(10_000, 4, seed=12)
    res = {dev: vfc.SparseVFC_batch(Xs, Vs, M=100, MaxIter=60, ecr=0.0, seed=5, device=dev) for dev in ("cuda", "cpu")}
    errs = []
    for f, (g, c) in enumerate(zip(res["cuda"], res["cpu"])):
        v_err = float(np.abs(g["V"] - c["V"]).max() / np.abs(c["V"]).max())
        dc_err = max(float(np.abs(g[k] - c[k]).max()) for k in ("div", "curl"))
        errs.append((v_err, dc_err))
        check(g["iteration"] == c["iteration"] and v_err <= 1e-3 and dc_err <= 1e-2,
              f"field {f}: CUDA vs CPU iterations {g['iteration']}/{c['iteration']}, V {v_err}, div/curl {dc_err}")
    a = vfc_adata(stt, Xs[0], Vs[0])
    a.uns["VecFld_morpho"] = {k: v for k, v in res["cpu"][0].items() if k != "_device"}
    X = Xs[0][:2000]
    J = {}
    for dev in ("cuda", "cpu"):
        gv = GPVectorField(device=dev)
        gv.from_adata(a, vf_key="VecFld_morpho")
        J[dev] = {m: gv.get_Jacobian(m)(X) for m in ("analytical", "numerical")}
    j_err = {m: float(np.abs(J["cuda"][m] - J["cpu"][m]).max() / np.abs(J["cpu"][m]).max()) for m in J["cpu"]}
    check(j_err["analytical"] <= 1e-4 and j_err["numerical"] <= 1e-3, f"GPVectorField Jacobians CUDA vs CPU {j_err}")
    print(f"phase 12: SparseVFC_batch 4 x 10,000 CUDA vs CPU: (V scaled err, div/curl max_abs_err) per field {errs} "
          f"(bars 1e-3, 1e-2), iterations equal; GPVectorField Jacobians on 2,000 points, scaled err {j_err} "
          f"(bars 1e-4 analytical, 1e-3 numerical: central differences of step 1e-2 in f32)")


#: the bench stages of `bench.atlas_e2e`, in order
ATLAS_STAGES = ("segmentation_stream", "labeling_centroids", "alignment_chain", "morphofield_divcurl", "digitization")


def atlas_chain(n_slices=4, tile=2048, spacing=10.0, n_genes=50, align_max_iter=100, svi_batch=2000, vfc_M=100,
                vfc_iters=60, pde_max_itr=20000, n_layers=10, seg_tile=2048, seed=0, device="cuda", profile=False):
    """`bench.atlas_e2e`'s pipeline through the port on `device`: the Starro
    stream (mask only) -> `label_cells_from_mask` per seg_tile quadrant ->
    `align.morpho_align` chain (SVI) -> `SparseVFC_batch` with div/curl ->
    `jacobi_solve` and per-cell layer bins. The data are the benchmark's
    (`bench._atlas_centers`, `_atlas_paint`, `_atlas_expression`), made
    outside the clock. On the card each stage is warmed up first, as the
    benchmark does; with `profile` (for a second run, after a warm one) each
    stage runs under torch.profiler, without the warm-ups, and its device-busy
    seconds are returned in ``stage_busy_seconds``. Without it, each stage
    sets the kernels' launch counters to 0 just before it runs, after its
    warm-up, and reads them just after, into ``stage_launches`` (summed in
    ``launches``)."""
    import pandas as pd

    import bench
    import spateo_tpu_torch as stt
    from spateo_tpu_torch.ops import bp_cuda, estep_cuda, inlier_cuda, jacobi_cuda
    from spateo_tpu_torch.ops.labels import label_cells_from_mask
    from spateo_tpu_torch.ops.stencil import jacobi_solve
    from spateo_tpu_torch.ops.vfc import SparseVFC_batch
    from spateo_tpu_torch.segmentation.starro import starro_em_bp_stream

    warm = torch.device(device).type == "cuda" and not profile
    stages, busy, launches = {}, {}, {}
    counters = {"bp_step": (bp_cuda.bp_step, "launches"), "bp_step_delta": (bp_cuda.bp_step, "delta_launches"),
                "estep_colnorm": (estep_cuda.colnorm, "launches"), "estep_rowred": (estep_cuda.rowred, "launches"),
                "inlier_fit": (inlier_cuda.inlier_fit, "launches"),
                "jacobi_block": (jacobi_cuda.jacobi_block, "launches"),
                "jacobi_err": (jacobi_cuda.jacobi_block, "err_launches")}

    def timed(name, fn):
        if profile:
            out, wall, b, _, _ = device_profile(fn)
            stages[name], busy[name] = wall / 1e3, b / 1e3
            return out
        sync(device)
        for obj, attr in counters.values():
            setattr(obj, attr, 0)
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        stages[name] = time.perf_counter() - t0
        launches[name] = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
        return out

    seg_tile = min(seg_tile, tile)
    nq = tile // seg_tile
    check(nq * seg_tile == tile, "tile must be a multiple of seg_tile")
    centers, transforms = bench._atlas_centers(tile, spacing, n_slices, seed, seg_tile=seg_tile)
    rasters = [bench._atlas_paint(tile, centers[i], seed + 100 + i) for i in range(n_slices)]
    quad_rc = [(r, c) for r in range(nq) for c in range(nq)]
    quads = [rasters[i][r * seg_tile:(r + 1) * seg_tile, c * seg_tile:(c + 1) * seg_tile]
             for i in range(n_slices) for (r, c) in quad_rc]

    # stage 1: segmentation stream, then labels and centroids per quadrant
    stream = lambda q: [m for _, m in starro_em_bp_stream(q, k=5, seed=seed, bp_max_iter=50, mask_only=True,
                                                          device=device)]
    if warm:
        stream(quads[:1])
    qmasks = timed("segmentation_stream", lambda: stream(quads))
    cap = int(2.0 * (seg_tile / spacing) ** 2) + 1024  # max_labels as bench.py:783 sizes it

    def label_slice(i):
        parts = []
        for q, (r, c) in enumerate(quad_rc):
            _, cq = label_cells_from_mask(qmasks[i * nq * nq + q], min_distance=3, max_labels=cap, device=device)
            parts.append(cq + np.array([r * seg_tile, c * seg_tile], np.float32))
        return np.concatenate(parts, axis=0)

    if warm:
        label_slice(0)
    cents = timed("labeling_centroids", lambda: [label_slice(i) for i in range(n_slices)])
    n_found = [len(c) for c in cents]

    # one cell budget for the chain; expression from the tissue coordinates
    N = min(n_found)
    rng = np.random.default_rng(seed + 7)
    cents = [c[rng.choice(len(c), N, replace=False)] for c in cents]
    c_mid = np.array([tile / 2, tile / 2], np.float32)
    slices = []
    for i in range(n_slices):
        R, t = transforms[i]
        tissue = (cents[i] - c_mid - t) @ R + c_mid
        a = stt.AnnData(X=bench._atlas_expression(tissue, n_genes, seed, tile=tile),
                        obs=pd.DataFrame(index=np.arange(N).astype(str)),
                        var=pd.DataFrame(index=[f"g{j}" for j in range(n_genes)]))
        a.obsm["spatial"] = cents[i].astype(np.float32)
        a.obsm["tissue_true"] = tissue.astype(np.float32)
        stt.SKM.init_adata_type(a, "UMI")
        slices.append(a)

    # stage 2: the serial non-rigid alignment chain
    align = lambda models: stt.align.morpho_align(models=models, spatial_key="spatial", key_added="align_spatial",
                                                  iter_key_added=None, max_iter=align_max_iter, SVI_mode=True,
                                                  batch_size=svi_batch, verbose=False, device=device)[0]
    if warm:
        align([slices[0].copy(), slices[1].copy()])
    aligned = timed("alignment_chain", lambda: align(slices))

    # stage 3: the batched morphofields with div/curl, one per aligned pair
    Xs = np.stack([np.asarray(aligned[i + 1].obsm["spatial"], np.float32) for i in range(n_slices - 1)])
    Vs = np.stack([np.asarray(aligned[i + 1].obsm["align_spatial_nonrigid"], np.float32) - Xs[i]
                   for i in range(n_slices - 1)])
    fit = lambda: SparseVFC_batch(Xs, Vs, M=vfc_M, MaxIter=vfc_iters, ecr=0.0, seed=seed, morphometrics=True,
                                  device=device)
    if warm:
        fit()
    fields = timed("morphofield_divcurl", fit)
    for i, f in enumerate(fields):
        aligned[i + 1].obs["divergence"] = f["div"]
        aligned[i + 1].obs["curl"] = np.linalg.norm(f["curl"], axis=1) if f["curl"].ndim == 2 else f["curl"]

    # stage 4: the layer heat field across the tissue and per-cell layer bins
    pg = min(tile, seg_tile)
    scale = pg / tile
    field = np.zeros((pg, pg), np.float32)
    border = np.zeros((pg, pg), bool)
    dom = np.ones((pg, pg), np.float32)
    field[:, :4], field[:, -4:] = 1.0, 100.0
    border[:, :4] = border[:, -4:] = True
    if warm:
        jacobi_solve(field, border, dom, max_err=1e9, max_itr=pde_max_itr, check_every=2000, device=device)

    def digitize():
        sol, n_itr, err = jacobi_solve(field, border, dom, max_err=1e-6, max_itr=pde_max_itr, check_every=2000,
                                       device=device)
        px = np.clip(np.round(cents[0] * scale), 0, pg - 1).astype(np.int64)
        heat = np.asarray(sol)[px[:, 0], px[:, 1]]
        return n_itr, np.clip(((heat - 1.0) / 99.0 * n_layers).astype(np.int32), 0, n_layers - 1)

    n_itr, digital_layer = timed("digitization", digitize)

    wall = sum(stages.values())
    err = np.linalg.norm(np.asarray(aligned[-1].obsm["align_spatial"]) - aligned[-1].obsm["tissue_true"], axis=1)
    return {
        "n_slices": n_slices,
        "tile": tile,
        "cells_per_slice": N,
        "cells_found_per_slice": n_found,
        "total_cell_slices": N * n_slices,
        "stage_seconds": stages,
        "stage_busy_seconds": busy,
        "stage_launches": launches,
        "launches": {k: sum(st[k] for st in launches.values()) for k in counters},
        "wall_seconds": wall,
        "cells_slices_per_min": N * n_slices / (wall / 60.0),
        "pde_iters": int(n_itr),
        "vfc_iterations": [f["iteration"] for f in fields],
        "checks": {
            "mask_frac": float(np.mean([m.mean() for m in qmasks[: nq * nq]])),
            "digital_layer_bins": int(len(np.unique(digital_layer))),
            "div_finite": all(bool(np.isfinite(np.asarray(a.obs["divergence"], float)).all()) for a in aligned[1:]),
            "align_last_slice_med_err_px": float(np.median(err)),
        },
    }


def phase_atlas_chain():
    """Phase 13: the atlas chain through the port at 4 slices of 2,048²
    (one seg_tile each), with all five kernels counted within its timed
    stages (warm-ups excluded) and held to the counts the chain must give."""
    from spateo_tpu_torch.ops import jacobi_cuda

    n_slices, align_iters, bp_iters, pde_block = 4, 100, 50, 2000
    torch.cuda.reset_peak_memory_stats()
    r = atlas_chain(n_slices=n_slices, tile=2048, seg_tile=2048, spacing=10.0, align_max_iter=align_iters,
                    device="cuda")
    launches = r["launches"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    c = r["checks"]
    # what the timed chain must launch: BP in blocks of 10 (one fused delta
    # each) for at most bp_iters on each tile; one colnorm and one rowred an
    # alignment iteration and one coarse fit per pair; ceil(2000 / T) Jacobi
    # launches and one error reduction per block of 2,000 sweeps
    blocks = -(-r["pde_iters"] // pde_block)
    want = {"estep_colnorm": (n_slices - 1) * align_iters, "estep_rowred": (n_slices - 1) * align_iters,
            "inlier_fit": n_slices - 1, "jacobi_block": blocks * -(-pde_block // jacobi_cuda.kernel_config()["T"]),
            "jacobi_err": blocks}
    check(all(launches[k] == n for k, n in want.items()), f"atlas chain launches {launches}, expected {want}")
    check(launches["bp_step"] == 10 * launches["bp_step_delta"]
          and n_slices <= launches["bp_step_delta"] <= n_slices * bp_iters // 10,
          f"bp_step launched {launches['bp_step']} times with {launches['bp_step_delta']} fused deltas")
    check(set(r["stage_seconds"]) == set(ATLAS_STAGES), f"atlas stages {list(r['stage_seconds'])}")
    check(0.05 < c["mask_frac"] < 0.7, f"atlas mask share {c['mask_frac']}")
    check(c["align_last_slice_med_err_px"] < 10.0, f"last slice's median error {c['align_last_slice_med_err_px']} px")
    check(c["div_finite"], "atlas divergence not finite")
    check(c["digital_layer_bins"] >= 3 and r["pde_iters"] > 0, f"atlas layer bins {c['digital_layer_bins']}")
    print(f"phase 13: atlas chain 4 x 2048^2 (seg_tile 2048, spacing 10): cells found per slice "
          f"{r['cells_found_per_slice']}, {r['cells_per_slice']} a slice in the chain; stages (s, host clock, "
          f"synchronised): " + ", ".join(f"{k}={v!r}" for k, v in r["stage_seconds"].items())
          + f"; wall {r['wall_seconds']!r} s, {r['cells_slices_per_min']!r} cell-slices/min; peak device memory "
          f"{peak_gb!r} GB; mask share {c['mask_frac']!r}, last slice's median error {c['align_last_slice_med_err_px']!r}"
          f" px (bar 10), layer bins {c['digital_layer_bins']}, PDE iterations {r['pde_iters']}, SparseVFC iterations "
          f"{r['vfc_iterations']}; kernel launches in the timed chain (warm-ups excluded) {json.dumps(launches)}, "
          f"expected {json.dumps(want)} and bp_step = 10 x its fused deltas; per stage "
          + json.dumps({k: {n: v for n, v in st.items() if v} for k, st in r["stage_launches"].items()}))
    p = atlas_chain(n_slices=4, tile=2048, seg_tile=2048, spacing=10.0, device="cuda", profile=True)
    print("phase 13: the chain again under torch.profiler, per stage (wall s, device busy s, idle share): "
          + ", ".join(f"{k}=({p['stage_seconds'][k]!r}, {p['stage_busy_seconds'][k]!r}, "
                      f"{1 - p['stage_busy_seconds'][k] / p['stage_seconds'][k]!r})" for k in ATLAS_STAGES)
          + f"; whole chain idle share {1 - sum(p['stage_busy_seconds'].values()) / p['wall_seconds']!r}")


#: `bench.music_bench`'s workload (bench.py:397-479): Q = N cells, K
#: features, the poisson family, 25 IRLS iterations, ridge 0, clip 5, the
#: untruncated gaussian kernel of bandwidth 1.0, 4 targets.
MUSIC_N, MUSIC_K, MUSIC_ITERS, MUSIC_TARGETS, MUSIC_BW = 8192, 12, 25, 4, 1.0


def short_op(name, width=90):
    """A device op's name without ATen's common prefixes, cut to `width`."""
    for prefix in ("void ", "at::native::", "vectorized_elementwise_kernel<4, ", "elementwise_kernel<128, 2, ",
                   "at::native::", "(anonymous namespace)::"):
        name = name[len(prefix):] if name.startswith(prefix) else name
    return name[:width]


def music_bench_data(N=MUSIC_N, K=MUSIC_K, n_targets=MUSIC_TARGETS):
    """`bench.music_bench`'s data (bench.py:410-418, seed 0; the targets from
    seed 7): coords in [0, 10]^2, X with an intercept column, and per target
    the generating coefficients and its poisson counts."""
    rng = np.random.default_rng(0)
    coords = rng.uniform(0, 10, (N, 2)).astype(np.float32)
    X = rng.normal(0, 0.3, (N, K)).astype(np.float32)
    X[:, 0] = 1.0
    rng_t = np.random.default_rng(7)
    betas, ys = [], []
    for _ in range(n_targets):
        b = rng_t.normal(0, 0.4, K)
        betas.append(b)
        ys.append(rng_t.poisson(np.exp(np.clip(X @ b, -4, 4))).astype(np.float32))
    return coords, X, np.stack(betas), ys


def music_fit_all(coords_d, y_d, X_d, bw=MUSIC_BW, n_irls_iter=MUSIC_ITERS):
    """One target of the benchmark: W from the coordinates on their device
    (the untruncated gaussian kernel, bench.py:423-429), then the port's
    `_iwls_batch_kernel` over every cell."""
    from spateo_tpu_torch.tools.CCI_effects_modeling.regression_utils import _iwls_batch_kernel

    sq = (coords_d**2).sum(1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (coords_d @ coords_d.T)
    W = torch.exp(-torch.clamp(d2, min=0.0) / (2 * bw**2))
    return _iwls_batch_kernel(y_d, X_d, W, 0.0, 5.0, "poisson", n_irls_iter)


#: Share of the (focal row, coefficient) pairs with |beta_true| >= 0.2 whose
#: fitted sign is the truth's. The JAX package's own `_iwls_batch_kernel` on
#: the CPU gets 0.978, 0.991, 1.0 and 0.973 for the 4 targets on the first
#: 512 focal rows at this seed (rows are independent, so a 512-row block of
#: W gives the full fit's rows); the bar leaves 0.02 for the other rows.
#: (With ~500 cells of effective weight and X of sd 0.3, a local beta is
#: ~0.1-0.3 off the truth, so smaller coefficients flip.)
MUSIC_SIGN_BAR, MUSIC_SIGN_MIN_ABS = 0.95, 0.2


def music_sign_share(betas, beta_true, min_abs=MUSIC_SIGN_MIN_ABS):
    """Share of the fitted signs that are the truth's where |truth| >= min_abs."""
    keep = np.abs(beta_true) >= min_abs
    return float((np.sign(betas[:, keep]) == np.sign(beta_true[keep])[None, :]).mean())


def phase_music_bench():
    """Phase 14a: `bench.music_bench`'s 4-target poisson sweep at Q = N =
    8,192, K 12, cut nowhere, through the port's `_iwls_batch_kernel`."""
    check(torch.get_float32_matmul_precision() == "highest" and not torch.backends.cuda.matmul.allow_tf32,
          "TF32 must stay off for MuSIC (the JAX distance dot takes precision='highest')")
    coords, X, beta_true, ys = music_bench_data()
    cd, Xd = torch.from_numpy(coords).cuda(), torch.from_numpy(X).cuda()
    yds = [torch.from_numpy(y).cuda() for y in ys]

    def sweep():
        return [music_fit_all(cd, yd, Xd) for yd in yds]

    sweep()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t, out = host_ms(sweep)
        times.append(t)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    shares = []
    for t, (b, h) in enumerate(out):
        b, h = b.cpu().numpy(), h.cpu().numpy()
        check(b.shape == (MUSIC_N, MUSIC_K) and h.shape == (MUSIC_N,) and bool(np.isfinite(b).all())
              and bool(np.isfinite(h).all()), f"target {t}: betas {b.shape}, hats {h.shape} or not finite")
        shares.append(music_sign_share(b, beta_true[t]))
    check(min(shares) >= MUSIC_SIGN_BAR, f"sign recovery {shares} < {MUSIC_SIGN_BAR} (the JAX package's CPU run)")
    best, mean = min(times), sum(times) / len(times)
    cells = MUSIC_TARGETS * MUSIC_N
    _, wall, busy, launches, ops = device_profile(sweep)
    q = n = MUSIC_N
    k = MUSIC_K
    # per IRLS iteration: the [q, n] @ [n, k^2] and two [q, n] x [n, k]
    # products, ~20 elementwise flops an entry; the leverage pass: one
    # product and the elementwise work. W read once an iteration.
    flops = MUSIC_TARGETS * (MUSIC_ITERS * (2 * q * n * (k * k + 2 * k) + 20 * q * n) + 2 * q * n * k * k + 20 * q * n)
    nbytes = MUSIC_TARGETS * (MUSIC_ITERS + 1) * q * n * 4
    b = bound(flops, nbytes)
    top = ", ".join(f"{short_op(name)} {ms!r} ms/{cnt}" for name, (ms, cnt) in list(ops.items())[:8])
    print(f"phase 14: music_bench sweep ({MUSIC_TARGETS} targets x {MUSIC_N} cells, K {MUSIC_K}, poisson, "
          f"{MUSIC_ITERS} IRLS iterations): {times!r} ms; {cells / best * 1e3!r} cells/s (best of 3), "
          f"{cells / mean * 1e3!r} cells/s (mean); peak device memory {peak_gb!r} GB; sign recovery {shares} "
          f"(bar {MUSIC_SIGN_BAR}, |beta| >= {MUSIC_SIGN_MIN_ABS})")
    print(f"phase 14: sweep under the profiler: wall {wall!r} ms, device busy {busy!r} ms, idle share "
          f"{1 - busy / wall!r}; {launches} launches, {launches / (MUSIC_TARGETS * (MUSIC_ITERS + 1))!r} per IRLS "
          f"iteration; bound {b['bound_ms']!r} ms ({b['bound_by']}: {flops / 1e9!r} GFLOP, {nbytes / 1e9!r} GB), "
          f"share of bound {b['bound_ms'] / best!r}")
    print(f"phase 14: the sweep's device ops by busy time (ms/events): {top}")
    return dict(ms=best, bound_ms=b["bound_ms"])


def music_slice(n=10_000, seed=0, n_targets=3):
    """A synthetic slice for an `lr` MuSIC model: the `lr_adata` fixture of
    tests/test_music_fidelity.py scaled to `n` cells at 0.01 cells per unit
    area (a square of side sqrt(n / 0.01)). Senders (x < side / 2) express
    TGFB1 and DLL1, receivers TGFBR1, TGFBR2 and NOTCH1. TGT1 rises in the
    receivers within 30 units of the senders (the reach of 25-neighbour
    secreted weights), TGT2 within 16 (8 neighbours, contact), TGT3 in the
    receivers within 30 whose TGFBR2 is above its median. Returns the port's
    AnnData and the masks of the receivers each target's effect lies on."""
    import pandas as pd

    import spateo_tpu_torch as stt

    rng = np.random.default_rng(seed)
    side = float(np.sqrt(n / 0.01))
    half = side / 2
    pts = rng.uniform(0, side, (n, 2)).astype(np.float32)
    genes = ["TGFB1", "TGFBR1", "TGFBR2", "DLL1", "NOTCH1", "TGT1", "TGT2", "TGT3"][: 5 + n_targets]
    X = rng.poisson(0.2, (n, len(genes))).astype(np.float32)
    senders = pts[:, 0] < half
    X[senders, 0] += rng.poisson(5.0, senders.sum())
    X[senders, 3] += rng.poisson(4.0, senders.sum())
    for j in (1, 2, 4):
        X[~senders, j] += rng.poisson(3.0, (~senders).sum())
    near = {30: ~senders & (pts[:, 0] < half + 30), 16: ~senders & (pts[:, 0] < half + 16)}
    effect = {"TGT1": near[30], "TGT2": near[16], "TGT3": near[30] & (X[:, 2] > np.median(X[~senders, 2]))}
    for t, m in list(effect.items())[:n_targets]:
        X[m, genes.index(t)] += rng.poisson(6.0, m.sum())
    adata = stt.AnnData(
        X=X,
        obs=pd.DataFrame({"cell_type": np.where(senders, "sender", "receiver")}, index=[f"c{i}" for i in range(n)]),
        var=pd.DataFrame(index=genes),
    )
    adata.obsm["spatial"] = pts
    stt.SKM.init_adata_type(adata, stt.SKM.ADATA_UMI_TYPE)
    return adata, dict(list(effect.items())[:n_targets])


#: The pair whose coefficient carries each planted target's effect.
MUSIC_PLANTED_PAIRS = {"TGT1": "TGFB1", "TGT2": "DLL1:NOTCH1", "TGT3": "TGFB1:TGFBR2"}


def music_fit(adata, out_dir, device="cuda", fixed_bw=20, search=("TGT2", "TGT3"), fixed=("TGT1",),
              distr="poisson"):
    """`tl.MuSIC(...).fit()` on an `lr` model of `music_slice`'s genes:
    bisquare adaptive weights; the `fixed` targets at `fixed_bw` neighbours,
    the `search` targets with the golden-section bandwidth search. Returns
    the model, the coefficients, bandwidths and seconds per target (search,
    final fit), the seconds of `define_sig_inputs` and the `mpi_fit` calls."""
    import spateo_tpu_torch as stt

    targets = sorted(set(fixed) | set(search))
    model = stt.tl.MuSIC(
        adata=adata, mod_type="lr", species="human", output_path=f"{out_dir}/music.csv", distr=distr,
        custom_ligands=["TGFB1", "DLL1"], custom_receptors=["TGFBR1", "TGFBR2", "NOTCH1"],
        custom_targets=targets, kernel="bisquare", bw_fixed=False, fit_intercept=True, device=device,
    )
    t0 = time.perf_counter()
    model._set_up_model(verbose=False)
    t_define = time.perf_counter() - t0
    stages, orig = [], model.mpi_fit

    def timed(*args, **kwargs):
        t = time.perf_counter()
        out = orig(*args, **kwargs)
        sync(device)
        stages.append((kwargs["y_label"], bool(kwargs["final"]), time.perf_counter() - t))
        return out

    model.mpi_fit = timed
    coeffs, bws = {}, {}
    for bw, group in ((fixed_bw, fixed), (None, search)):
        if not group:
            continue
        model.bw = bw
        model.fit(y=model.targets_expr[list(group)], verbose=False)
        coeffs.update(model.coeffs)
        bws.update(model.bws)
    seconds = {t: (sum(s for lab, f, s in stages if lab == t and not f), sum(s for lab, f, s in stages if lab == t and f))
               for t in targets}
    return model, coeffs, bws, seconds, t_define, len(stages)


def check_music_effects(coeffs, effect, what):
    """Each planted target's driving pair has a positive mean coefficient on
    the receivers its effect lies on. Returns those means."""
    means = {}
    for t, m in effect.items():
        cdf = coeffs[t]
        cols = [c for c in cdf.columns if c.startswith("b_") and MUSIC_PLANTED_PAIRS[t] in c and ":" in c]
        check(bool(cols), f"{what}: no fitted pair of {MUSIC_PLANTED_PAIRS[t]} for {t}: {list(cdf.columns)}")
        rows = np.asarray(m)[: len(cdf)]
        means[t] = {c[2:]: float(cdf[c].values[rows].mean()) for c in cols}
        check(max(means[t].values()) > 0, f"{what}: {t}'s {MUSIC_PLANTED_PAIRS[t]} coefficients on its receivers {means[t]}")
    return means


def phase_music_fit():
    """Phase 14b: `tl.MuSIC(...).fit()` end to end on a 10,000-cell slice."""
    import tempfile

    adata, effect = music_slice(10_000)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        model, coeffs, bws, seconds, t_define, calls = music_fit(adata, tmp)
        total = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for t, cdf in coeffs.items():
        check(cdf.shape[0] == 10_000 and bool(np.isfinite(cdf.values).all()), f"{t}: coefficients {cdf.shape}")
    means = check_music_effects(coeffs, effect, "phase 14b")
    print(f"phase 14: MuSIC.fit lr model on 10,000 cells ({len(model.feature_names)} features "
          f"{model.feature_names}): {total!r} s in all; define_sig_inputs {t_define!r} s; per target (search s, "
          f"final fit s) {seconds}; {calls} mpi_fit calls; bandwidths {bws}; peak device memory {peak_gb!r} GB; "
          f"driving pairs' mean coefficients on the receivers {means}")


def phase_music_cuda_vs_cpu():
    """Phase 15: MuSIC on the card against the CPU, the same inputs."""
    import tempfile

    from spateo_tpu_torch.tools import find_neighbors as fn, spatial_degs as sd
    from spateo_tpu_torch.tools.CCI_effects_modeling import regression_utils as ru

    rng = np.random.default_rng(15)
    n, k = 2000, 12
    coords = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    X = rng.normal(0, 0.3, (n, k)).astype(np.float32)
    X[:, 0] = 1.0
    y = rng.poisson(np.exp(np.clip(X @ rng.normal(0, 0.4, k), -4, 4))).astype(np.float32)
    d2 = ((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1)
    W = np.exp(-d2 / (2 * 8.0**2)).astype(np.float32)
    errs = {}
    for distr in ("gaussian", "poisson", "nb"):
        out = {dev: ru.iwls_batch_full(y, X, W, distr=distr, ridge_lambda=0.3, clip=5.0, device=dev)
               for dev in ("cuda", "cpu")}
        errs[distr] = [float(np.abs(g - c).max() / max(np.abs(c).max(), 1e-30)) for g, c in zip(out["cuda"], out["cpu"])]
        check(max(errs[distr]) <= 1e-4, f"iwls_batch_full {distr} CUDA vs CPU (betas, hat, inv_diag, pred) {errs[distr]}")
    print(f"phase 15: iwls_batch_full {n} cells, k {k}, CUDA vs CPU, scaled errors (betas, hat, inv_diag, pred) "
          f"{errs} (bar 1e-4)")

    ct = rng.integers(1, 4, n).astype(np.int32)
    cond = rng.random(n) < 0.4
    w_stats = {}
    for fixed, bw in ((True, 8.0), (False, 25)):
        for excl in (False, True):
            Wd = {}
            for dev in ("cuda", "cpu"):
                c = torch.from_numpy(coords).to(dev)
                ctd = torch.from_numpy(ct).to(dev)
                Wd[dev] = fn._conditioned_kernel_weights_batch(
                    c, c, bw, ctd, ctd, torch.from_numpy(cond).to(dev), function="bisquare", fixed=fixed,
                    exclude_self=excl, self_idx=torch.arange(n, device=dev),
                ).cpu().numpy()
            err = float(np.abs(Wd["cuda"] - Wd["cpu"]).max())
            flips = int(((Wd["cuda"] > 0) != (Wd["cpu"] > 0)).sum())
            nnz = int((Wd["cpu"] > 0).sum())
            w_stats[f"{'fixed' if fixed else 'adaptive'}, exclude_self={excl}"] = (err, flips, nnz)
            check(err <= 2e-3 and flips <= 1e-4 * nnz, f"conditioned weights fixed={fixed} exclude_self={excl}: "
                  f"max_abs_err {err}, {flips} support flips of {nnz}")
    print(f"phase 15: conditioned weights {n} x {n}, CUDA vs CPU (max_abs_err, support flips, nonzeros) {w_stats} "
          f"(bars 2e-3, 1e-4 of the nonzeros)")

    import pandas as pd

    import spateo_tpu_torch as stt

    G = 20
    expr = rng.poisson(np.exp(np.sin(coords[:, :1] / 15.0 * np.arange(1, G + 1)[None, :] / 4))).astype(np.float32)
    a = stt.AnnData(X=expr, obs=pd.DataFrame(index=[f"c{i}" for i in range(n)]),
                    var=pd.DataFrame(index=[f"g{j}" for j in range(G)]))
    a.obsm["spatial"] = coords
    res = {dev: sd.moran_i(a, permutations=199, seed=3, device=dev) for dev in ("cuda", "cpu")}
    i_err = float(np.abs(res["cuda"]["moran_i"].values - res["cpu"]["moran_i"].values).max())
    differ = np.flatnonzero(res["cuda"]["moran_p_val"].values != res["cpu"]["moran_p_val"].values)
    if len(differ):
        Z = torch.from_numpy((expr - expr.mean(0, keepdims=True)).astype(np.float32))
        Wm = torch.from_numpy(sd._spatial_weights(coords.astype(float), 5).astype(np.float32))
        rng_p = np.random.default_rng(3)
        perm = torch.from_numpy(np.stack([rng_p.permutation(n) for _ in range(199)]))
        I_obs, I_perm = sd._moran_replicates(Z, Wm, perm)
        gap = (I_perm[:, differ] - I_obs[differ][None, :]).abs().min(0).values
        check(bool((gap <= 1e-5).all()), f"moran_i p-values differ on genes {differ.tolist()} with no permuted I "
              f"within 1e-5 of the observed one (gaps {gap.tolist()})")
    check(i_err <= 1e-5, f"moran_i CUDA vs CPU I max_abs_err {i_err}")
    print(f"phase 15: moran_i {n} cells x {G} genes, 199 permutations, CUDA vs CPU: I max_abs_err {i_err!r} (bar "
          f"1e-5), p-values differ on {len(differ)} genes (each with a permuted I within 1e-5 of the observed one)")

    small, _ = music_slice(250, seed=11, n_targets=1)
    fits = {}
    for dev in ("cuda", "cpu"):
        with tempfile.TemporaryDirectory() as tmp:
            _, coeffs, _, _, _, _ = music_fit(small, tmp, device=dev, fixed_bw=10, search=(), distr="poisson")
            fits[dev] = coeffs["TGT1"]
    c_err = float(np.abs(fits["cuda"].values - fits["cpu"].values).max() / np.abs(fits["cpu"].values).max())
    check(list(fits["cuda"].columns) == list(fits["cpu"].columns) and c_err <= MUSIC_FIT_BAR,
          f"MuSIC.fit CUDA vs CPU coefficients scaled err {c_err} (bar {MUSIC_FIT_BAR})")
    print(f"phase 15: MuSIC.fit lr model, 250 cells, bw 10, CUDA vs CPU: coefficients scaled err {c_err!r} "
          f"(bar {MUSIC_FIT_BAR})")


#: Card against CPU, one `MuSIC.fit` at a fixed bandwidth: the coefficients'
#: largest difference over their largest magnitude. Measured 3.7e-6 on an
#: H100 (the same package on both sides: the weights agree to 2.7e-7).
MUSIC_FIT_BAR = 1e-5


#: Phase 16's NB fits: 20,000 samples over the density bins (each bin its
#: share), seed 0; `downsample` of 0.001 leaves a 256² or 512² bin a handful.
TUTORIAL_EM = dict(seed=0, downsample=20000)
TUTORIAL_VI = dict(seed=0, downsample=20000)
#: The staged EM+BP mask's IoU with the planted disks of the two-depth tile.
#: On the CPU, `starro_tutorial(two_depth_tile(512), 32, "cpu")` (15 bins)
#: gives 0.72 and `starro_em_bp` on that tile 0.80; at 256² with binsize 4
#: (55 bins of ~1,200 pixels, most without a cell, whose mixtures split the
#: background) the staged mask gives 0.06, no bar to set one from.
PLANTED_IOU_BAR = 0.6


def planted_disks(n, seed=0):
    """The cell disks `bench.make_raster(n, n, seed)` plants, from a replay
    of its draws."""
    rng = np.random.default_rng(seed)
    rng.negative_binomial(1, 0.5, (n, n))
    m = np.zeros((n, n), bool)
    for _ in range((n * n) // 2500):
        cy, cx = int(rng.integers(0, n)), int(rng.integers(0, n))
        r = int(rng.integers(4, 10))
        y0, y1, x0, x1 = max(cy - r, 0), min(cy + r + 1, n), max(cx - r, 0), min(cx + r + 1, n)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        disk = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        m[y0:y1, x0:x1] |= disk
        rng.negative_binomial(8, 0.35, int(disk.sum()))
    return m


def two_depth_tile(n, seed=0):
    """`bench.make_raster(n, n, seed)` with an independent NB(1, 0.5)
    background draw added to its right half: two tissue depths."""
    from bench import make_raster

    X = make_raster(n, n, seed=seed)
    X[:, n // 2 :] += np.random.default_rng(seed + 10_000).negative_binomial(1, 0.5, (n, n - n // 2))
    return X


def starro_tutorial(X, binsize, device="cuda"):
    """The Starro tutorial on one raster through the port's public API:
    `segment_densities` (k 5, dk 3, the Ward cut at the knee), the staged
    `score_and_mask_pixels(method="EM+BP")` with those bins,
    `find_peaks_from_mask` (min_distance 3), `watershed`,
    `label_connected_components` (into ``X_cc``) and `expand_labels`.
    Returns (adata, {stage: seconds}, (bp_step launches, fused deltas) of
    the scoring stage on the card, else None)."""
    import spateo_tpu_torch as stt
    from spateo_tpu_torch.ops import bp_cuda

    a = stt.AnnData(X=X)
    stt.SKM.init_adata_type(a, stt.SKM.ADATA_AGG_TYPE)
    stages, counts = {}, None

    def timed(name, fn):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        stages[name] = time.perf_counter() - t0

    timed("segment_densities", lambda: stt.cs.segment_densities(a, "X", binsize, 5, 3, device=device))
    bp_cuda.bp_step.launches = bp_cuda.bp_step.delta_launches = 0
    timed("score_and_mask_pixels", lambda: stt.cs.score_and_mask_pixels(
        a, "X", 5, "EM+BP", bins_layer="X_bins", em_kwargs=TUTORIAL_EM, device=device))
    if torch.device(device).type == "cuda":
        counts = (bp_cuda.bp_step.launches, bp_cuda.bp_step.delta_launches)
    timed("find_peaks_from_mask", lambda: stt.cs.find_peaks_from_mask(a, "X", 3, device=device))
    timed("watershed", lambda: stt.cs.watershed(a, "X", device=device))
    timed("label_connected_components",
          lambda: stt.cs.label_connected_components(a, "X", out_layer="X_cc", device=device))
    timed("expand_labels", lambda: stt.cs.expand_labels(a, "X", device=device))
    return a, stages, counts


def write_gem(X, path, n_genes=20, seed=0):
    """A GEM file of raster X: one read row a nonzero pixel (x = row, y =
    column), its count split over nothing, its gene drawn at random."""
    import gzip

    import pandas as pd

    rows, cols = np.nonzero(X)
    genes = np.random.default_rng(seed).integers(0, n_genes, rows.size)
    df = pd.DataFrame({"geneID": [f"g{g}" for g in genes], "x": rows, "y": cols,
                       "MIDCounts": X[rows, cols].astype(np.int64)})
    with gzip.open(path, "wt") as f:
        df.to_csv(f, sep="\t", index=False)


def phase_starro_tutorial():
    """Phase 16. Returns the scoring stage's (bp_step launches, deltas)."""
    import tempfile

    from bench import make_raster
    import spateo_tpu_torch as stt
    from spateo_tpu_torch.ops import em
    from spateo_tpu_torch.segmentation import starro as ts
    from spateo_tpu_torch.segmentation import utils as sut

    X = two_depth_tile(TILE, 0)
    P = planted_disks(TILE, 0)
    starro_tutorial(X, 32)  # warm-up: first-call costs of each op
    torch.cuda.reset_peak_memory_stats()
    reads = sut.safe_erode.host_reads
    a, stages, (launches, deltas) = starro_tutorial(X, 32)
    reads = sut.safe_erode.host_reads - reads
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    bins, scores, mask = a.layers["X_bins"], a.layers["X_scores"], a.layers["X_mask"]
    n_bins = len(np.unique(bins))
    check(scores.shape == X.shape and bool(np.isfinite(scores).all()), "staged scores not finite or wrong shape")
    check(mask.dtype == bool and 0.01 < mask.mean() < 0.3, f"staged mask share {mask.mean()}")
    disk_iou = iou(mask, P)
    check(disk_iou >= PLANTED_IOU_BAR, f"staged mask IoU with the planted disks {disk_iou} < {PLANTED_IOU_BAR}")
    # the staged BP reads its delta after every iteration: one fused delta a launch
    check(0 < launches <= 100 and deltas == launches, f"staged bp_step launches {launches}, fused deltas {deltas}")
    n_labels = {k: int(a.layers[k].max()) for k in ("X_labels", "X_cc", "X_labels_expanded")}
    n_cells = TILE * TILE // 2500  # disks planted, some touching
    check(all(0.5 * n_cells < v < 2 * n_cells for v in n_labels.values()), f"labels {n_labels}, {n_cells} disks")
    print(f"phase 16: Starro tutorial {TILE}x{TILE}, two depths (stages, s, host clock, synchronised): "
          + ", ".join(f"{k}={v!r}" for k, v in stages.items()) + f"; total {sum(stages.values())!r} s; "
          f"{n_bins} density bins (binsize 32, knee); mask share {float(mask.mean())!r}, IoU with the planted disks "
          f"{disk_iou!r} (bar {PLANTED_IOU_BAR}); labels {n_labels}; bp_step launches {launches} with {deltas} fused "
          f"deltas (f32, checked every iteration); safe_erode host reads {reads}; peak device memory {peak_gb!r} GB")

    # the other methods on the same tile and bins, each warmed up first on a
    # 512² corner (their ops' first calls compile kernels: 18 s for VI's)
    others = {}
    stain = (P * 200 + np.random.default_rng(1).integers(0, 10, P.shape)).astype(np.uint8)
    corner = stt.AnnData(X=X[:512, :512], layers={"X_bins": bins[:512, :512], "stain": stain[:512, :512]})
    stt.SKM.init_adata_type(corner, stt.SKM.ADATA_AGG_TYPE)
    stt.cs.mask_nuclei_from_stain(corner)
    for method in ("EM", "EM+gauss", "VI+BP", "moran"):
        kw = dict(em_kwargs=TUTORIAL_EM) if "EM" in method else dict(vi_kwargs=TUTORIAL_VI) if "VI" in method else {}
        stt.cs.score_and_mask_pixels(corner, "X", 5, method, **kw)
        t, _ = host_ms(lambda: stt.cs.score_and_mask_pixels(a, "X", 5, method, scores_layer="s_" + method,
                                                            mask_layer="m_" + method, **kw))
        s, m = a.layers["s_" + method], a.layers["m_" + method]
        check(s.shape == X.shape and bool(np.isfinite(s).all()) and 0.005 < m.mean() < 0.5,
              f"{method}: scores finite {np.isfinite(s).all()}, mask share {m.mean()}")
        others[method] = (t, float(m.mean()), iou(m, P))
    a.layers["stain"] = stain
    t_stain, _ = host_ms(lambda: stt.cs.mask_nuclei_from_stain(a))
    stain_iou = iou(a.layers["stain_mask"], P)
    check(stain_iou >= 0.8, f"mask_nuclei_from_stain IoU with the disks {stain_iou}")
    print("phase 16: other methods on the same tile and bins (ms, mask share, IoU with the planted disks): "
          + ", ".join(f"{k}=({v[0]!r}, {v[1]!r}, {v[2]!r})" for k, v in others.items())
          + f"; mask_nuclei_from_stain on the disks' stain {t_stain!r} ms, IoU {stain_iou!r}")

    # where the staged scoring and the VI fit spend their time
    from spateo_tpu_torch.ops.image import conv2d
    from spateo_tpu_torch.segmentation import icell, vi

    _, wall, busy, nl, ops = device_profile(lambda: stt.cs.score_and_mask_pixels(
        a, "X", 5, "EM+BP", em_kwargs=TUTORIAL_EM, scores_layer="s_profiled", mask_layer="m_profiled"))
    res = conv2d(X, 5, bins=bins)
    params = icell._initial_nb_params(res, bins)
    _, vwall, _, vnl, vops = device_profile(lambda: vi.run_vi(res.cpu().numpy(), bins=bins, params=params,
                                                              **TUTORIAL_VI))
    vops = {k: v for k, v in vops.items() if not k.startswith("Optimizer.")}  # an annotation, not a device op
    vbusy = sum(ms for ms, _ in vops.values())
    top = lambda d: ", ".join(f"{short_op(k, 60)} {v[0]!r}/{v[1]}" for k, v in list(d.items())[:5])
    print(f"phase 16: under torch.profiler (wall ms, device busy ms, idle share, kernel launches): staged EM+BP "
          f"scoring ({wall!r}, {busy!r}, {1 - busy / wall!r}, {nl}), top ops (ms/events) {top(ops)}; the VI fit of "
          f"{n_bins - (0 in bins)} bins, 500 Adam steps ({vwall!r}, {vbusy!r}, {1 - vbusy / vwall!r}, {vnl}), top ops "
          f"{top(vops)}")

    # the stream, per-tile fits against fits of 4 tiles at once
    tiles = [make_raster(TILE, TILE, seed=s) for s in range(4)]
    kw = dict(k=5, seed=0, bp_max_iter=50, mask_only=True)
    for b in (1, 4):
        list(stt.cs.starro_em_bp_stream(tiles, em_batch=b, **kw))  # warm-up
    t1, out1 = host_ms(lambda: list(stt.cs.starro_em_bp_stream(tiles, em_batch=1, **kw)))
    t4, out4 = host_ms(lambda: list(stt.cs.starro_em_bp_stream(tiles, em_batch=4, **kw)))
    same = all(np.array_equal(m1, m4) and torch.equal(s1, s4) for (s1, m1), (s4, m4) in zip(out1, out4))
    check(same, "em_batch=4 stream differs from the per-tile stream")
    n_samples = ts._n_samples(TILE * TILE, 0.001)
    phase_a = [ts._starro_density_init_sample(ts._upload(t, "cuda"), 5, n_samples, 0) for t in tiles]
    per_iter = {}
    for b in (1, 4):
        stats = {}
        args = [torch.stack([p[i] for p in phase_a[:b]]) for i in (1, 2, 3, 4)]
        ones = torch.ones((b, n_samples), dtype=torch.bool, device="cuda")
        _, wall, busy, nl, _ = device_profile(lambda: em._nbn_em_batched(args[0], ones, *args[1:], 2000, 1e-6,
                                                                         stats=stats, rowwise=True))
        per_iter[b] = (nl / stats["n_iter"], stats["n_iter"], wall)
    mpx = 4 * TILE * TILE / 1e3
    print(f"phase 16: stream of 4 tiles {TILE}x{TILE}: em_batch=1 {t1!r} ms ({mpx / t1!r} Mpixels/s), em_batch=4 "
          f"{t4!r} ms ({mpx / t4!r} Mpixels/s), masks and scores identical {same}; the EM's launches an iteration "
          f"(iterations, wall ms under the profiler): B=1 {per_iter[1]}, B=4 {per_iter[4]}")

    # the GEM round trip
    Xg = make_raster(512, 512, seed=5)
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/tile.gem.gz"
        write_gem(Xg, path)
        t_agg, agg = host_ms(lambda: stt.io.read_bgi_agg(path))
        check(np.array_equal(agg.X.toarray(), Xg.astype(np.uint16)), "read_bgi_agg did not give the raster back")
        stt.cs.score_and_mask_pixels(agg, "X", 5, "EM+BP", em_kwargs=dict(seed=0))
        stt.cs.find_peaks_from_mask(agg, "X", 3)
        stt.cs.watershed(agg, "X")
        t_cells, cells = host_ms(lambda: stt.io.read_bgi(path, segmentation_adata=agg, labels_layer="X_labels"))
    labels = agg.layers["X_labels"]
    check(stt.SKM.get_adata_type(cells) == "UMI" and cells.n_obs == len(np.unique(labels[labels > 0]))
          and cells.n_vars == 20 and int(cells.X.sum()) == int(Xg[labels > 0].sum()),
          f"read_bgi: {cells.n_obs} cells x {cells.n_vars} genes, {cells.X.sum()} counts")
    print(f"phase 16: GEM round trip 512x512: read_bgi_agg {t_agg!r} ms, read_bgi {t_cells!r} ms, {cells.n_obs} cells "
          f"x {cells.n_vars} genes, {int(cells.X.sum())} counts (those of the labelled pixels)")
    return launches, deltas


def phase_starro_cuda_vs_cpu():
    """Phase 17: the staged methods, the binned BP, labels and safe erosion,
    card against CPU at 512²."""
    from spateo_tpu_torch.ops import bp_cuda, em
    from spateo_tpu_torch.ops.image import conv2d
    from spateo_tpu_torch.ops.threshold import threshold_otsu
    from spateo_tpu_torch.segmentation import icell, vi
    from spateo_tpu_torch.segmentation.label import _label_connected_components
    from spateo_tpu_torch.segmentation.utils import _apply_threshold, safe_erode

    n = 512
    X = two_depth_tile(n, 2)
    bins = np.ones((n, n), np.int64)
    bins[:, n // 2 :] = 2
    bins[: n // 16] = 0  # exact 0/1 potentials outside the bins
    certain = np.zeros((n, n), bool)
    certain[200:206, 300:306] = True
    out = {}
    real_vi = vi.run_vi
    fits = {}

    def vi_once(*args, **kwargs):  # the VI fit made once on the CPU, used on both sides
        if "fit" not in fits:
            fits["fit"] = real_vi(*args, **dict(kwargs, device="cpu"))
        return fits["fit"]

    vi.run_vi = vi_once
    try:
        for method in ("EM+BP", "VI+BP", "EM"):
            kw = dict(em_kwargs=TUTORIAL_EM) if "EM" in method else dict(vi_kwargs=TUTORIAL_VI)
            s = {dev: icell._score_pixels(X, 5, method, certain_mask=certain, bins=bins, device=dev, **kw).cpu()
                 for dev in ("cuda", "cpu")}
            # EM's posterior is NaN outside the bins (0 / 0, as in the JAX
            # package): the masks threshold the finite scores at their Otsu cut
            m = {dev: _apply_threshold(torch.nan_to_num(v, nan=0.0), 7, threshold_otsu(v[torch.isfinite(v)])).numpy()
                 for dev, v in s.items()}
            lab = {dev: _label_connected_components(m["cuda"], device=dev) for dev in ("cuda", "cpu")}
            nan_same = bool(torch.equal(torch.isnan(s["cuda"]), torch.isnan(s["cpu"])))
            err = float(torch.nan_to_num(s["cuda"] - s["cpu"], nan=0.0).abs().max()) if nan_same else float("inf")
            out[method] = (err, iou(m["cuda"], m["cpu"]), bool(np.array_equal(lab["cuda"], lab["cpu"])))
            check(err <= 1e-3 and out[method][1] >= 0.999 and out[method][2],
                  f"{method} card vs CPU: scores max_abs_err {err}, mask IoU {out[method][1]}, labels equal "
                  f"{out[method][2]}")
    finally:
        vi.run_vi = real_vi
    res = conv2d(X, 5, bins=bins, device="cpu")
    params = icell._initial_nb_params(res, bins)
    fit_c = real_vi(res.numpy(), bins=bins, params=params, device="cuda", **TUTORIAL_VI)
    fit_h = real_vi(res.numpy(), bins=bins, params=params, device="cpu", **TUTORIAL_VI)
    vi_err = max(float(np.max(np.abs(fit_c[b][k] - fit_h[b][k]) / np.abs(fit_h[b][k]))) for b in fit_h for k in fit_h[b])
    check(vi_err <= 5e-2, f"VI fits card vs CPU relative error {vi_err}")

    # bp_kernel on the binned phi, f32, checked every iteration: bit for bit
    fit = em.run_em(res.numpy(), bins=bins, params=params, device="cpu", **TUTORIAL_EM)
    bg, cell = em.conditionals(res, fit, torch.as_tensor(bins))
    phi = torch.stack([bg, cell], dim=-1)
    phi = phi / torch.clamp_min(phi.sum(-1, keepdim=True), 1e-30)
    check(bool((phi[: n // 16] == torch.tensor([1.0, 0.0])).all()), "phi outside the bins is not exactly (1, 0)")
    st = {"cuda": {}, "cpu": {}}
    marg = {dev: bp_cuda.bp_kernel(phi.to(dev), BP_P, BP_Q, 1e-6, 100, check_every=1, stats=st[dev]).cpu()
            for dev in ("cuda", "cpu")}
    bp_same = st["cuda"]["n_iter"] == st["cpu"]["n_iter"] and bool(torch.equal(marg["cuda"], marg["cpu"]))
    check(bp_same, f"binned bp_kernel card vs plain: iterations {st}, max_abs_err "
                   f"{float((marg['cuda'] - marg['cpu']).abs().max())}")

    # safe erosion of the tile's large components
    m = _apply_threshold(marg["cpu"], 7, threshold_otsu(marg["cpu"])).numpy()
    se = {dev: safe_erode(m, 3, min_area=30, device=dev) for dev in ("cuda", "cpu")}
    check(np.array_equal(se["cuda"], se["cpu"]), "safe_erode card vs CPU differ")
    print("phase 17: 512x512 with bins and a certain mask, card vs CPU (scores max_abs_err (bar 1e-3), mask IoU "
          "(bar 0.999), label_connected_components labels equal): "
          + ", ".join(f"{k}={v}" for k, v in out.items())
          + f" (VI+BP from one CPU fit; the VI fits themselves card vs CPU within {vi_err!r} relative, bar 5e-2); "
          f"bp_kernel on the binned phi (f32, checked every iteration) {st['cuda']['n_iter']} iterations, "
          f"bit-identical to the plain loop {bp_same}; safe_erode bools equal ({int(se['cuda'].sum())} pixels)")


#: Phase 18's synthetic cortical section: 20,000 cells at jittered lattice
#: positions in a 10,000 x 6,000 DNB-unit domain (about 5 x 3 mm at
#: Stereo-seq's 500 nm pitch), 4,000 genes, the first 60 of them planted
#: layer-specific (each in one of 6 horizontal bands), the rest Poisson
#: background at rates 0.1-0.5.
SVG_CELLS, SVG_GENES, SVG_PLANTED, SVG_BANDS = 20_000, 4_000, 60, 6
SVG_DOMAIN = (10_000.0, 6_000.0)
#: The reference defaults of the SVG path: 400 cells after smoothing and
#: sampling, the geodesic distance over 8 neighbours with these cutoffs.
SVG_DOWNSAMPLE, SVG_KW = 400, dict(n_neighbors=8, min_dis_cutoff=500, max_dis_cutoff=1000)
#: Bootstrap rounds of phase 18c, cut from the reference's 100 to keep
#: phases 18-19 nearer their time (PERF.md section 4).
SVG_BOOTSTRAP = 30
#: Bootstrap rounds of phase 18d's scan on pseudocounted counts, where
#: every GW solve runs to its stop (20 genes x 2 rounds).
SVG_GW_PSEUDO_BOOTSTRAP = 1
#: Recall of the planted genes among the top 60 by z-score that phase 18b
#: must reach: the port's CPU run at the same size (`svg_scan(
#: cortex_section(), "cpu")`) found 59 of 60 (0.983); the bar allows two
#: borderline genes more to change places on the card, so that a faster
#: wrong answer fails.
SVG_RECALL_BAR = 0.95
#: PASTE's entropic FGW takes eps = 5e-3 in absolute units, so PASTE runs on
#: coordinates in units of 1,000 DNB (0.5 mm): on DNB units grad / eps is
#: too large for float32 to resolve (ROADMAP Queue 3).
PASTE_UNIT = 1_000.0
PASTE_ANGLE, PASTE_SHIFT = 30.0, (0.5, -0.3)
#: PASTE at its defaults does not recover the planted rotation of phase
#: 18e's pair (the second section's counts drawn anew): the entropic FGW
#: (absolute eps 5e-3, alpha 0.1) locks into a hard plan some units off and
#: the rotation misses by ~120 deg, in the JAX package too (ROADMAP Queue
#: 3). The card's rotation error is held to within `PASTE_ANGLE_BAR`
#: degrees of the port's CPU answer on the same pair (`paste_main(
#: paste_sections(), "cpu")`, measured once).
PASTE_CPU_ROTATION_ERR, PASTE_ANGLE_BAR = 121.13259961448202, 1.0
#: Outer iterations of the FGW run under the profiler (of its 200): the
#: profiler's host records of ~2,200 launches an outer iteration take
#: minutes to read for all 200.
PASTE_PROFILED_ITERS = 20
#: `paste_center_align`'s FGW outer iterations a solve: **cut from its default
#: 200 to 50** (the script's time limit: its 12 solves, launch-bound, took
#: ~70 s at 200 on one H100).
CENTER_FGW_ITERS = 50


def svg_gene_names(n_genes=SVG_GENES, n_planted=SVG_PLANTED):
    return [f"L{i % SVG_BANDS}_{i}" if i < n_planted else f"g{i}" for i in range(n_genes)]


def cortex_section(n_cells=SVG_CELLS, n_genes=SVG_GENES, n_planted=SVG_PLANTED, seed=0, theta_deg=0.0,
                   shift=(0.0, 0.0), unit=1.0, expr_seed=None):
    """The port's AnnData of one synthetic section (sparse float32 X,
    coordinates in DNB units / `unit`). Positions come from `seed`; the
    expression from `expr_seed` (default: `seed`), so two sections can share
    positions and differ in counts. The section may be rotated by
    `theta_deg` about the domain's centre and shifted by `shift` (in the
    output units)."""
    import pandas as pd
    import scipy.sparse as sp

    import spateo_tpu_torch as stt

    rng = np.random.default_rng(seed)
    W, H = SVG_DOMAIN
    ny = max(int(round(np.sqrt(n_cells * H / W))), 1)
    nx = -(-n_cells // ny)
    xs, ys = np.meshgrid((np.arange(nx) + 0.5) * W / nx, (np.arange(ny) + 0.5) * H / ny)
    c = np.c_[xs.ravel(), ys.ravel()][:n_cells]
    c = c + rng.uniform(-0.4, 0.4, c.shape) * [W / nx, H / ny]
    erng = np.random.default_rng(seed + 1000 if expr_seed is None else expr_seed)
    rates = np.random.default_rng(seed + 2000).uniform(0.1, 0.5, n_genes)
    band = np.minimum((c[:, 1] * SVG_BANDS // H).astype(int), SVG_BANDS - 1)
    planted = np.arange(min(n_planted, n_genes))
    blocks = []
    for r0 in range(0, len(c), 2000):  # counts in row blocks: int64 draws of the whole X would take 640 MB
        rows = slice(r0, r0 + 2000)
        X = erng.poisson(rates, (len(c[rows]), n_genes)).astype(np.float32)
        in_band = band[rows, None] == (planted % SVG_BANDS)[None, :]
        X[:, planted] += np.where(in_band, erng.poisson(1.0, in_band.shape), 0).astype(np.float32)
        blocks.append(sp.csr_matrix(X))
    th = np.deg2rad(theta_deg)
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    c = ((c - [W / 2, H / 2]) @ R.T + [W / 2, H / 2]) / unit + np.asarray(shift)
    adata = stt.AnnData(X=sp.vstack(blocks).tocsr(), var=pd.DataFrame(index=svg_gene_names(n_genes, n_planted)),
                        obs=pd.DataFrame(index=[f"c{i}" for i in range(len(c))]))
    adata.obsm["spatial"] = c.astype(np.float64)
    stt.SKM.init_adata_type(adata, stt.SKM.ADATA_UMI_TYPE)
    return adata


class timed_calls:
    """Within the block, the functions named by (module, attribute) pairs
    record their calls' seconds (synchronised on `device`) in `seconds`."""

    def __init__(self, device, **targets):
        self.device, self.targets, self.seconds = device, targets, {}

    def __enter__(self):
        self.saved = {}
        for name, (mod, attr) in self.targets.items():
            orig = getattr(mod, attr)
            self.saved[name] = (mod, attr, orig)

            def wrapped(*args, _orig=orig, _name=name, **kwargs):
                t = time.perf_counter()
                out = _orig(*args, **kwargs)
                sync(self.device)
                self.seconds[_name] = self.seconds.get(_name, 0.0) + time.perf_counter() - t
                return out

            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in self.saved.values():
            setattr(mod, attr, orig)


class fgw_log:
    """Within the block, each entropic FGW solve of the port records its
    seconds (synchronised on `device`), its outer iterations and whether its
    objective is finite."""

    def __init__(self, device):
        self.device, self.seconds, self.iterations, self.finite = device, [], [], []

    def __enter__(self):
        from spateo_tpu_torch.ops import ot

        self.orig = orig = ot._fgw_entropic_run

        def run(*args, **kwargs):
            t = time.perf_counter()
            out = orig(*args, **kwargs)
            sync(self.device)
            self.seconds.append(time.perf_counter() - t)
            self.iterations.append(out[2])
            self.finite.append(bool(torch.isfinite(out[1])))
            return out

        ot._fgw_entropic_run = run
        return self

    def __exit__(self, *exc):
        from spateo_tpu_torch.ops import ot

        ot._fgw_entropic_run = self.orig


def svg_scan(section, device="cuda"):
    """Phase 18a-b: `smoothing_and_sampling` (the reference defaults) and
    `svg_iden_reg` on the 400 cells over all genes, with each
    stage's seconds. Returns the scan's table, the 400-cell AnnData and the
    stage seconds."""
    import spateo_tpu_torch as stt
    from spateo_tpu_torch.svg import get_svg as tgs
    from spateo_tpu_torch.svg import utils as tsu

    t0 = time.perf_counter()
    small, _ = stt.svg.smoothing_and_sampling(section, downsampling=SVG_DOWNSAMPLE, device=device)
    t_smooth = time.perf_counter() - t0
    with timed_calls(device, graph=(tsu, "_knn_distance_graph"), floyd_warshall=(tsu, "floyd_warshall"),
                     scan=(tgs, "cal_wass_dis_batch"), loess=(tgs, "loess_1d")) as tc:
        t0 = time.perf_counter()
        w0 = stt.svg.svg_iden_reg(small, device=device, **SVG_KW)
        sync(device)
        total = time.perf_counter() - t0
    return w0, small, dict(smoothing_and_sampling=t_smooth, svg_iden_reg=total, **tc.seconds)


def scan_inputs(small):
    """The cost matrix and the genes' histograms (float32) that
    `svg_iden_reg` hands its scan, built as `bin_scale_adata_get_distance`
    and `cal_wass_dis_for_genes` build them."""
    from spateo_tpu_torch.svg import utils as tsu

    b = tsu.cal_geodesic_distance(tsu.scale_to(small), **SVG_KW)
    A = np.asarray(b.X, np.float64).T
    sums = A.sum(1, keepdims=True)
    A = np.where(sums > 0, A / np.maximum(sums, 1e-300), 1.0 / A.shape[1])
    return np.asarray(b.obsp["distance"], np.float32), A.astype(np.float32)


def svg_recall(w0, n_planted=SVG_PLANTED):
    """Share of the planted genes among the top `n_planted` by z-score."""
    top = w0["zscore"].nlargest(n_planted).index
    return float(np.mean([g.startswith("L") for g in top]))


def paste_sections(n_cells=SVG_CELLS, n_genes=SVG_GENES, seed=0):
    """Phase 18e's pair, in units of `PASTE_UNIT` DNB: a section, and the
    same cells rotated by `PASTE_ANGLE` degrees about the domain's centre
    and shifted by `PASTE_SHIFT`, with counts drawn anew (their own seed,
    the same rates and bands), then thinned: each count kept with
    probability 0.8, plus Poisson(0.1) counts."""
    import scipy.sparse as sp

    a = cortex_section(n_cells, n_genes, seed=seed, unit=PASTE_UNIT)
    b = cortex_section(n_cells, n_genes, seed=seed, theta_deg=PASTE_ANGLE, shift=PASTE_SHIFT, unit=PASTE_UNIT,
                       expr_seed=seed + 500)
    rng = np.random.default_rng(seed + 7)
    X = b.X.tocsr().astype(np.float32)
    X.data = rng.binomial(X.data.astype(np.int64), 0.8).astype(np.float32)
    b.X = (X + sp.csr_matrix(rng.poisson(0.1, b.shape).astype(np.float32))).tocsr()
    return a, b


def rotation_error_deg(R, theta_deg=PASTE_ANGLE):
    """How far PASTE's Procrustes rotation (which maps the second slice back
    onto the first) lies from undoing the planted rotation, in degrees."""
    got = np.rad2deg(np.arctan2(R[1, 0], R[0, 0]))
    return float(abs((got + theta_deg + 180) % 360 - 180))


def paste_main(models, device="cuda", n_sampling=2000):
    """Phase 18e-f: `align.paste_align_ref` (TRN references of `n_sampling`
    cells, 200 outer iterations), then `tdr.cell_directions` between the
    aligned references. Returns the aligned models, the references, the
    plan, the FGW log and the stage seconds."""
    import spateo_tpu_torch as stt

    with fgw_log(device) as log:
        t0 = time.perf_counter()
        aligned, refs, pis = stt.align.paste_align_ref([m.copy() for m in models], n_sampling=n_sampling,
                                                       sampling_method="trn", numItermax=200, verbose=False,
                                                       device=device)
        t_pair = time.perf_counter() - t0
    a, b = refs[0].copy(), refs[1].copy()
    t0 = time.perf_counter()
    stt.tdr.cell_directions(a, b, device=device)
    t_dir = time.perf_counter() - t0
    return aligned, (a, b), pis[0], log, dict(paste_align_ref=t_pair, cell_directions=t_dir)


def phase_svg_paste():
    """Phase 18: the SVG scan, its bootstrap, the between-slice GW scan,
    PASTE, cell directions and the PASTE center on the card. Returns what
    phase 19 compares: the 400-cell sample, the between-slice scan's
    pseudocounted samples and its genes."""
    import spateo_tpu_torch as stt
    from spateo_tpu_torch.svg import utils as tsu

    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    t_phase = t0 = time.perf_counter()
    section = cortex_section(seed=0)
    t_data = time.perf_counter() - t0
    # warm-up: first calls of the scan's ops on a 64-gene, 2,000-cell section
    svg_scan(cortex_section(2_000, 64, seed=3), "cuda")

    # (a, b) smoothing and sampling, then the no-bootstrap scan over all genes
    w0, small, st_b = svg_scan(section, "cuda")
    recall = svg_recall(w0)
    check(len(w0) == SVG_GENES and bool(np.isfinite(w0["zscore"]).all()), f"scan table {w0.shape}")
    check(recall >= SVG_RECALL_BAR, f"planted recall {recall} < {SVG_RECALL_BAR}")
    M, A = scan_inputs(small)
    reads = tsu._sinkhorn_batch_run.host_reads
    _, wall, busy, launches, ops = device_profile(lambda: tsu.cal_wass_dis_batch(M, A, device="cuda"))
    blocks = tsu._sinkhorn_batch_run.host_reads - reads
    chunk = tsu.scan_chunk(M.shape[0], A.shape[0])
    top = ", ".join(f"{short_op(k, 60)} {v[0]:.1f}/{v[1]}" for k, v in list(ops.items())[:4])
    print(f"phase 18: section {SVG_CELLS} cells x {SVG_GENES} genes ({SVG_PLANTED} planted in {SVG_BANDS} bands), "
          f"made in {t_data!r} s; svg_iden_reg on {small.n_obs} cells (geodesic, {SVG_KW}): "
          f"{SVG_GENES / st_b['scan']!r} genes/s of the scan, stages (s, synchronised) "
          + ", ".join(f"{k} {v!r}" for k, v in st_b.items())
          + f"; planted recall in the top {SVG_PLANTED} by z-score {recall!r} (bar {SVG_RECALL_BAR})")
    print(f"phase 18: the scan alone under torch.profiler ({M.shape[0]} cells, chunk {chunk}, "
          f"{-(-A.shape[0] // chunk)} chunks, {blocks} blocks of 10 sweeps): wall {wall!r} ms, device busy {busy!r} "
          f"ms, idle share {1 - busy / wall!r}, {launches} launches; ops by busy ms/events: {top}")

    # (c) the bootstrap scan: 60 planted + 140 null genes, `SVG_BOOTSTRAP` rounds
    genes = list(w0.index[w0.index.str.startswith("L")]) + [f"g{i}" for i in range(SVG_PLANTED, SVG_PLANTED + 140)]
    t0 = time.perf_counter()
    w_bs, _ = stt.svg.cal_wass_dist_bs(small, gene_set=genes, bootstrap=SVG_BOOTSTRAP, rank_p=True, device="cuda",
                                       **SVG_KW)
    t_bs = time.perf_counter() - t0
    z_planted = float(np.median(w_bs.loc[genes[:SVG_PLANTED], "zscore"]))
    z_null = float(np.median(w_bs.loc[genes[SVG_PLANTED:], "zscore"]))
    check(len(w_bs) == 200 and bool(np.isfinite(w_bs["rank_p"]).all()), "bootstrap table")
    check(z_planted > z_null, f"bootstrap z: planted median {z_planted} <= null median {z_null}")
    print(f"phase 18: cal_wass_dist_bs {len(genes)} genes x {SVG_BOOTSTRAP} bootstrap rounds (rank_p): {t_bs!r} s "
          f"({(SVG_BOOTSTRAP + 1) * len(genes) / t_bs!r} gene-scans/s); median z planted {z_planted!r}, null "
          f"{z_null!r}")

    # (d) the between-slice GW scan
    gw_genes = genes[:10] + genes[-10:]
    pseudo = between_slice_scan(small, gw_genes)

    # (e, f) PASTE through 2,000-cell references, cell directions, the center
    pair = paste_sections()
    torch.cuda.reset_peak_memory_stats()
    aligned, refs, pi, log, st_e = paste_main(pair)
    err = rotation_error_deg(refs[1].uns["models_align"]["R"])
    check(pi.shape == (refs[0].n_obs, refs[1].n_obs) and bool(np.isfinite(pi).all()), "PASTE plan")
    check(abs(err - PASTE_CPU_ROTATION_ERR) <= PASTE_ANGLE_BAR,
          f"PASTE rotation error {err} deg, the CPU's {PASTE_CPU_ROTATION_ERR} (bar {PASTE_ANGLE_BAR})")
    check("align_spatial" in aligned[1].obsm and "V_mapping" in refs[0].obsm, "PASTE outputs")
    from spateo_tpu_torch.alignment.methods.paste import paste_pairwise_align

    _, wall, busy, launches, _ = device_profile(
        lambda: paste_pairwise_align(refs[0], refs[1], spatial_key="spatial", numItermax=PASTE_PROFILED_ITERS,
                                     verbose=False, device="cuda"))
    print(f"phase 18: paste_align_ref {SVG_CELLS}-cell pair through {refs[0].n_obs}- and {refs[1].n_obs}-cell TRN "
          f"references (units of {PASTE_UNIT} DNB, planted rotation {PASTE_ANGLE} deg): {st_e['paste_align_ref']!r} "
          f"s a pair, FGW {log.seconds[0]!r} s, {log.iterations[0]} outer iterations; rotation error {err!r} deg "
          f"(the CPU's {PASTE_CPU_ROTATION_ERR} +- {PASTE_ANGLE_BAR}); the FGW pair's first {PASTE_PROFILED_ITERS} "
          f"outer iterations under torch.profiler wall {wall!r} ms, busy {busy!r} ms, idle "
          f"share {1 - busy / wall!r}, {launches} launches; cell_directions {st_e['cell_directions']!r} s; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 1e9!r} GB")
    sections = [cortex_section(1_000, 200, seed=s, unit=PASTE_UNIT) for s in (4, 5, 6)]
    with fgw_log("cuda") as log:
        t0 = time.perf_counter()
        center, pis = stt.align.paste_center_align(sections[0].copy(), sections, numItermax=CENTER_FGW_ITERS,
                                                   verbose=False, device="cuda")
        t_c = time.perf_counter() - t0
    check(len(pis) == 3 and center.uns["paste_W"].shape == (1_000, 15) and np.asarray(center.X).min() >= 0,
          "paste_center_align outputs")
    print(f"phase 18: paste_center_align 3 x 1,000 cells x 200 genes (n_components 15, max_iter 10, FGW numItermax "
          f"{CENTER_FGW_ITERS}): {t_c!r} s, "
          f"{len(log.seconds)} FGW solves ({sum(log.seconds)!r} s, outer iterations {log.iterations}); phase 18 "
          f"took {time.perf_counter() - t_phase!r} s")
    return small, pseudo, gw_genes


def between_slice_scan(small, gw_genes):
    """Phase 18d: `cal_gro_wass_bs` between `small` and a second section's
    400-cell sample over `gw_genes`, on the counts and on the counts plus
    1. Returns the two pseudocounted samples, for phase 19."""
    import spateo_tpu_torch as stt

    # 5 bootstrap rounds. A gene with a zero count in some cell makes its GW
    # NaN in the first outer iteration (log 0 rows), which stops the loop;
    # the table reports 0, as in the JAX package (ROADMAP Queue 3), so these
    # seconds are a time to NaN. The same scan on the counts plus a
    # pseudocount (no zero bin) runs every solve to its stop; phase 19 holds
    # it against the CPU.
    small2, _ = stt.svg.smoothing_and_sampling(cortex_section(seed=1), downsampling=SVG_DOWNSAMPLE, device="cuda")
    with fgw_log("cuda") as log:
        t0 = time.perf_counter()
        gw, b1, b2 = stt.svg.cal_gro_wass_bs(small, small2, gene_set=gw_genes, bootstrap=5, device="cuda", **SVG_KW)
        t_gw = time.perf_counter() - t0
    d = gw["Gromov-wasserstein_distance"].values
    n_nan = log.finite.count(False)
    check(len(gw) == len(gw_genes) and bool(np.isfinite(d).all() and (d >= -1e-6).all()), f"GW table {gw.shape}")
    check(0 < len(log.iterations) <= 6 * len(gw_genes) and all(fin or it == 1 for it, fin in zip(log.iterations, log.finite)),
          f"GW solves: iterations {log.iterations}, finite {log.finite}")
    print(f"phase 18: cal_gro_wass_bs {len(gw_genes)} genes x 6 rounds ({len(log.seconds)} GW solves at {b1.n_obs}x{b2.n_obs}): "
          f"{t_gw!r} s; {n_nan} solves NaN at the first outer iteration (a zero-count cell), reported as 0; the "
          f"rest ({log.finite.count(True)}) ran {sorted(set(i for i, f in zip(log.iterations, log.finite) if f))} "
          f"outer x 100 inner iterations")
    pseudo = [pseudocounted(x) for x in (small, small2)]
    n_solves = len(gw_genes) * (SVG_GW_PSEUDO_BOOTSTRAP + 1)
    with fgw_log("cuda") as log:
        t0 = time.perf_counter()
        gw_p, _, _ = stt.svg.cal_gro_wass_bs(*pseudo, gene_set=gw_genes, bootstrap=SVG_GW_PSEUDO_BOOTSTRAP,
                                             device="cuda", **SVG_KW)
        t_gwp = time.perf_counter() - t0
    d = gw_p["Gromov-wasserstein_distance"].values
    check(len(log.iterations) == n_solves and all(log.finite) and min(log.iterations) >= 2,
          f"GW solves on pseudocounts: iterations {log.iterations}, finite {log.finite}")
    check(bool((d > 0).all() and np.isfinite(gw_p["zscore"]).all()), f"GW table on pseudocounts {d}")
    print(f"phase 18: cal_gro_wass_bs on the counts + 1 (no zero bin), {len(gw_genes)} genes x "
          f"{SVG_GW_PSEUDO_BOOTSTRAP + 1} "
          f"rounds: {t_gwp!r} s, {n_solves} GW solves, all finite, {sum(log.seconds) / n_solves!r} s a solve, outer "
          f"iterations min {min(log.iterations)} median {float(np.median(log.iterations))!r} max "
          f"{max(log.iterations)} (of 30); GW in [{float(d.min())!r}, {float(d.max())!r}]")
    return pseudo


def pseudocounted(adata):
    """A copy of `adata` with dense counts plus 1 in every cell and gene."""
    out = adata.copy()
    X = out.X.toarray() if hasattr(out.X, "toarray") else np.asarray(out.X)
    out.X = (X + 1).astype(np.float32)
    return out


class outer_iterations:
    """Within the block, every `ops.ot.fgw` call runs `n` outer iterations
    (whatever its caller asks); `n` None leaves it as it is."""

    def __init__(self, n):
        self.n = n

    def __enter__(self):
        from spateo_tpu_torch.ops import ot

        self.orig = orig = ot.fgw
        if self.n is not None:
            ot.fgw = lambda *args, **kwargs: orig(*args, **dict(kwargs, max_iter=self.n))
        return self

    def __exit__(self, *exc):
        from spateo_tpu_torch.ops import ot

        ot.fgw = self.orig


def gw_scan(inputs, genes, device, seeds=(0, 1), outer=None):
    """`cal_gw_dis_on_genes` as `cal_gro_wass_bs` calls it, for each
    bootstrap seed (0 the observed round): the GW values of all seeds and
    the outer iterations of each solve."""
    from spateo_tpu_torch.svg.get_svg_between_slice import cal_gw_dis_on_genes

    with fgw_log(device) as log, outer_iterations(outer):
        d = [cal_gw_dis_on_genes(inputs, (seed, genes), device=device)[1] for seed in seeds]
    return np.concatenate(d), log.iterations


def slice_pair(n=500, g=30, angle_deg=20.0, shift=(2.0, -1.0), noise=0.03, seed=0, unit=1.0):
    """tests/test_alignment.py's `make_slice_pair` (sin/cos expression
    fields, B a rotated and shifted copy of A with noise) as the port's
    AnnData, coordinates times `unit`."""
    import pandas as pd

    import spateo_tpu_torch as stt

    rng = np.random.default_rng(seed)
    coordsA = rng.uniform(0, 10, (n, 2)).astype(np.float32)
    th = np.deg2rad(angle_deg)
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]], dtype=np.float32)
    coordsB = coordsA @ R.T + np.asarray(shift, np.float32) + rng.normal(0, noise, (n, 2)).astype(np.float32)
    f1, f2 = np.linspace(0.3, 2.0, g), np.linspace(0.2, 1.5, g)

    def expr(c):
        out = np.stack([np.sin(c[:, 0] * a) + np.cos(c[:, 1] * b) for a, b in zip(f1, f2)], 1)
        return np.abs(out - out.min() + 0.1).astype(np.float32)

    expA = expr(coordsA) + np.abs(rng.normal(0, 0.02, (n, g)))
    expB = expr(coordsA) + np.abs(rng.normal(0, 0.02, (n, g)))
    out = []
    for X, c in ((expA, coordsA), (expB, coordsB)):
        a = stt.AnnData(X=X, var=pd.DataFrame(index=[f"g{i}" for i in range(g)]))
        a.obsm["spatial"] = (c * np.float32(unit)).astype(np.float32)
        stt.SKM.init_adata_type(a, "UMI")
        out.append(a)
    return out


#: Phase 19's bars, card against CPU. After 50 outer iterations a PASTE
#: plan has sharpened (99% of its entries 0) and float32 differences have
#: grown: the JAX package and the port's CPU path lie 6.8e-4 (plan, of
#: scale) and 4.8e-4 (objective) apart on this pair on the CPU, so
#: that comparison is held to `PLAN_BAR_50`; after one outer iteration they
#: lie 2.3e-5 and 5.1e-6 apart, held to `PLAN_BAR`.
SCAN_REL_BAR, PLAN_BAR, PLAN_BAR_50, OBJ_BAR, NMF_BAR = 1e-4, 1e-4, 2e-3, 1e-4, 1e-6


def rel_err(a, b):
    """Largest absolute difference over the largest magnitude of `b`."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


#: Phase 19's scan genes: **cut from 200 to 50** (the script's time limit: the
#: CPU side of the 200-gene scan takes ~100 s).
SCAN_CVC_GENES = 50


def phase_svg_paste_cuda_vs_cpu(small, pseudo, gw_genes):
    """Phase 19: the scan, the between-slice scan's GW, PASTE and the NMF on
    the card against the CPU, on the same inputs (the scan on phase 18's
    400-cell sample, the between-slice scan on 18d's pseudocounted
    samples and genes)."""
    import spateo_tpu_torch as stt
    from spateo_tpu_torch.alignment.methods import paste as tpaste
    from spateo_tpu_torch.svg import utils as tsu
    from spateo_tpu_torch.svg.get_svg import bin_scale_adata_get_distance

    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    t_phase = time.perf_counter()
    # the scan: 400 cells x SCAN_CVC_GENES genes, one chunk, both devices
    M, A = scan_inputs(small)
    A = A[:SCAN_CVC_GENES]
    eps = float(max(M.max() * 5e-3, 1e-6))
    res = {}
    for key, dev in (("card", "cuda"), ("cpu", "cpu")):
        t = [torch.from_numpy(x).to(dev) for x in (A, np.full(len(M), 1 / len(M), np.float32), M)]
        d, it = tsu._sinkhorn_batch_run(*t, eps, 200)
        res[key] = (d.cpu().numpy(), it)
    scan_err = rel_err(res["card"][0], res["cpu"][0])
    check(scan_err <= SCAN_REL_BAR and res["card"][1] == res["cpu"][1],
          f"scan card vs CPU {scan_err}, sweeps {res['card'][1]} / {res['cpu'][1]}")
    # the between-slice scan's solves (18d's pseudocounted samples and genes,
    # its eps, alpha 1), the observed round and one bootstrap round. On its
    # DNB costs |grad| / eps reaches ~1e6 in the log-domain plan, which
    # float32 resolves to a few % an entry (ROADMAP Queue 3): there each
    # solve is cut to one outer iteration and the card is held to 3x the
    # CPU's own spread when one cost matrix moves by one ulp. On the same
    # costs over their largest entry (the same plans in exact arithmetic) two
    # genes run all their outer iterations, to OBJ_BAR.
    (b1, C1), (b2, C2) = (bin_scale_adata_get_distance(x, **SVG_KW) for x in pseudo)
    C1, C2 = C1.astype(np.float32), C2.astype(np.float32)
    dnb_genes = gw_genes[:2] + gw_genes[-2:]  # 4 of 18d's 20 (the time limit: ~100 CPU solves saved)
    dnb = {key: gw_scan((c1, c2, b1, b2), dnb_genes, dev, outer=1) for key, dev, c1, c2 in (
        ("card", "cuda", C1, C2), ("cpu", "cpu", C1, C2), ("C1 up", "cpu", np.nextafter(C1, np.float32(np.inf)), C2),
        ("C2 down", "cpu", C1, np.nextafter(C2, np.float32(0))))}
    spread = max(rel_err(dnb[k][0], dnb["cpu"][0]) for k in ("C1 up", "C2 down"))
    dnb_err, dnb_bar = rel_err(dnb["card"][0], dnb["cpu"][0]), max(3 * spread, OBJ_BAR)
    check(dnb_err <= dnb_bar and dnb["card"][1] == dnb["cpu"][1] == [1] * 2 * len(dnb_genes),
          f"between-slice scan on DNB costs card vs CPU after one outer iteration {dnb_err} (bar {dnb_bar}), solves "
          f"{dnb['card'][1]} / {dnb['cpu'][1]}")
    scale = float(max(C1.max(), C2.max()))
    two = [gw_genes[0], gw_genes[-1]]
    unit = {key: gw_scan((C1 / scale, C2 / scale, b1, b2), two, dev, seeds=(0,)) for key, dev in (("card", "cuda"),
                                                                                                  ("cpu", "cpu"))}
    unit_err = rel_err(unit["card"][0], unit["cpu"][0])
    check(unit_err <= OBJ_BAR and unit["card"][1] == unit["cpu"][1],
          f"between-slice GW on unit costs card vs CPU {unit_err}, outer iterations {unit['card'][1]} / "
          f"{unit['cpu'][1]}")
    # a 500-cell PASTE pair: one outer iteration (the mirror step's
    # arithmetic), and 50, over which float32 differences grow as the plan
    # sharpens (ROADMAP Queue 3)
    A5, B5 = slice_pair(500, unit=0.05)
    out = {}
    for k in (1, 50):
        for key, dev in (("card", "cuda"), ("cpu", "cpu")):
            with fgw_log(dev) as log:
                pi, obj = stt.align.paste_pairwise_align(A5, B5, numItermax=k, verbose=False, device=dev)
            out[k, key] = (pi, obj, log.iterations[0])
    plan_err = {k: rel_err(out[k, "card"][0], out[k, "cpu"][0]) for k in (1, 50)}
    obj_err = {k: abs(out[k, "card"][1] - out[k, "cpu"][1]) / abs(out[k, "cpu"][1]) for k in (1, 50)}
    for k, bar in ((1, PLAN_BAR), (50, PLAN_BAR_50)):
        check(plan_err[k] <= bar and obj_err[k] <= bar and out[k, "card"][2] == out[k, "cpu"][2],
              f"PASTE card vs CPU after {k} outer iterations: plan {plan_err[k]}, objective {obj_err[k]} (bar {bar}), "
              f"outer iterations {out[k, 'card'][2]} / {out[k, 'cpu'][2]}")
    # the NMF of the center loop
    X = np.asarray(cortex_section(1_000, 200, seed=4).X.toarray(), np.float64)
    nmf = {key: tpaste.KLNMF(15, 0, device=dev) for key, dev in (("card", "cuda"), ("cpu", "cpu"))}
    WH = {key: m.fit_transform(X) @ m.components_ for key, m in nmf.items()}
    nmf_err = rel_err(WH["card"], WH["cpu"])
    check(nmf_err <= NMF_BAR and nmf["card"].n_iter_ == nmf["cpu"].n_iter_, f"NMF card vs CPU {nmf_err}")
    print(f"phase 19: card vs CPU: scan {A.shape[0]} genes x {len(M)} cells scores {scan_err!r} relative (bar "
          f"{SCAN_REL_BAR}), {res['card'][1]} sweeps on both; the between-slice scan on the counts + 1, "
          f"{len(dnb_genes)} genes x 2 rounds on DNB costs after one outer iteration a solve {dnb_err!r} of scale (bar "
          f"{dnb_bar!r}: 3x the CPU's one-ulp spread {spread!r}), on unit costs 2 genes {unit_err!r} (bar {OBJ_BAR}), "
          f"outer iterations {unit['card'][1]} on both; PASTE 500-cell pair after 1 outer iteration plan "
          f"{plan_err[1]!r} of scale, objective {obj_err[1]!r} (bar {PLAN_BAR}), after 50 plan {plan_err[50]!r}, "
          f"objective {obj_err[50]!r} (bar {PLAN_BAR_50}), {out[50, 'card'][2]} outer iterations on both; NMF 1,000 x "
          f"200, 15 components W @ H {nmf_err!r} (bar {NMF_BAR}), {nmf['card'].n_iter_} iterations on both; phase 19 "
          f"took {time.perf_counter() - t_phase!r} s")


#: The E9.5-like stack of phase 20: an ellipsoid embryo (semi-axes x, y, z,
#: the long axis along z) whose mesh is the convex hull of E95_SURFACE
#: surface points (~2 x E95_SURFACE faces), cut into E95_SECTIONS sections of
#: E95_CELLS cells, each shifted by up to E95_SHIFT and rotated by up to
#: E95_ROT_DEG about the axis (planted).
E95_AXES = (1.0, 0.5, 1.6)
E95_SURFACE, E95_SECTIONS, E95_CELLS = 10_000, 20, 5_000
E95_SHIFT, E95_ROT_DEG = 0.15, 5.0
#: `Mesh_correction`'s defaults but the annealing steps: 2 of 10 (the time limit).
E95_LABELS, E95_FASTPD_ITER, E95_STEPS = 15, 100, 2
#: `st.pp` at the scale of a Stereo-seq section's cell bins.
PP_CELLS, PP_GENES, PCA_CELLS, PCA_GENES, PCA_HVG, PCA_COMPS = 20_000, 2_000, 5_000, 3_000, 2_000, 50


def e95_stack(n_sections=E95_SECTIONS, n_cells=E95_CELLS, n_surface=E95_SURFACE, seed=0):
    """The ellipsoid mesh (`tdr.Mesh`) and its drifted sections (AnnData with
    `.obsm['spatial']`), their heights, planted shifts and rotations (deg)."""
    from scipy.spatial import ConvexHull

    import spateo_tpu_torch as stt

    rng = np.random.default_rng(seed)
    ax = np.asarray(E95_AXES)
    sp = rng.normal(size=(n_surface, 3))
    sp = sp / np.linalg.norm(sp, axis=1, keepdims=True) * ax
    mesh = stt.tdr.Mesh(sp, ConvexHull(sp).simplices)
    z_heights = np.linspace(-0.85, 0.85, n_sections) * ax[2]
    slices, shifts, angles = [], [], []
    for z in z_heights:
        a = np.sqrt(1 - (z / ax[2]) ** 2)
        th, rr = rng.uniform(0, 2 * np.pi, n_cells), np.sqrt(rng.uniform(0, 1, n_cells))
        pts = np.stack([a * ax[0] * rr * np.cos(th), a * ax[1] * rr * np.sin(th)], 1)
        ang = rng.uniform(-E95_ROT_DEG, E95_ROT_DEG)
        c, s = np.cos(np.deg2rad(ang)), np.sin(np.deg2rad(ang))
        shift = rng.uniform(-E95_SHIFT, E95_SHIFT, 2)
        ad = stt.AnnData(X=np.ones((n_cells, 2), np.float32))
        stt.SKM.init_adata_type(ad, "UMI")
        ad.obsm["spatial"] = pts @ np.array([[c, -s], [s, c]]).T + shift
        slices.append(ad)
        shifts.append(shift)
        angles.append(ang)
    return mesh, slices, z_heights, np.asarray(shifts), np.asarray(angles)


def mesh_correction_run(device, n_sections, n_cells, label_num, steps, n_surface=E95_SURFACE, fastpd_iter=E95_FASTPD_ITER):
    """`Mesh_correction` on an `e95_stack`: contours, `steps` annealed steps,
    the correction. Returns the model, the stack's planted shifts, the
    seconds of the contours, the steps and the correction, and the mean
    distance of the corrected and the drifted sections' centroids from the
    axis."""
    import spateo_tpu_torch as stt

    mesh, slices, z, shifts, _ = e95_stack(n_sections, n_cells, n_surface)
    mc = stt.align.Mesh_correction(slices, z, mesh, label_num=label_num, fastpd_iter=fastpd_iter, max_iter=steps,
                                   device=device)
    t0 = time.perf_counter()
    mc.extract_contours(alpha_shape_kwargs={"alpha": 2.0})
    t1 = time.perf_counter()
    mc.run_discrete_optimization()
    t2 = time.perf_counter()
    out = mc.perform_correction()
    t3 = time.perf_counter()
    resid = float(np.mean([np.linalg.norm(o[:, :2].mean(0)) for o in out]))
    drift = float(np.mean([np.linalg.norm(s.obsm["spatial"].mean(0)) for s in slices]))
    return mc, shifts, (t1 - t0, t2 - t1, t3 - t2), resid, drift


def pp_counts(n_cells, n_genes, seed=0):
    """Sparse Poisson counts, gene means from Gamma(0.5, 1): CSR float32."""
    from scipy import sparse

    rng = np.random.default_rng(seed)
    lam = rng.gamma(0.5, 1.0, n_genes)
    return sparse.csr_matrix(rng.poisson(lam, (n_cells, n_genes)).astype(np.float32))


def phase_e95(stt):
    """Phase 20: coarse alignment, mesh correction, `st.pp` and the two
    k-means on the card at full width."""
    import tempfile

    import bench
    from spateo_tpu_torch.ops import kmeans as km

    t_phase = time.perf_counter()
    # warm-up: first calls of the batched ops at a small size
    mesh_correction_run("cuda", 4, 400, 5, 1, n_surface=400)

    mesh, slices, z, shifts, angles = e95_stack()
    t0 = time.perf_counter()
    pca = [stt.tl.align_slices_pca(s) for s in slices]
    t_pca = time.perf_counter() - t0
    err = [abs((np.rad2deg(np.arctan2(p.uns["pca_align_R"][0, 1], p.uns["pca_align_R"][0, 0])) - a + 90) % 180 - 90)
           for p, a in zip(pca, angles)]
    # the sample principal axis of 5,000 cells in a 2:1 ellipse lies ~0.5 deg (sd) off the true one
    check(max(err) < 3.0, f"align_slices_pca: principal axis {max(err)} deg off the planted rotation")
    X = np.asarray(slices[10].obsm["spatial"])
    th = np.deg2rad(20.0)
    R20 = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    Y = X @ R20.T + np.array([0.3, -0.2])
    t0 = time.perf_counter()
    d, Zp, tform = stt.tl.procrustes(X, Y)
    t_proc = time.perf_counter() - t0
    # Y @ T maps Y back onto X, so T is the planted rotation itself
    rot_err = np.rad2deg(float(np.abs(tform["rotation"] - R20).max()))
    check(float(np.abs(Zp - X).max()) < 1e-9 and rot_err < 1e-6, f"procrustes: residual {np.abs(Zp - X).max()}, "
          f"rotation {rot_err} deg off")
    print(f"phase 20: align_slices_pca on {E95_SECTIONS} sections of {E95_CELLS:,} cells: {t_pca!r} s, principal "
          f"axes {max(err)!r} deg (max) off the planted rotations; procrustes of one section onto its 20 deg "
          f"rotated, shifted copy: {t_proc!r} s, residual {float(np.abs(Zp - X).max())!r}, rotation error "
          f"{rot_err!r} deg")

    # mesh correction at the defaults, 2 annealed steps of 10
    torch.cuda.reset_peak_memory_stats()
    mc, shifts, (t_cont, t_opt, t_corr), resid, drift = mesh_correction_run(
        "cuda", E95_SECTIONS, E95_CELLS, E95_LABELS, E95_STEPS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(len(mc.step_stats) == E95_STEPS and mc.best_loss < 1.0, f"mesh correction: best loss {mc.best_loss}")
    check(resid < drift, f"mesh correction: residual drift {resid} not below the planted {drift}")
    for i, s in enumerate(mc.step_stats):
        icps = s["icps"]
        print(f"phase 20: Mesh_correction step {i + 1} (L {E95_LABELS}, {E95_SECTIONS} x {E95_CELLS:,} cells, "
              f"{mesh.n_faces:,} faces): {s['step_s']!r} s; tables {s['tables_s']!r} s (sections {s['sections_s']!r}), "
              f"fastpd {s['fastpd_s']!r} s, chosen loss {s['loss_s']!r} s; {icps:,} ICPs, {icps / s['step_s']!r} "
              f"ICPs/s; shares: tables {s['tables_s'] / s['step_s']!r} (sections "
              f"{s['sections_s'] / s['step_s']!r}), fastpd {s['fastpd_s'] / s['step_s']!r}")
    _, wall, busy, launches, ops = device_profile(mc.discrete_optimization_step)
    top = ", ".join(f"{short_op(k)} {v[0]:.1f} ms" for k, v in list(ops.items())[:4])
    print(f"phase 20: one step under the profiler: {wall!r} ms, device busy {busy!r} ms, idle share "
          f"{1 - busy / wall!r}, {launches} launches; top ops {top}")
    print(f"phase 20: contours {t_cont!r} s, {E95_STEPS} steps {t_opt!r} s, correction {t_corr!r} s; best loss "
          f"{mc.best_loss!r}, best transformation {mc.best_transformation}; residual drift {resid!r} against the "
          f"planted {drift!r}; peak device memory {peak_gb!r} GB")

    # st.pp: normalize_total and TMM on 20,000 x 2,000, group_pca of two sections
    counts = pp_counts(PP_CELLS, PP_GENES)
    ad = stt.AnnData(X=counts.copy())
    t0 = time.perf_counter()
    stt.pp.normalize_total(ad, target_sum=1e4)
    t_norm = time.perf_counter() - t0
    stt.pp.calcNormFactors(counts[:1000], method="TMM")  # warm-up
    t0 = time.perf_counter()
    f = stt.pp.calcNormFactors(counts, method="TMM")
    t_tmm = time.perf_counter() - t0
    sums = np.asarray(ad.X.sum(1)).ravel()
    check(np.allclose(sums[sums > 0], 1e4) and f.shape == (PP_CELLS,) and bool(np.isfinite(f).all() and (f > 0).all()),
          "normalize_total / TMM")
    pair = []
    for k in range(2):
        a = stt.AnnData(X=pp_counts(PCA_CELLS, PCA_GENES, seed=10 + k))
        stt.pp.log1p(a)
        pair.append(a)
    t0 = time.perf_counter()
    stt.align.group_pca(pair, hvg_top=PCA_HVG, n_comps=PCA_COMPS)
    t_gpca = time.perf_counter() - t0
    check(all(a.obsm["X_pca"].shape == (PCA_CELLS, PCA_COMPS) and np.isfinite(a.obsm["X_pca"]).all() for a in pair),
          "group_pca")
    print(f"phase 20: normalize_total {PP_CELLS:,} x {PP_GENES:,} ({counts.nnz:,} nonzeros) {t_norm!r} s; "
          f"calcNormFactors TMM {t_tmm!r} s (factors in [{float(f.min())!r}, {float(f.max())!r}]); group_pca of "
          f"2 x {PCA_CELLS:,} cells ({PCA_HVG:,} HVGs, {PCA_COMPS} components) {t_gpca!r} s")

    # the k-means paths, with no scikit-learn on this machine
    adata, _ = music_slice(10_000)
    coords = np.asarray(adata.obsm["spatial"], float)
    t0 = time.perf_counter()
    kmu = km.KMeans(n_clusters=500, random_state=0, n_init=10).fit(coords)
    t_km = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        model = stt.tl.MuSIC(
            adata=adata, mod_type="lr", species="human", output_path=f"{tmp}/music.csv", distr="poisson",
            custom_ligands=["TGFB1", "DLL1"], custom_receptors=["TGFBR1", "TGFBR2", "NOTCH1"],
            custom_targets=["TGT1"], kernel="bisquare", bw_fixed=False, bw=20, fit_intercept=True,
            spatial_subsample=True,
        )
        t0 = time.perf_counter()
        model.fit(verbose=False)
        t_music = time.perf_counter() - t0
    n_sub = len(model.subsampled_indices["TGT1"])
    check(0 < n_sub < 10_000 and len(np.unique(kmu.labels_)) == 500, f"MuSIC subsample: {n_sub} cells")
    pts, ptsA, Xg = bench._make_slice_pair(20000, seed=2)
    t0 = time.perf_counter()
    aligned, aligned_ref, _, _ = stt.align.morpho_align_ref(
        [bench._mk_adata(stt, pts, Xg), bench._mk_adata(stt, ptsA, Xg)], n_sampling=2000, sampling_method="kmeans",
        spatial_key="spatial", key_added="align", max_iter=200, verbose=False)
    t_ref = time.perf_counter() - t0
    rms = float(np.sqrt(((aligned[1].obsm["align"] - pts) ** 2).sum(1).mean()))
    n_ref = [m.n_obs for m in aligned_ref]
    check(rms < 0.1 and all(1000 < n <= 2000 for n in n_ref), f"morpho_align_ref(kmeans): RMS {rms}, refs {n_ref}")
    print(f"phase 20: KMeans(500, n_init 10) of 10,000 cells {t_km!r} s ({kmu.n_iter_} Lloyd iterations); "
          f"MuSIC(spatial_subsample=True).fit on 10,000 cells {t_music!r} s, TGT1 fitted on {n_sub:,} cells; "
          f"morpho_align_ref(sampling_method='kmeans') 20,000-cell pair through {n_ref} k-means references: "
          f"{t_ref!r} s, RMS to the truth {rms!r}; phase 20 {time.perf_counter() - t_phase!r} s")


def phase_e95_cuda_vs_cpu(stt):
    """Phase 21: the slice on the card against the CPU, at a small size."""
    from spateo_tpu_torch.alignment.methods import mesh_correction as mcm
    from spateo_tpu_torch.native import fastpd
    from spateo_tpu_torch.ops import kmeans as km
    from spateo_tpu_torch.tools.dimensionality_reduction import randomized_pca_centered

    t_phase = time.perf_counter()
    mesh, slices, z, _, _ = e95_stack(4, 800, 800, seed=1)
    m = {}
    for d in ("cuda", "cpu"):
        mc = stt.align.Mesh_correction(slices, z, mesh, label_num=5, fastpd_iter=E95_FASTPD_ITER, max_iter=1,
                                       device=d)
        mc.extract_contours(alpha_shape_kwargs={"alpha": 2.0})
        mc.contours_subsample, mc.z_heights_subsample = mc.contours, mc.z_heights
        mc.max_translation = mc.max_translation_scale * mc.slices_scale
        mc.best_transformation = {"rotation": np.zeros(3), "translation": 0.0, "scaling": 1.0}
        labels = mc.generate_labels()
        tables = mc.binary_tables(labels, mcm._make_pairs())
        m[d] = (tables, fastpd(mcm._getUnaries(5), tables, mcm._make_pairs(), E95_FASTPD_ITER))
    n_diff = sum(int((a != b).sum()) for a, b in zip(m["cuda"][0], m["cpu"][0]))
    # an entry differs only where an ICP meets a degenerate covariance (rounding noise): at most 1%
    check(n_diff <= 0.01 * 10 * 25, f"cost tables: {n_diff} of 250 entries differ")
    check(np.array_equal(m["cuda"][1], m["cpu"][1]) or n_diff > 0, "fastpd labels differ on equal tables")
    counts = pp_counts(2000, 300, seed=3).toarray().astype(float)
    f = {d: stt.pp.calcNormFactors(counts, method="TMM", device=d) for d in ("cuda", "cpu")}
    tmm_err = float(np.abs(f["cuda"] - f["cpu"]).max())
    check(tmm_err <= 1e-12, f"TMM card vs CPU {tmm_err}")
    X = pp_counts(1000, 400, seed=4)
    p = {d: randomized_pca_centered(X, 20, device=d)[0] for d in ("cuda", "cpu")}
    sgn = np.sign((p["cuda"] * p["cpu"]).sum(0))
    pca_err = float(np.abs(p["cuda"] * sgn - p["cpu"]).max() / np.abs(p["cpu"]).max())
    check(pca_err <= 1e-8, f"PCA card vs CPU {pca_err} of scale")
    pts = np.random.default_rng(5).uniform(0, 100, (5000, 2))
    km_err = {}
    for cls, kw in ((km.KMeans, dict(n_clusters=250, n_init=4)), (km.MiniBatchKMeans, dict(n_clusters=400, n_init=3))):
        g, c = (cls(random_state=0, device=d, **kw).fit(pts) for d in ("cuda", "cpu"))
        check(np.array_equal(g.labels_, c.labels_), f"{cls.__name__}: labels differ")
        km_err[cls.__name__] = float(np.abs(g.cluster_centers_ - c.cluster_centers_).max())
        check(km_err[cls.__name__] <= 1e-10 * 100, f"{cls.__name__}: centres {km_err[cls.__name__]}")
    print(f"phase 21: card vs CPU: cost tables of 4 sections at L 5, {n_diff} of 250 entries differ (bar 1%: a "
          f"degenerate ICP covariance), fastpd labels {m['cuda'][1].tolist()} / {m['cpu'][1].tolist()}; TMM "
          f"factors {tmm_err!r} (bar 1e-12); PCA {pca_err!r} of scale up to column signs (bar 1e-8); k-means labels "
          f"equal, centres {km_err} (bar 1e-8); phase 21 {time.perf_counter() - t_phase!r} s")


#: Phase 22: the E9.5 stack's cells, stacked at their planted heights with
#: no drift (E95_SECTIONS x E95_CELLS = 100,000), and TDR_SURFACE points on
#: the same ellipsoid's surface, the screened-Poisson input. The alpha shape
#: is host scipy (27 s at 100,000 cells on one CPU): it runs on
#: TDR_ALPHA_CELLS of the cells, a listed cut.
TDR_SURFACE, TDR_RES, TDR_ALPHA_CELLS = 100_000, 128, 20_000
TDR_NODES, TDR_CPU_CELLS, TDR_CPU_NODES, TDR_EPOCHS = 50, 20_000, 10, 500
TDR_STREAMS, TDR_STEPS, TDR_VOLUME_BAR = 100, 100, 0.01
#: Phase 23's bars, card against CPU (float32 paths: SimplePPT's EM, the
#: NLPCA's Adam steps; float64: ElPiGraph, the kernel density).
TDR_PPT_BAR, TDR_NLPCA_BAR = 1e-4, 1e-4


def e95_cloud(seed=0):
    """The cells of `e95_stack(seed=seed)` with the planted shifts and
    rotations undone, at their sections' heights: [sections x cells, 3]."""
    _, slices, z, shifts, angles = e95_stack(seed=seed)
    out = []
    for s, zk, sh, ang in zip(slices, z, shifts, angles):
        c, si = np.cos(np.deg2rad(ang)), np.sin(np.deg2rad(ang))
        xy = (np.asarray(s.obsm["spatial"]) - sh) @ np.array([[c, -si], [si, c]])
        out.append(np.c_[xy, np.full(len(xy), zk)])
    return np.concatenate(out)


def ellipsoid_surface(n, seed=0):
    p = np.random.default_rng(seed).normal(size=(n, 3))
    return p / np.linalg.norm(p, axis=1, keepdims=True) * np.asarray(E95_AXES)


def chamfer(a, b):
    """Symmetric mean nearest-neighbour distance between two point sets."""
    from scipy.spatial import cKDTree

    return 0.5 * (cKDTree(b).query(a)[0].mean() + cKDTree(a).query(b)[0].mean())


def phase_tdr(stt):
    """Phase 22: 3D reconstruction (`stt.tdr`) at full width on the E9.5
    stack's 100,000 cells and a 100,000-point surface."""
    from scipy.spatial import cKDTree

    from spateo_tpu_torch.tdr.models.models_backbone import backbone_methods as bm
    from spateo_tpu_torch.tdr.models.models_individual import reconstruction as rec
    from spateo_tpu_torch.tdr.models.models_individual.voxel import _marching_tetrahedra

    t_phase = time.perf_counter()
    cells = e95_cloud()
    ad = stt.AnnData(X=np.ones((len(cells), 2), np.float32))
    ad.obsm["spatial"] = cells
    ad.obs["section"] = np.repeat(np.arange(E95_SECTIONS), E95_CELLS).astype(str)
    pc, _ = stt.tdr.construct_pc(ad, groupby="section")
    surf = ellipsoid_surface(TDR_SURFACE)
    # warm-up: the first calls of each op at a small size
    stt.tdr.construct_surface(stt.tdr.PointCloud(surf[:3000]), cs_method="poisson", cs_args={"max_resolution": 32})
    bm.ElPiGraph_tree(cells[:2000], NumNodes=5)

    # 1. screened Poisson at max_resolution 128, normals estimated
    t0 = time.perf_counter()
    normals = rec.estimate_normals(surf)
    t_normals = time.perf_counter() - t0
    rec._splat_and_solve.host_reads = 0
    t0 = time.perf_counter()
    mesh, _, _ = stt.tdr.construct_surface(stt.tdr.PointCloud(surf), cs_method="poisson",
                                           cs_args={"max_resolution": TDR_RES, "normals": normals})
    t_surface = time.perf_counter() - t0
    iters, reads = rec._splat_and_solve.last_iterations, rec._splat_and_solve.host_reads
    vol, target = mesh.volume, 4.0 / 3.0 * np.pi * float(np.prod(E95_AXES))
    check(abs(vol - target) <= TDR_VOLUME_BAR * target, f"Poisson mesh volume {vol} against {target}")
    res, cell, origin = rec._poisson_frame(surf, 8, 0, 1.1, TDR_RES)
    pts_g = (surf - origin) / cell
    solve_ms = cuda_ms(lambda: rec._splat_and_solve(pts_g, normals, res, 4.0, 1e-5, 8 * res), n=3)
    (chi, rho), wall, busy, launches, ops = device_profile(
        lambda: rec._splat_and_solve(pts_g, normals, res, 4.0, 1e-5, 8 * res))
    top = ", ".join(f"{short_op(k)} {v[0]:.1f} ms" for k, v in list(ops.items())[:4])
    chi_np = chi.cpu().numpy().astype(float)
    t_mt, raw = host_ms(lambda: _marching_tetrahedra(chi_np, float(np.mean(rec._trilinear_sample(chi_np, pts_g))),
                                                     origin, cell))
    pg, nr = (torch.from_numpy(a.astype(np.float32)).cuda() for a in (pts_g, normals))
    bits = rec._splat_bits(len(pg), 1.0)
    check(torch.equal(rec._splat(pg, nr, res, bits), rec._splat(pg, nr, res, bits)), "the splat's bits differ")
    print(f"phase 22: poisson construct_surface of {TDR_SURFACE:,} surface points: res {res}, {iters} CG iterations, "
          f"{reads} host reads; {t_surface!r} s in all; splat + solve {solve_ms!r} ms (CUDA events), marching "
          f"tetrahedra {t_mt!r} ms, normals {t_normals * 1e3!r} ms (host); the solve under the profiler {wall!r} ms, "
          f"device busy {busy!r} ms, idle share {1 - busy / wall!r}, {launches} launches ({launches / max(iters, 1)!r} "
          f"an iteration); top ops {top}; volume {vol!r} (smoothed; unsmoothed {raw.volume!r}) against {target!r}; "
          f"{mesh.n_points:,} vertices, {mesh.n_faces:,} faces; the splat equal bit for bit on two runs")

    # 2. the alpha shape and voxels (host) on a subsample: a cut
    sub = cells[np.random.default_rng(1).choice(len(cells), TDR_ALPHA_CELLS, replace=False)]
    t0 = time.perf_counter()
    amesh, _, _ = stt.tdr.construct_surface(stt.tdr.PointCloud(sub))
    t_alpha = time.perf_counter() - t0
    t0 = time.perf_counter()
    vox, _ = stt.tdr.voxelize_mesh(amesh, voxel_pc=pc)
    t_vox = time.perf_counter() - t0
    check(amesh.n_faces > 0 and vox.n_points > 0, "alpha shape / voxels empty")
    print(f"phase 22: alpha-shape construct_surface of {TDR_ALPHA_CELLS:,} cells {t_alpha!r} s ({amesh.n_faces:,} "
          f"faces, volume {amesh.volume!r}); voxelize_mesh {t_vox!r} s ({vox.n_points:,} voxels)")

    # 3. ElPiGraph at 50 nodes on the 100,000 cells; the CPU path against the card at 20,000 x 10
    for k in ("host_reads", "steps", "fits"):
        setattr(bm.ElPiGraph_tree, k, 0)
    t0 = time.perf_counter()
    bb, length, _ = stt.tdr.construct_backbone(pc, rd_method="ElPiGraph", num_nodes=TDR_NODES)
    t_elpi = time.perf_counter() - t0
    steps, fits, reads = bm.ElPiGraph_tree.steps, bm.ElPiGraph_tree.fits, bm.ElPiGraph_tree.host_reads
    dist = float(cKDTree(bb.points).query(cells)[0].mean())
    check(bb.n_points == TDR_NODES and len(bb.edges) == TDR_NODES - 1 and steps == TDR_NODES - 2, "ElPiGraph tree")
    small = cells[np.random.default_rng(2).choice(len(cells), TDR_CPU_CELLS, replace=False)]
    t0 = time.perf_counter()
    ng, eg = bm.ElPiGraph_tree(small, NumNodes=TDR_CPU_NODES)
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    nc, ec = bm.ElPiGraph_tree(small, NumNodes=TDR_CPU_NODES, device="cpu")
    t_cpu = time.perf_counter() - t0
    check(np.array_equal(eg, ec) and np.abs(ng - nc).max() <= 1e-9, "ElPiGraph card vs CPU at 20,000 x 10")
    print(f"phase 22: construct_backbone ElPiGraph {len(cells):,} cells, {TDR_NODES} nodes: {t_elpi!r} s, {steps} "
          f"growth steps, {fits} candidate fits, {reads} host reads; length {length!r}, mean cell-to-node distance "
          f"{dist!r}; {TDR_CPU_CELLS:,} cells x {TDR_CPU_NODES} nodes: card {t_gpu!r} s, the port's CPU path "
          f"{t_cpu!r} s (x{t_cpu / t_gpu!r}), edges equal, nodes {float(np.abs(ng - nc).max())!r} apart")

    # 4. SimplePPT and PrinCurve
    t0 = time.perf_counter()
    bp, _, _ = stt.tdr.construct_backbone(pc, rd_method="SimplePPT", num_nodes=TDR_NODES)
    t_ppt = time.perf_counter() - t0
    t0 = time.perf_counter()
    bc, _, _ = stt.tdr.construct_backbone(pc, rd_method="PrinCurve", num_nodes=TDR_NODES, epochs=TDR_EPOCHS)
    t_pc = time.perf_counter() - t0
    X32 = torch.from_numpy((cells - cells.min(0)).astype(np.float32)).cuda()
    solver = bm.NLPCA().init_params(3, TDR_NODES)
    opt = torch.optim.Adam(solver.parameters(), lr=0.01)

    def epoch():
        opt.zero_grad(set_to_none=True)
        torch.sum((X32 - solver(X32)[0]) ** 2).backward()
        opt.step()

    ms_epoch = cuda_ms(epoch, n=50)
    check(bp.n_points == TDR_NODES and bc.n_points == TDR_NODES, "SimplePPT / PrinCurve nodes")
    print(f"phase 22: construct_backbone SimplePPT {t_ppt!r} s; PrinCurve ({TDR_EPOCHS} epochs) {t_pc!r} s, "
          f"{ms_epoch!r} ms an Adam epoch (CUDA events, {len(cells):,} cells, {TDR_NODES} hidden units)")

    # 5. morphometrics and the field streams
    t0 = time.perf_counter()
    morph = stt.tdr.model_morphology(mesh, pc=pc)
    t_morph = time.perf_counter() - t0
    t0 = time.perf_counter()
    kde, _ = stt.tdr.pc_KDE(pc, bandwidth=0.1)
    t_kde = time.perf_counter() - t0
    dens = kde.point_data["kde"]
    check(bool(np.isfinite(dens).all() and (dens > 0).all()), "pc_KDE")
    ad.obsm["V_mapping"] = np.cross([0.0, 0.0, 1.0], cells)
    t0 = time.perf_counter()
    stt.tdr.morphofield_sparsevfc(ad, spatial_key="spatial", V_key="V_mapping")
    t_vfc = time.perf_counter() - t0
    t0 = time.perf_counter()
    streams, _ = stt.tdr.construct_field_streams(ad, n_streams=TDR_STREAMS, n_steps=TDR_STEPS)
    t_streams = time.perf_counter() - t0
    check(streams.n_points == TDR_STREAMS * (TDR_STEPS + 1) and bool(np.isfinite(streams.points).all()), "streams")
    t0 = time.perf_counter()
    sim = stt.tdr.pairwise_shape_similarity(cells, raw.points)
    t_sim = time.perf_counter() - t0
    print(f"phase 22: model_morphology {t_morph!r} s ({morph}); pc_KDE of {len(cells):,} cells {t_kde!r} s; "
          f"morphofield_sparsevfc {t_vfc!r} s; construct_field_streams {TDR_STREAMS} x {TDR_STEPS} {t_streams!r} s; "
          f"pairwise_shape_similarity (cells, Poisson mesh) {sim!r} in {t_sim!r} s; phase 22 "
          f"{time.perf_counter() - t_phase!r} s")
    return bb


def phase_tdr_cuda_vs_cpu(stt):
    """Phase 23: the 3D reconstruction's device programs, card against CPU,
    at a small size."""
    from spateo_tpu_torch.tdr.models.models_backbone import backbone_methods as bm
    from spateo_tpu_torch.tdr.models.models_individual import reconstruction as rec
    from spateo_tpu_torch.tdr.morphometrics.morphology import kde_log_density

    t_phase = time.perf_counter()
    surf = ellipsoid_surface(5000, seed=3)
    normals = rec.estimate_normals(surf)
    res, cell, origin = rec._poisson_frame(surf, 8, 0, 1.1, 32)
    pts_g = (surf - origin) / cell
    out, iters, meshes = {}, {}, {}
    for d in ("cuda", "cpu"):
        chi, rho = rec._splat_and_solve(pts_g, normals, res, 4.0, 1e-5, 8 * res, device=d)
        out[d], iters[d] = (chi.cpu().numpy(), rho.cpu().numpy()), rec._splat_and_solve.last_iterations
        meshes[d] = rec.poisson_reconstruction(surf, normals=normals, max_resolution=32, device=d)
    chi_err, rho_err = (float(np.abs(g - c).max() / np.abs(c).max()) for g, c in zip(out["cuda"], out["cpu"]))
    ch = chamfer(meshes["cuda"].points, meshes["cpu"].points)
    check(chi_err <= 1e-5 and rho_err <= 1e-5 and abs(iters["cuda"] - iters["cpu"]) <= 1 and ch <= 1e-3 * cell,
          f"Poisson card vs CPU: chi {chi_err}, rho {rho_err}, iterations {iters}, Chamfer {ch}")
    cells = e95_cloud(seed=1)[::20]
    e = {d: bm.ElPiGraph_tree(cells, NumNodes=15, device=d) for d in ("cuda", "cpu")}
    elpi_err = float(np.abs(e["cuda"][0] - e["cpu"][0]).max())
    check(np.array_equal(e["cuda"][1], e["cpu"][1]) and elpi_err <= 1e-9, f"ElPiGraph card vs CPU {elpi_err}")
    p = {d: bm.SimplePPT_tree(cells, NumNodes=20, device=d) for d in ("cuda", "cpu")}
    ppt_err = float(np.abs(p["cuda"][0] - p["cpu"][0]).max() / np.abs(p["cpu"][0]).max())
    check(np.array_equal(p["cuda"][1], p["cpu"][1]) and ppt_err <= TDR_PPT_BAR, f"SimplePPT card vs CPU {ppt_err}")
    X = cells - cells.min(0)
    w = {d: bm.NLPCA(device=d).fit(X, epochs=100, nodes=25).params for d in ("cuda", "cpu")}
    nl_err = max(float(np.abs(w["cuda"][k] - w["cpu"][k]).max()) for k in w["cpu"])
    check(nl_err <= TDR_NLPCA_BAR, f"NLPCA card vs CPU {nl_err}")
    kde_err = max(float(np.abs(np.exp(kde_log_density(cells, k, 0.2, "cuda"))
                               / np.exp(kde_log_density(cells, k, 0.2, "cpu")) - 1).max())
                  for k in ("gaussian", "cosine"))
    check(kde_err <= 1e-10, f"pc_KDE card vs CPU {kde_err}")
    print(f"phase 23: card vs CPU: Poisson res {res} on 5,000 points chi {chi_err!r}, rho {rho_err!r} of scale (bar "
          f"1e-5), CG iterations {iters['cuda']} / {iters['cpu']}, meshes' Chamfer {float(ch / cell)!r} of a cell (bar 1e-3); "
          f"ElPiGraph {len(cells):,} cells x 15 nodes edges equal, nodes {elpi_err!r} (bar 1e-9); SimplePPT nodes "
          f"{ppt_err!r} of scale (bar {TDR_PPT_BAR}); NLPCA 100 epochs weights {nl_err!r} (bar {TDR_NLPCA_BAR}); "
          f"pc_KDE {kde_err!r} relative (bar 1e-10); phase 23 {time.perf_counter() - t_phase!r} s")


#: Phase 24: MuSIC's interpretation on `music_slice`'s 10,000 cells with
#: `music_tf_slice`'s genes; the permutations of `permutation_test` (its
#: default); `refine_alignment` on a REFINE_SIZE² stain/RNA pair planted from
#: `planted_disks`, the stain moved by REFINE_SHIFT pixels (y, x) and
#: REFINE_ROT_DEG degrees; the Frobenius center NMF of a NMF_CELLS-cell
#: section of `SVG_GENES` genes, NMF_COMPONENTS components (paste_center_align's).
#: `permutation_test`'s permutations: **cut from its default 100 to 40** (the
#: script's time limit; ~0.3 s a refit).
INTERP_PERMUTATIONS = 40
REFINE_SIZE, REFINE_EPOCHS, REFINE_SHIFT, REFINE_ROT_DEG = 4096, 100, (3.0, -2.0), 0.3
#: `refine_alignment` trains with the JAX package's Adam lr of 0.1; the
#: planted check trains the refiners through their own API at this lr.
REFINE_LR = 1e-3
#: The profiler's windows of phase 24's longest loops: refinement epochs,
#: NMF iterations, permutation refits.
PROFILED_EPOCHS, PROFILED_NMF_ITERS, PROFILED_FITS = 20, 20, 10
NMF_CELLS, NMF_COMPONENTS = 1_000, 15
#: Phase 25's bars (card against CPU): the DEG table and the permutation
#: effects (weights built on each device), the warps, theta after 100 epochs
#: on smooth blobs (rotation and shear are nearly flat there), the non-rigid
#: displacements, the Frobenius NMF's W and H.
INTERP_BAR, WARP_BAR, THETA_BAR, DISP_BAR, FNMF_BAR = 1e-4, 1e-5, 1e-2, 1e-5, 1e-8


def music_tf_slice(adata, seed=0):
    """`music_slice`'s AnnData (left as it is) copied with four genes
    appended: STAT3 ~ Poisson(1 + 0.8 TGFB1) and MYC ~ Poisson(1 + 0.8 DLL1)
    (each TF tracks a ligand, so a GLM of the ligand on the TFs finds it),
    JUN ~ Poisson(Gamma(0.5, 6)) unrelated (overdispersed, so that its log
    is not a second intercept), and GAPDH ~ Poisson(5), a housekeeping gene
    the molecule selector must drop."""
    import pandas as pd

    import spateo_tpu_torch as stt

    X = np.asarray(adata.X, np.float32)
    genes = list(map(str, adata.var_names))
    rng = np.random.default_rng(seed + 1)
    n = X.shape[0]
    extra = np.c_[rng.poisson(1 + 0.8 * X[:, genes.index("TGFB1")]), rng.poisson(rng.gamma(0.5, 6.0, n)),
                  rng.poisson(1 + 0.8 * X[:, genes.index("DLL1")]), rng.poisson(5.0, n)]
    out = stt.AnnData(X=np.c_[X, extra].astype(np.float32), obs=adata.obs.copy(),
                      var=pd.DataFrame(index=genes + ["STAT3", "JUN", "MYC", "GAPDH"]))
    out.obsm["spatial"] = np.array(adata.obsm["spatial"])
    stt.SKM.init_adata_type(out, stt.SKM.ADATA_UMI_TYPE)
    return out


def interpreter_for(model, adata, out_dir, device):
    """A `MuSIC_Interpreter` around a fitted `lr` model's output directory:
    the model's design carried over (`core.bridge.music_state_from_reference`
    reads any fitted `MuSIC`), the coefficients read from the directory."""
    import spateo_tpu_torch as stt
    from spateo_tpu_torch.core.bridge import music_state_from_reference

    interp = stt.tl.MuSIC_Interpreter(
        adata=adata, mod_type="lr", species="human", output_path=f"{out_dir}/music.csv", distr=model.distr,
        custom_ligands=["TGFB1", "DLL1"], custom_receptors=["TGFBR1", "TGFBR2", "NOTCH1"],
        custom_targets=list(model.targets), kernel="bisquare", bw_fixed=False, bw=model.bw, fit_intercept=True,
        device=device,
    )
    interp.load_state(music_state_from_reference(model))
    interp.load_coeffs()
    return interp


def timed_stage(fn, device, window=None, profile=True):
    """`fn()` timed on the host (synchronised), then, with `profile`,
    `window()` (default: `fn` again; a shorter run of the same loop where its
    events would take the profiler long to gather) under `device_profile` on
    the card: (result, seconds, idle share, launches)."""
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    seconds = time.perf_counter() - t0
    if torch.device(device).type != "cuda" or not profile:
        return out, seconds, None, None
    _, wall, busy, launches, _ = device_profile(window or fn)
    return out, seconds, 1 - busy / wall, launches


def refine_pair(n, shift=REFINE_SHIFT, rot_deg=REFINE_ROT_DEG, device="cuda"):
    """The RNA raster of `planted_disks(n)` (5 counts a disk pixel) and a
    stain of the same disks moved by `rot_deg` degrees about the centre and
    `shift` pixels (y, x), warped on `device` (intensity 200). Returns
    (rna, stain, theta): theta is the affine that maps the stain back onto
    the RNA, in `refine_alignment`'s normalized coordinates."""
    from spateo_tpu_torch.segmentation.align import _affine_warp

    rna = planted_disks(n).astype(np.float32) * 5.0
    th = np.deg2rad(rot_deg)
    A = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    t = np.array([shift[1] * 2 / n, shift[0] * 2 / n])
    theta = np.c_[A, t].astype(np.float32)
    inverse = np.c_[A.T, -A.T @ t].astype(np.float32)
    stain = _affine_warp(torch.from_numpy(rna).to(device), torch.from_numpy(inverse).to(device)).cpu().numpy()
    return rna, 200.0 * stain / 5.0, theta


def theta_px_error(theta, truth, n):
    """The largest distance, in pixels, between where `theta` and `truth`
    send the corners and the centre of the raster's inner 90%."""
    pts = np.array([[-0.9, -0.9], [0.9, -0.9], [-0.9, 0.9], [0.9, 0.9], [0.0, 0.0]])
    d = (pts @ theta[:, :2].T + theta[:, 2]) - (pts @ truth[:, :2].T + truth[:, 2])
    return float(np.abs(d).max() * n / 2)


def agg_adata(rna, stain):
    """An AGG AnnData of the port holding the RNA raster as X and the
    unspliced layer, and the stain layer."""
    import pandas as pd

    import spateo_tpu_torch as stt

    n = rna.shape[0]
    adata = stt.AnnData(X=rna, obs=pd.DataFrame(index=[str(i) for i in range(n)]),
                        var=pd.DataFrame(index=[str(j) for j in range(rna.shape[1])]))
    stt.SKM.init_adata_type(adata, stt.SKM.ADATA_AGG_TYPE)
    adata.layers["unspliced"] = rna
    adata.layers["stain"] = stain
    return adata


def phase_interpretation(n_cells=10_000, n_perm=INTERP_PERMUTATIONS, raster=REFINE_SIZE, nmf_genes=None,
                         device="cuda"):
    """Phase 24: MuSIC's interpretation, `refine_alignment` and the Frobenius
    center NMF at full width, each stage timed, profiled and checked against
    what was planted. Sizes are arguments so that the phase can rehearse on
    the CPU at a small size."""
    import tempfile

    import spateo_tpu_torch as stt
    from spateo_tpu_torch.alignment.methods.paste import FrobeniusNMF
    from spateo_tpu_torch.ops.image import conv2d
    from spateo_tpu_torch.segmentation import align as tal

    t_phase = time.perf_counter()
    nmf_genes = SVG_GENES if nmf_genes is None else nmf_genes
    report = {}
    base, effect = music_slice(n_cells)
    adata = music_tf_slice(base)
    senders = np.asarray(adata.obs["cell_type"] == "sender")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        model, coeffs, _, _, _, _ = music_fit(adata, tmp, device=device, search=(), fixed=("TGT1",))
        report["set-up: MuSIC.fit of TGT1"] = (time.perf_counter() - t0, None, None, "20 neighbours, poisson")
        means = check_music_effects(coeffs, {"TGT1": effect["TGT1"]}, "phase 24")
        pair = max(means["TGT1"], key=means["TGT1"].get)
        ligand, receptor = pair.split(":")
        interp = interpreter_for(model, adata, tmp, device)

        sig, report["significance"], idle, launches = timed_stage(interp.compute_coeff_significance, device)
        share = float(sig["TGT1"][f"b_{pair}"].values[np.asarray(effect["TGT1"])].mean())
        report["significance"] = (report["significance"], idle, launches, f"{pair} significant on {share!r} of TGT1's "
                                  "receivers")

        (P, ns, nr), s, idle, launches = timed_stage(
            lambda: interp.get_effect_potential(target="TGT1", ligand=ligand, receptor=receptor), device)
        sent = (float(np.abs(ns[senders]).mean()), float(np.abs(ns[~senders]).mean()))
        check(P.shape == (n_cells, n_cells) and sent[0] > sent[1],
              f"effect potential of {pair} on TGT1: senders' sent potential {sent[0]} against the others' {sent[1]}")
        report["effect potential"] = (s, idle, launches, f"{pair}: |sent| on senders {sent[0]!r}, others {sent[1]!r}; "
                                      f"{P.nnz:,} nonzeros")

        tfs = ["STAT3", "JUN", "MYC"]
        interp.CCI_deg_detection_setup(use_ligands=True, custom_tfs=tfs)
        _, s, idle, launches = timed_stage(lambda: interp.CCI_deg_detection(distr="poisson", fit_all=True), device)
        mols = list(interp._cci_deg_targets.columns)
        W_kept = interp._cci_deg_weights[1]
        driving_tf = {"TGFB1": "STAT3", "DLL1": "MYC"}
        found = {}
        for mol, tf in driving_tf.items():
            res = interp.CCI_deg_detection(mol, distr="poisson")
            top = res["coefficient"].idxmax()
            found[mol] = (top, bool(res.loc[tf, "significant"]), float(res.loc[tf, "coefficient"]))
            check(top == tf and bool(res.loc[tf, "significant"]),
                  f"CCI DEG of {mol}: {tf} not the significant TF of largest coefficient:\n{res}")
        check(interp._cci_deg_weights[1] is W_kept, "the downstream weights were rebuilt within one design")
        report["CCI DEG (fit_all)"] = (s, idle, launches, f"{len(mols)} molecules {mols} on {tfs}; the TF of largest "
                                       f"coefficient, whether the planted one is significant, its coefficient: {found}")

        t0 = time.perf_counter()
        perm = interp.permutation_test("TGT1", n_permutations=n_perm, seed=0)
        sync(device)
        s = time.perf_counter() - t0
        ev = interp.eval_permutation_test("TGT1")
        r_obs = float(ev.loc["nonpermuted", "Pearson correlation"])
        r_perm = ev.loc[[f"permutation_{i}" for i in range(n_perm)], "Pearson correlation"].to_numpy(float)
        p_corr = float(ev.loc["p-value", "Pearson correlation"])
        check(r_obs > r_perm.max() and p_corr <= 0.05,
              f"permutation test of TGT1: the fit's Pearson correlation {r_obs} against the permutations' (max "
              f"{r_perm.max()}), t-test p {p_corr}")
        report["permutation test"] = (
            s, None, None, f"{n_perm} permutations, {(n_perm + 1) / s!r} fits/s; eval: the fit's Pearson correlation "
            f"with TGT1 {r_obs!r} against the permutations' mean {float(r_perm.mean())!r} and max "
            f"{float(r_perm.max())!r}, t-test p "
            f"{p_corr!r}; the effect-size null's p-values (mean |coefficient|, the JAX package's summary) "
            f"{perm['perm_pvalue'].round(4).to_dict()}")
        if torch.device(device).type == "cuda":
            _, wall, busy, launches, _ = device_profile(
                lambda: interp.permutation_test("TGT1", n_permutations=PROFILED_FITS - 1, seed=0))
            report["permutation test"] = (s, 1 - busy / wall, launches, report["permutation test"][3]
                                          + f" (the profiler over a {PROFILED_FITS}-fit run)")

        def select():
            sel = stt.tl.MuSIC_Molecule_Selector(adata=adata.copy(), mod_type="lr", species="human",
                                                 output_path=f"{tmp}/select/out.csv", target_expr_threshold=0.05,
                                                 bw_fixed=False, device=device)
            sel.find_targets()
            return sel

        sel, s, idle, launches = timed_stage(select, device)
        check({"TGT1", "TGT2", "TGT3"} <= set(sel.targets) and "GAPDH" not in sel.targets
              and "TGFB1" in sel.ligands, f"find_targets: targets {sel.targets}, ligands {sel.ligands}")
        report["find_targets"] = (s, idle, launches, f"{len(sel.targets)} targets, {len(sel.ligands)} ligands, "
                                  f"{len(sel.receptors)} receptors")

    t0 = time.perf_counter()
    rna, stain, truth = refine_pair(raster, device=device)
    report["set-up: the planted pair"] = (time.perf_counter() - t0, None, None, f"{raster}²")
    for mode, kw in (("rigid", {}), ("non-rigid", {"binsize": raster // 4})):
        data = agg_adata(rna, stain)
        _, s, idle, launches = timed_stage(
            lambda: stt.cs.refine_alignment(data, mode=mode, n_epochs=REFINE_EPOCHS, device=device, **kw), device,
            lambda: stt.cs.refine_alignment(agg_adata(rna, stain), mode=mode, n_epochs=PROFILED_EPOCHS,
                                            device=device, **kw))
        params = stt.SKM.get_uns_spatial_attribute(data, stt.SKM.UNS_SPATIAL_ALIGNMENT_KEY)
        note = (f"theta {theta_px_error(params['theta'], truth, raster)!r} px from the planted transform at lr 0.1"
                if mode == "rigid" else
                f"largest displacement {float(max(np.abs(v).max() for v in params.values())) * raster / 2!r} px")
        report[f"refine_alignment {mode}"] = (s, idle, launches, f"{raster}², {REFINE_EPOCHS} epochs (the profiler over "
                                              f"{PROFILED_EPOCHS}); {note}")
    rna_s = conv2d(rna, 5, mode="gauss", device=device).cpu().numpy()
    for cls, kw in ((tal.RigidAlignmentRefiner, {}), (tal.NonRigidAlignmentRefiner, {"binsize": raster // 4})):
        ref = cls(rna_s, stain, device=device, **kw)
        _, s, _, _ = timed_stage(lambda: ref.train(REFINE_EPOCHS, lr=REFINE_LR), device)
        losses = (ref.losses[0], ref.losses[REFINE_EPOCHS - 1])
        check(losses[1] < 0.5 * losses[0], f"{cls.__name__} at lr {REFINE_LR}: loss {losses}")
        if cls is tal.RigidAlignmentRefiner:
            err = theta_px_error(ref.get_params()["theta"], truth, raster)
            check(err <= 1.0, f"rigid refinement at lr {REFINE_LR}: {err} px from the planted transform")
            note = f"planted shift {REFINE_SHIFT} px and {REFINE_ROT_DEG} deg recovered within {err!r} px"
        else:
            note = "displacements " + ", ".join(f"{k} {float(np.abs(v).max()) * raster / 2!r} px" for k, v in
                                                ref.get_params().items())
        report[f"{cls.__name__} lr {REFINE_LR}"] = (s, None, None, f"loss {losses[0]!r} -> {losses[1]!r}; {note}; "
                                                    f"{s / REFINE_EPOCHS * 1e3!r} ms an epoch")

    t0 = time.perf_counter()
    X = np.asarray(cortex_section(NMF_CELLS, nmf_genes, seed=4).X.toarray(), np.float64)
    report["set-up: the NMF's section"] = (time.perf_counter() - t0, None, None, f"{NMF_CELLS} x {nmf_genes}")
    nmf = FrobeniusNMF(NMF_COMPONENTS, 0, device=device)
    W, s, idle, launches = timed_stage(
        lambda: nmf.fit_transform(X), device,
        lambda: FrobeniusNMF(NMF_COMPONENTS, 0, max_iter=PROFILED_NMF_ITERS, device=device).fit_transform(X))
    fit = float(np.linalg.norm(X - W @ nmf.components_) / np.linalg.norm(X))
    check(np.isfinite(W).all() and W.min() >= 0 and nmf.components_.min() >= 0 and fit < 1.0,
          f"Frobenius NMF: relative residual {fit}")
    report["Frobenius center NMF"] = (s, idle, launches, f"{NMF_CELLS} x {nmf_genes}, {NMF_COMPONENTS} components: "
                                      f"{nmf.n_iter_} iterations, {s / nmf.n_iter_ * 1e3!r} ms an iteration, relative "
                                      f"residual {fit!r} (the profiler over {PROFILED_NMF_ITERS} iterations)")
    for stage, (s, idle, launches, note) in report.items():
        extra = "" if idle is None else f", idle share {idle!r}, {launches} launches under the profiler"
        print(f"phase 24: {stage}: {s!r} s{extra}; {note}")
    print(f"phase 24 took {time.perf_counter() - t_phase!r} s")


def small_interpreters(tmp, sides, n=600):
    """A 600-cell `music_tf_slice` fitted once on the CPU (TGT1, 20
    neighbours) and an interpreter of its output directory for each side
    (name -> device)."""
    base, _ = music_slice(n)
    adata = music_tf_slice(base)
    model, *_ = music_fit(adata, tmp, device="cpu", search=(), fixed=("TGT1",))
    return {k: interpreter_for(model, adata.copy(), tmp, d) for k, d in sides.items()}


def phase_interpretation_cuda_vs_cpu(card="cuda"):
    """Phase 25: phase 24's device work on the card against the CPU, at a
    small size (`card` names the first side's device)."""
    import tempfile

    from spateo_tpu_torch.alignment.methods.paste import FrobeniusNMF
    from spateo_tpu_torch.segmentation import align as tal

    t_phase = time.perf_counter()
    sides = {"card": card, "cpu": "cpu"}
    with tempfile.TemporaryDirectory() as tmp:
        it = small_interpreters(tmp, sides)
        deg, perm, spied = {}, {}, {}
        for k, interp in it.items():
            interp.CCI_deg_detection_setup(use_ligands=True, custom_tfs=["STAT3", "JUN", "MYC"])
            deg[k] = interp.CCI_deg_detection("TGFB1", distr="poisson")
            calls, orig = [], interp.mpi_fit

            def spy(y, X, *a, _orig=orig, _calls=calls, **kw):
                out = _orig(y, X, *a, **kw)
                _calls.append((np.array(y), np.array(out)))
                return out

            interp.mpi_fit = spy
            perm[k] = interp.permutation_test("TGT1", n_permutations=20, seed=0)
            spied[k] = calls
    deg_err = rel_err(deg["card"]["coefficient"].values, deg["cpu"]["coefficient"].values)
    check(list(deg["card"].index) == list(deg["cpu"].index) and deg_err <= INTERP_BAR,
          f"CCI DEG card vs CPU {deg_err}:\n{deg['card']}\n{deg['cpu']}")
    check(all(np.array_equal(a[0], b[0]) for a, b in zip(spied["card"], spied["cpu"])), "different permutations")
    eff_err = rel_err(perm["card"]["mean_abs_effect"], perm["cpu"]["mean_abs_effect"])
    stats = {k: np.stack([np.abs(b).mean(axis=0) for _, b in spied[k]]) for k in spied}
    scale = np.abs(stats["cpu"]).max()
    ge = {k: s[1:] >= s[0][None, :] for k, s in stats.items()}
    flipped = ge["card"] != ge["cpu"]
    near = np.minimum(*(np.abs(s[1:] - s[0]) for s in stats.values())) <= INTERP_BAR * scale
    check(eff_err <= INTERP_BAR and not (flipped & ~near).any(),
          f"permutation test card vs CPU: effects {eff_err}, flips away from ties {int((flipped & ~near).sum())}")

    yy, xx = np.mgrid[0:256, 0:256].astype(float)
    rna = 10 * np.exp(-((yy - 128) ** 2 + (xx - 124) ** 2) / (2 * 28.0**2))
    stain = 200 * np.exp(-((yy - 138) ** 2 + (xx - 129) ** 2) / (2 * 28.0**2))
    img = (stain / stain.max()).astype(np.float32)
    theta = np.array([[1.01, 0.02, 0.03], [-0.02, 0.99, -0.04]], np.float32)
    warp = {k: tal._affine_warp(torch.from_numpy(img).to(d), torch.from_numpy(theta).to(d)).cpu().numpy()
            for k, d in sides.items()}
    warp_err = float(np.abs(warp["card"] - warp["cpu"]).max())
    params = {}
    for mode, kw in (("rigid", {}), ("non-rigid", {"binsize": 64})):
        for k, d in sides.items():
            ref = tal.MODULES[mode](rna, stain, device=d, **kw)
            ref.train(100)
            params[mode, k] = ref.get_params()
    theta_err = float(np.abs(params["rigid", "card"]["theta"] - params["rigid", "cpu"]["theta"]).max())
    disp_err = max(float(np.abs(params["non-rigid", "card"][k] - params["non-rigid", "cpu"][k]).max())
                   for k in ("disp_y", "disp_x"))
    check(warp_err <= WARP_BAR and theta_err <= THETA_BAR and disp_err <= DISP_BAR,
          f"refine_alignment card vs CPU: warp {warp_err}, theta {theta_err}, displacements {disp_err}")

    X = np.asarray(cortex_section(300, 200, seed=4).X.toarray(), np.float64)
    nmf = {k: FrobeniusNMF(NMF_COMPONENTS, 0, device=d) for k, d in sides.items()}
    W = {k: m.fit_transform(X) for k, m in nmf.items()}
    w_err = rel_err(W["card"], W["cpu"])
    h_err = rel_err(nmf["card"].components_, nmf["cpu"].components_)
    check(w_err <= FNMF_BAR and h_err <= FNMF_BAR and nmf["card"].n_iter_ == nmf["cpu"].n_iter_,
          f"Frobenius NMF card vs CPU: W {w_err}, H {h_err}, iterations {nmf['card'].n_iter_} / {nmf['cpu'].n_iter_}")
    print(f"phase 25: card vs CPU: CCI DEG of TGFB1 on 600 cells coefficients {deg_err!r} of scale (bar {INTERP_BAR}); "
          f"permutation test, 20 permutations, the same scrambles, effects {eff_err!r} of scale (bar {INTERP_BAR}), "
          f"{int(flipped.sum())} comparisons flipped, all within {INTERP_BAR} of scale of a tie; p-values card "
          f"{perm['card']['perm_pvalue'].round(4).tolist()} CPU {perm['cpu']['perm_pvalue'].round(4).tolist()}; "
          f"affine warp 256² {warp_err!r} (bar {WARP_BAR}); 100 epochs on blobs: theta {theta_err!r} (bar {THETA_BAR}), "
          f"displacements {disp_err!r} (bar {DISP_BAR}); Frobenius NMF 300 x 200, {NMF_COMPONENTS} components: W "
          f"{w_err!r}, H {h_err!r} of scale (bar {FNMF_BAR}), {nmf['cpu'].n_iter_} iterations on both; phase 25 "
          f"{time.perf_counter() - t_phase!r} s")


def phase_starro_main(stt, bp_cuda, em, ts, make_raster):
    """Phase 3: the Starro main path on a 2048x2048 tile and a 4-tile stream.
    Returns the `bp_step` launches and fused-delta launches of the main path,
    and the tile's mask."""
    X = make_raster(TILE, TILE, seed=0)

    phase_stages(X, ts, em, bp_cuda, report=False)  # warm-up: first-call costs of each op
    bp_iters, stage_mask = phase_stages(X, ts, em, bp_cuda, report=True)

    adata = stt.AnnData(X=X)
    stt.SKM.init_adata_type(adata, stt.SKM.ADATA_AGG_TYPE)
    tiles = [make_raster(TILE, TILE, seed=s) for s in range(4)]
    torch.cuda.reset_peak_memory_stats()
    bp_cuda.bp_step.launches = bp_cuda.bp_step.delta_launches = 0
    t_main, _ = host_ms(
        lambda: stt.cs.score_and_mask_pixels(
            adata, "X", k=5, method="EM+BP", em_kwargs=dict(seed=0), bp_kwargs=dict(max_iter=50)
        )
    )
    launches_single = bp_cuda.bp_step.launches
    t_stream, streamed = host_ms(
        lambda: list(stt.cs.starro_em_bp_stream(tiles, k=5, seed=0, bp_max_iter=50, mask_only=True))
    )
    launches = bp_cuda.bp_step.launches
    delta_launches = bp_cuda.bp_step.delta_launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    check("X_scores" in adata.layers and "X_mask" in adata.layers, "scores/mask layers missing")
    scores, mask = adata.layers["X_scores"], adata.layers["X_mask"]
    check(mask.dtype == bool and mask.shape == X.shape, f"mask {mask.dtype} {mask.shape}")
    check(scores.shape == X.shape and bool(np.isfinite(scores).all()), "scores not finite or wrong shape")
    fg = float(mask.mean())
    check(0.01 <= fg <= 0.30, f"foreground share {fg} outside [0.01, 0.30]")
    check(launches_single >= bp_iters > 0, f"bp_step launched {launches_single} times, BP ran {bp_iters} iterations")
    check(launches >= launches_single + 4 * bp_iters, f"stream launched {launches - launches_single} kernels")
    # one fused delta ends each check block of up to 10 iterations, in each of the 5 tiles
    check(5 <= delta_launches <= launches <= 10 * delta_launches, f"fused delta launched {delta_launches} times "
          f"for {launches} iterations")
    check(len(streamed) == 4 and all(m.shape == X.shape and m.dtype == bool for _, m in streamed), "stream output")
    check(np.array_equal(streamed[0][1], mask), "stream tile 0 differs from the single-tile call")
    print(
        f"phase 3: score_and_mask_pixels 2048x2048: {t_main!r} ms ({TILE * TILE / t_main / 1e3!r} Mpixels/s), "
        f"foreground share {fg!r}, scores in [{float(scores.min())!r}, {float(scores.max())!r}], "
        f"mask IoU vs staged run {iou(mask, stage_mask)!r}, bp_step launches {launches_single}"
    )
    print(
        f"phase 3: stream of 4 tiles: {t_stream!r} ms, {4 * TILE * TILE / t_stream / 1e3!r} Mpixels/s; "
        f"peak device memory {peak_gb!r} GB; bp_step launches in the main path {launches}, fused delta launches "
        f"{delta_launches}"
    )
    return launches, delta_launches, mask


def phase_starro_cuda_vs_cpu_512(em, ts, make_raster):
    """Phase 4: one 512x512 raster scored on the card and on the CPU."""
    X4 = make_raster(512, 512, seed=1)
    dev = ts._upload(X4, "cuda")
    n4 = ts._n_samples(X4.size, 0.001)
    res, samp, w0, mu0, var0, _ = ts._starro_density_init_sample(dev, 5, n4, seed=0)
    w, r, p = em._nbn_em_batched(samp[None], torch.ones((1, n4), dtype=torch.bool, device="cuda"), w0[None], mu0[None], var0[None])
    offsets = ts._offsets(3, False)
    s_gpu, m_gpu = ts._starro_score_mask(res, w[0], r[0], p[0], 7, offsets, BP_P, BP_Q, 1e-6, 50, True, "bfloat16")
    s_cpu, m_cpu = ts._starro_score_mask(res.cpu(), w[0].cpu(), r[0].cpu(), p[0].cpu(), 7, offsets, BP_P, BP_Q, 1e-6, 50, False)
    iou4 = iou(m_gpu.cpu().numpy(), m_cpu.numpy())
    serr = float((s_gpu.cpu() - s_cpu).abs().max())
    check(iou4 >= 0.999, f"512x512 CUDA vs CPU mask IoU {iou4} < 0.999")
    print(f"phase 4: 512x512 CUDA (kernel, bf16) vs CPU (plain, f32): mask IoU {iou4!r}, scores max_abs_err {serr!r}")


# -- phases 26-27: interpolation engines, clustering, UMAP, the two-group CCI test ------------

#: Phase 26a: expression planted on the E9.5 cloud (`e95_cloud`, 100,000
#: cells): INTERP_GENES smooth functions of position plus N(0, INTERP_NOISE)
#: noise, interpolated onto ~INTERP_TARGETS grid points inside the
#: ellipsoid. The GP fits INTERP_GP_GENES of them at the JAX defaults
#: (512 inducing points, 50 Adam steps); the SIREN all of them at its own
#: (hidden 256, depth 4, batch 4,096, 1,000 steps).
INTERP_GENES, INTERP_TARGETS, INTERP_GP_GENES, INTERP_NOISE = 50, 200_000, 10, 0.1
#: Each engine's mean absolute error against the planted field: about 3x the
#: port's CPU run of the same inputs at 10,000 cells and 20,000 targets
#: (`scripts/interp_cluster_bars.py`: 0.0339, 0.0075, 0.0281; the VTK engine's
#: error grows with the cell density, whose radius then bridges less of the
#: gap between sections), below the JAX tests' bars (tests/test_tdr.py:
#: 0.25, 0.3, 0.35).
INTERP_ERR_BAR = {"vtk": 0.1, "gp": 0.03, "dl": 0.1}
#: Phase 26b: `cortex_section(CLUSTER_CELLS, CLUSTER_GENES)` after
#: normalize_total, log1p and pca(30); the clusterings are scored by their
#: ARI against the SVG_BANDS planted bands. Bars: the port's CPU run of the
#: same section (`scripts/interp_cluster_bars.py`: ARI 0.9470, 0.9229,
#: 0.9226; SpaGCN, whose [n, n] float64 matrices do not fit a shared CPU at
#: 20,000 cells, 0.5470 at 5,000 cells x 1,000 genes; 15-NN preservation
#: 0.0218, 29x a random layout's 15 / 20,000; the bands' smallest Moran's I
#: 0.8473 at bins of MORAN_BIN DNB) less a margin.
CLUSTER_CELLS, CLUSTER_GENES, CCI_PERMUTATIONS = 20_000, 4_000, 1_000
CLUSTER_ARI_BAR = {"scc": 0.9, "mclust": 0.9, "kmeans": 0.9, "spagcn": 0.5}
UMAP_PRESERVATION_BAR, MORAN_BAR, MORAN_BIN = 0.015, 0.8, 250
#: `backbone_scc`'s Louvain is host networkx: it runs on BACKBONE_SCC_CELLS of
#: the cloud's cells (a listed cut, as phase 22's alpha shape).
BACKBONE_SCC_CELLS = 20_000
#: The planted L-R pair of phase 26b's CCI test: band 0's first planted gene
#: becomes the ligand, band 1's the receptor (tests/test_tools.py's pair).
CCI_PAIR = ("TGFB1", "TGFBR1_TGFBR2")


def planted_expression(P, n_genes=INTERP_GENES, seed=0):
    """[n, n_genes] smooth functions of the [n, 3] positions P: 1 + sin(k_j
    . x + phase_j), the frequencies k_j ~ N(0, 2^2) per axis."""
    rng = np.random.default_rng(seed + 11)
    K = rng.normal(0.0, 2.0, (n_genes, 3))
    phase = rng.uniform(0.0, 2 * np.pi, n_genes)
    return 1.0 + np.sin(P @ K.T + phase)


def ellipsoid_grid(n, axes=E95_AXES):
    """About n points of a cubic grid inside the ellipsoid of semi-axes `axes`."""
    ax = np.asarray(axes, float)
    step = (4.0 / 3.0 * np.pi * float(np.prod(ax)) / n) ** (1.0 / 3.0)
    g = [np.arange(-a + step / 2, a, step) for a in ax]
    P = np.stack(np.meshgrid(*g, indexing="ij"), -1).reshape(-1, 3)
    return P[((P / ax) ** 2).sum(1) <= 1.0]


def interp_source(stt, cells, n_genes=INTERP_GENES, seed=0):
    """The port's AnnData of `cells` with the planted expression plus noise."""
    import pandas as pd

    X = planted_expression(cells, n_genes, seed)
    X = X + np.random.default_rng(seed + 12).normal(0.0, INTERP_NOISE, X.shape)
    ad = stt.AnnData(X=X.astype(np.float32), var=pd.DataFrame(index=[f"p{j}" for j in range(n_genes)]),
                     obs=pd.DataFrame(index=[f"c{i}" for i in range(len(cells))]))
    ad.obsm["spatial"] = np.asarray(cells, np.float64)
    stt.SKM.init_adata_type(ad, stt.SKM.ADATA_UMI_TYPE)
    return ad


def stage_run(fn, device, window=None, profile=True):
    """`timed_stage` with the peak device memory of the stage on the card:
    (result, dict(seconds, idle, launches, peak_gb))."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    res, seconds, idle, launches = timed_stage(fn, device, window, profile)
    return res, dict(seconds=seconds, idle=idle, launches=launches,
                     peak_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda else None)


def interp_engines(stt, ad, targets, device="cuda", gp_genes=INTERP_GP_GENES, dl_iter=1000, profile=True):
    """The three engines of phase 26a on `device`: {engine: dict(err, out,
    seconds, idle, launches, peak_gb)}, err the mean absolute error against
    the planted field at the targets. Under the profiler each runs a shorter
    window: the VTK engine and the GP's prediction on 20,000 targets, the GP
    5 steps, the SIREN 50."""
    genes = list(ad.var_names)
    truth = planted_expression(targets, len(genes))
    few = targets[:20_000]
    runs = {
        "vtk": (genes, lambda: stt.tdr.vtk_interpolation(ad, targets, keys=genes, device=device),
                lambda: stt.tdr.vtk_interpolation(ad, few, keys=genes, device=device)),
        "gp": (genes[:gp_genes], lambda: stt.tdr.gp_interpolation(ad, targets, keys=genes[:gp_genes], device=device),
               lambda: stt.tdr.gp_interpolation(ad, few, keys=genes[:gp_genes], training_iter=5, device=device)),
        "dl": (genes, lambda: stt.tdr.deep_intepretation(ad, targets, keys=genes, max_iter=dl_iter, device=device),
               lambda: stt.tdr.deep_intepretation(ad, few, keys=genes, max_iter=50, device=device)),
    }
    out = {}
    for name, (keys, fn, window) in runs.items():
        res, stats = stage_run(fn, device, window, profile)
        pred = np.asarray(res.X, float)
        check(pred.shape == (len(targets), len(keys)) and bool(np.isfinite(pred).all()), f"{name}: output")
        out[name] = dict(err=float(np.abs(pred - truth[:, : len(keys)]).mean()), out=pred, **stats)
    return out


def ari(a, b):
    """Adjusted Rand index of two labelings (Hubert and Arabie)."""
    _, ia = np.unique(np.asarray(a), return_inverse=True)
    _, ib = np.unique(np.asarray(b), return_inverse=True)
    C = np.zeros((ia.max() + 1, ib.max() + 1))
    np.add.at(C, (ia, ib), 1)

    def pairs(x):
        return float((x * (x - 1) / 2).sum())

    n = len(ia)
    sum_c, sum_a, sum_b = pairs(C), pairs(C.sum(1)), pairs(C.sum(0))
    expected = sum_a * sum_b / (n * (n - 1) / 2)
    top = 0.5 * (sum_a + sum_b)
    return 1.0 if top == expected else (sum_c - expected) / (top - expected)


def section_bands(adata):
    """The planted band of each cell of a `cortex_section` (DNB units)."""
    H = SVG_DOMAIN[1]
    y = np.asarray(adata.obsm["spatial"])[:, 1]
    return np.minimum((y * SVG_BANDS // H).astype(int), SVG_BANDS - 1)


def cluster_section(stt, n_cells=CLUSTER_CELLS, n_genes=CLUSTER_GENES, device="cuda"):
    """`cortex_section` after normalize_total, log1p and pca(30), its bands in
    obs['band'] and CCI_PAIR planted: the ligand on band 0's first planted
    gene, the receptor on band 1's."""
    ad = cortex_section(n_cells, n_genes, SVG_PLANTED)
    names = list(ad.var_names)
    names[0], names[1] = CCI_PAIR
    ad.var_names = names
    stt.pp.normalize_total(ad)
    stt.pp.log1p(ad)
    stt.tl.pca(ad, n_pca_components=30, device=device)
    ad.obs["band"] = section_bands(ad).astype(str)
    return ad


def cluster_stages(stt, ad, device="cuda", profile=True, num=CCI_PERMUTATIONS, skip=()):
    """Phase 26b's stages on `device`: {stage: dict(seconds, idle, launches,
    peak_gb, ...)} with each clustering's ARI against the bands, Louvain's
    host seconds, UMAP's 15-NN preservation, the bands' smallest Moran's I,
    and the CCI p-value of CCI_PAIR with permutations/s. Under the profiler
    `scc` runs its two kNN graphs, SpaGCN its adjacency, UMAP 20 epochs and
    the CCI test 20 permutations, and UMAP 20 epochs of its layout on the
    same graph. Stages named in `skip` do not run."""
    from spateo_tpu_torch.tools import dimensionality_reduction as dr
    from spateo_tpu_torch.tools.cluster import find_clusters as fc

    bands = np.asarray(ad.obs["band"])
    X30 = np.asarray(ad.obsm["X_pca"])[:, :30]
    cci = dict(species="human", group="band", sender_group="0", receiver_group="1", pvalue=1.1,
               min_pairs_ratio=1e-5, device=device)
    out = {}

    def stage(name, fn, window=None):
        res, out[name] = stage_run(fn, device, window, profile)
        return res

    stage("neighbors", lambda: (stt.tl.neighbors(ad, n_neighbors=30, device=device),
                                stt.tl.neighbors(ad, basis="spatial", n_neighbors=6, device=device)))
    with timed_calls("cpu", louvain=(fc, "calculate_louvain_partition")) as tc:
        stage("scc", lambda: stt.tl.scc(ad, e_neigh=30, s_neigh=6, device=device),
              lambda: stt.tl.spatial_adj(ad, e_neigh=30, s_neigh=6, device=device))
    out["scc"].update(ari=ari(ad.obs["scc"], bands), louvain_s=tc.seconds["louvain"],
                      clusters=int(ad.obs["scc"].nunique()))
    stage("mclust", lambda: stt.tl.mclust_py(ad, n_components=SVG_BANDS, device=device))
    out["mclust"]["ari"] = ari(ad.obs["mclust"], bands)
    stage("kmeans", lambda: stt.tl.kmeans_clustering(ad, SVG_BANDS, device=device))
    out["kmeans"]["ari"] = ari(ad.obs["kmeans_clusters"], bands)
    if "spagcn" not in skip:
        stage("spagcn", lambda: stt.tl.spagcn_pyg(ad, n_clusters=SVG_BANDS, device=device),
              lambda: fc.spagcn_adjacency(np.asarray(ad.obsm["spatial"]), device=device))
        out["spagcn"]["ari"] = ari(ad.obs["spagcn_pred"], bands)
    reads, layout = [], {}

    def umap():
        r0 = dr.umap_conn_indices_dist_embedding.host_reads
        with timed_calls(device, layout=(dr, "umap_layout")) as tl:
            stt.tl.perform_dimensionality_reduction(ad, n_pca_components=30, device=device)
        reads.append(dr.umap_conn_indices_dist_embedding.host_reads - r0)
        layout["seconds"] = tl.seconds["layout"]

    def layout_window():  # 20 epochs of the layout on the graph of the run above
        init, heads, tails, weights, a, b = layout["args"][:6]
        return umap_layout(init, heads, tails, weights, a, b, 20, generator=layout["kw"]["generator"])

    umap_layout = dr.umap_layout

    def spy(*args, **kw):
        layout.update(args=args, kw=kw)
        return umap_layout(*args, **kw)

    dr.umap_layout = spy
    try:
        stage("umap", umap, layout_window)
    finally:
        dr.umap_layout = umap_layout
    out["umap"].update(host_reads=reads[0], layout_s=layout["seconds"], epochs=layout["args"][6],
                       preservation=dr.knn_preservation(X30, ad.obsm["X_umap"], 15))
    ad.obs["Celltype"] = ad.obs["band"]
    mi = stage("morani", lambda: stt.tl.cellbin_morani(ad, binsize=MORAN_BIN, cluster_key="Celltype"), lambda: None)
    out["morani"]["min_i"] = float(mi["moran_i"].min())
    res = stage("cci", lambda: stt.tl.find_cci_two_group(ad, num=num, **cci),
                lambda: stt.tl.find_cci_two_group(ad, num=20, **cci))
    lr = res["lr_pair"].set_index("lr_pair")
    out["cci"].update(pvalue=float(lr.loc["-".join(CCI_PAIR), "lr_value"]), pairs=len(res["cell_pair"]),
                      perm_per_s=num / out["cci"]["seconds"])
    return out


def backbone_scc_stage(stt, cells, backbone, device="cuda", n=BACKBONE_SCC_CELLS, profile=True):
    """`tdr.backbone_scc` of `n` of the cloud's cells (planted expression)
    along `backbone`: (clusters, stats); under the profiler the kNN graphs."""
    sub = interp_source(stt, cells[np.random.default_rng(3).choice(len(cells), n, replace=False)])
    ad, stats = stage_run(lambda: stt.tdr.backbone_scc(sub, backbone, inplace=False, device=device), device,
                          lambda: stt.tl.spatial_adj(sub, e_neigh=10, s_neigh=6, device=device), profile)
    check(set(np.unique(ad.obs["backbone_nodes"])) <= set(range(backbone.n_points)), "backbone_scc: nodes")
    return int(ad.obs["backbone_scc"].nunique()), stats


def fmt_stats(st):
    keys = ("seconds", "idle", "launches", "peak_gb")
    return "(" + ", ".join(f"{k} {st[k]!r}" for k in keys) + ")"


def phase_interp_cluster(stt, backbone=None):
    """Phase 26: the interpolation engines (a) and the clustering, embedding
    and CCI tools (b) at full width, and `backbone_scc` along phase 22's
    backbone."""
    t_phase = time.perf_counter()
    cells = e95_cloud()
    ad = interp_source(stt, cells)
    targets = ellipsoid_grid(INTERP_TARGETS)
    interp_engines(stt, interp_source(stt, cells[::50], 4), targets[:500], gp_genes=2, dl_iter=5, profile=False)
    res = interp_engines(stt, ad, targets)
    for name, r in res.items():
        check(r["err"] <= INTERP_ERR_BAR[name], f"{name}: mean error {r['err']} against the planted field")
        print(f"phase 26a: {name} interpolation of {len(cells):,} cells onto {len(targets):,} targets: "
              f"{fmt_stats(r)}; mean error against the planted field {r['err']!r} (bar {INTERP_ERR_BAR[name]})")

    small = cluster_section(stt, 2_000, 200)
    cluster_stages(stt, small, profile=False, num=20)
    t0 = time.perf_counter()
    sec = cluster_section(stt)
    t_prep = time.perf_counter() - t0
    st = cluster_stages(stt, sec)
    for name in ("scc", "mclust", "kmeans", "spagcn"):
        check(st[name]["ari"] >= CLUSTER_ARI_BAR[name], f"{name}: ARI {st[name]['ari']} against the bands")
    check(st["umap"]["preservation"] >= UMAP_PRESERVATION_BAR and st["umap"]["host_reads"] == 1, "UMAP")
    check(st["morani"]["min_i"] >= MORAN_BAR, f"cellbin_morani: the bands' Moran's I {st['morani']['min_i']}")
    check(st["cci"]["pvalue"] <= 2.0 / (CCI_PERMUTATIONS + 1), f"CCI: planted pair p {st['cci']['pvalue']}")
    print(f"phase 26b: cortex_section {CLUSTER_CELLS:,} cells x {CLUSTER_GENES:,} genes, normalize_total + log1p + "
          f"pca(30) {t_prep!r} s; " + "; ".join(f"{k} {fmt_stats(v)} " + ", ".join(
              f"{m} {v[m]!r}" for m in v if m not in ("seconds", "idle", "launches", "peak_gb")) for k, v in st.items()))

    if backbone is None:
        pc = stt.tdr.PointCloud(cells)
        backbone, _, _ = stt.tdr.construct_backbone(pc, rd_method="ElPiGraph", num_nodes=TDR_NODES)
    backbone_scc_stage(stt, cells, backbone, n=2_000, profile=False)
    k, stats = backbone_scc_stage(stt, cells, backbone)
    check(k >= 2, f"backbone_scc: {k} clusters")
    print(f"phase 26: backbone_scc of {BACKBONE_SCC_CELLS:,} cells along a {backbone.n_points}-node backbone "
          f"{fmt_stats(stats)}, {k} clusters; phase 26 {time.perf_counter() - t_phase!r} s")


#: Phase 27's bars, card against CPU (measured on the card, PERF.md): the
#: VTK fields and the GP prediction (float32), the first SGPR and SIREN Adam
#: steps from one start (losses, relative), GC-DEC's q, the GMM (float64),
#: UMAP after 3 epochs from one init and negatives (of scale; the card's
#: `index_add_` adds in its own order) and after all (15-NN preservation),
#: the CCI null scores (float32 means). Shepard's weights 1/d^2 carry the
#: GEMM's rounding of a distance near a source into the field (7.2e-5 at
#: 2,000 cells, measured on one H100).
CVC_FIELD_BAR = {"shepard": 5e-4, "gaussian": 1e-5, "linear": 1e-5}
CVC_LOSS_BAR, CVC_Q_BAR, CVC_GMM_BAR = 1e-4, 1e-4, 1e-8
CVC_UMAP_BAR, CVC_UMAP_PRESERVATION, CVC_NULL_BAR = 1e-3, 0.05, 1e-5
CVC_STEPS = 10


def interp_cluster_cuda_vs_cpu(stt, card="cuda", n=2_000):
    """Phase 27's comparisons of `card` against the CPU at `n` cells:
    {check: (value, bar)}; `check` fails where a value passes its bar."""
    from spateo_tpu_torch.ops.gmm import GaussianMixture
    from spateo_tpu_torch.tdr.interpolations import interpolation_dl as idl
    from spateo_tpu_torch.tdr.interpolations import interpolation_gp as igp
    from spateo_tpu_torch.tools import dimensionality_reduction as dr
    from spateo_tpu_torch.tools.cci_two_cluster import permutation_null
    from spateo_tpu_torch.tools.cluster import find_clusters as fc
    from spateo_tpu_torch.tools.cluster.spagcn_utils import simple_GC_DEC

    sides = (card, "cpu")
    rng = np.random.default_rng(0)
    cells = e95_cloud()[rng.choice(E95_SECTIONS * E95_CELLS, n, replace=False)]
    ad = interp_source(stt, cells, 8)
    targets = ellipsoid_grid(5 * n)
    out = {}

    def rel(a, b):
        return float(np.abs(np.asarray(a, float) - np.asarray(b, float)).max() / max(np.abs(np.asarray(b)).max(), 1e-30))

    for kernel in ("shepard", "gaussian", "linear"):
        f = [stt.tdr.vtk_interpolation(ad, targets, kernel=kernel, device=d).X for d in sides]
        out[f"vtk {kernel}"] = (rel(*f), CVC_FIELD_BAR[kernel])
    X = ((cells - cells.mean(0)) / cells.std(0)).astype(np.float32)
    Y = np.asarray(ad.X[:, :4], np.float32)
    Z0 = X[rng.choice(n, 64, replace=False)]
    gp = [igp._fit_sgpr(X, Y, Z0, n_epochs=CVC_STEPS, device=d) for d in sides]
    out["SGPR losses"] = (rel(gp[0][1], gp[1][1]), CVC_LOSS_BAR)
    pred = [igp._sgpr_predict(p, *(torch.from_numpy(a).to(d, torch.float64) for a in (X, Y, X[:500]))).cpu().numpy()
            for (p, _), d in zip(gp, sides)]
    out["SGPR prediction"] = (rel(*pred), CVC_LOSS_BAR)
    bi = rng.integers(0, n, (CVC_STEPS, 512))
    sl = [idl._fit_siren(idl.SIREN([3, 64, 64, 4], seed=0, device=d), X, Y, CVC_STEPS, 1e-3, 512, 0, d, bi)
          for d in sides]
    out["SIREN losses"] = (rel(*sl), CVC_LOSS_BAR)

    A, l_ref = fc.spagcn_adjacency(cells[:, :2], device="cpu")
    l_card = fc.spagcn_adjacency(cells[:, :2], device=card)[1]
    out["SpaGCN l"] = (abs(float(l_card) - float(l_ref)) / float(l_ref), 1e-12)
    emb = np.asarray(ad.X, np.float32)
    q = []
    for d in sides:
        m = simple_GC_DEC(emb.shape[1], emb.shape[1], device=d).fit(emb, A, n_clusters=4, max_epochs=30, seed=0)
        q.append(m.predict()[0])
    out["GC-DEC q"] = (rel(*q), CVC_Q_BAR)
    g = [GaussianMixture(4, "full", random_state=0, device=d).fit(Y) for d in sides]
    check(np.array_equal(g[0].predict(Y), g[1].predict(Y)) and g[0].n_iter_ == g[1].n_iter_, "GMM labels")
    out["GMM means"] = (rel(g[0].means_, g[1].means_), CVC_GMM_BAR)

    Xu = np.asarray(ad.X, np.float32)
    graph, _, _, e0 = dr.umap_conn_indices_dist_embedding(Xu, n_neighbors=15, max_iter=1, return_mapper=False,
                                                          device="cpu")
    init = np.random.default_rng(1).normal(0, 10, (n, 2)).astype(np.float32)
    negs = rng.integers(0, n, (3, graph.nnz))
    e3 = [dr.umap_conn_indices_dist_embedding(Xu, n_neighbors=15, max_iter=3, init=init, negatives=negs,
                                              return_mapper=False, device=d)[3] for d in sides]
    out["UMAP 3 epochs"] = (rel(*e3), CVC_UMAP_BAR)
    pres = [dr.knn_preservation(Xu, dr.umap_conn_indices_dist_embedding(Xu, n_neighbors=15, return_mapper=False,
                                                                       device=d)[3], 15) for d in sides]
    out["UMAP 15-NN preservation"] = (abs(pres[0] - pres[1]), CVC_UMAP_PRESERVATION)

    lig, rec = (torch.from_numpy(np.asarray(ad.X[:, j : j + 2], np.float32)) for j in (0, 2))
    perm = torch.from_numpy(rng.integers(0, n, (2, 200, 300)))
    null = [permutation_null(lig.to(d), rec.to(d), perm[0].to(d), perm[1].to(d)).cpu().numpy() for d in sides]
    out["CCI null"] = (rel(*null), CVC_NULL_BAR)
    for k, (v, bar) in out.items():
        check(v <= bar, f"{k}: card vs CPU {v} (bar {bar})")
    return out


def phase_interp_cluster_cuda_vs_cpu(stt):
    """Phase 27: phase 26's device work on the card against the CPU, at a
    small size."""
    t_phase = time.perf_counter()
    out = interp_cluster_cuda_vs_cpu(stt)
    print("phase 27: card vs CPU at 2,000 cells: " + "; ".join(f"{k} {v!r} (bar {b})" for k, (v, b) in out.items())
          + f"; GMM labels and iterations equal; phase 27 {time.perf_counter() - t_phase!r} s")


#: Phase 28a: two `cortex_section`s of EXT_CELLS x EXT_GENES, the query drawn
#: from seed 1 with expression seed 0, rotated by EXT_THETA deg about the
#: domain's centre and shifted by EXT_SHIFT DNB (the planted transform);
#: CAST_STACK at `reg_params`' defaults in the CAST tutorial's units
#: (``rescale=True``: the 22,340-unit field).
EXT_CELLS, EXT_GENES, EXT_THETA, EXT_SHIFT = 20_000, 4_000, 10.0, (300.0, -200.0)
#: Phase 28b: the spots and HVGs of the STAGATE tutorial's DLPFC 151673, the
#: radius cutoff the median distance to a spot's 6th neighbour (as 150 is on
#: Visium); 28c: a MERFISH panel's width, and the spatial encoder's cut (its
#: dense [N, N, n_spatial] pre-activation is 4 GB at 10,000 cells).
STAGATE_SPOTS, STAGATE_GENES, STAGATE_NEIGHBOURS = 3_639, 3_000, 6
#: `tl.pySTAGATE(...).train()` repeats train_STAGATE's fit through the entry
#: point: **cut from 1,000 epochs to 100** (time; the 1,000 run just before
#: it is the measurement).
PYSTAGATE_EPOCHS = 100
VI_CELLS, VI_GENES, VI_SPATIAL_CELLS = 50_000, 500, 10_000


def norm_1e4(stt, ad):
    """normalize_total + log1p into .X and .layers['norm_1e4']; the counts
    stay in .layers['counts']."""
    ad.layers["counts"] = ad.X.copy()
    stt.pp.normalize_total(ad, target_sum=1e4)
    stt.pp.log1p(ad)
    ad.layers["norm_1e4"] = ad.X.copy()
    return ad


def unrotated(P, theta_deg=EXT_THETA, shift=EXT_SHIFT):
    """The positions a `cortex_section(theta_deg, shift)` had before its
    planted rotation and shift (DNB units)."""
    W, H = SVG_DOMAIN
    th = np.deg2rad(theta_deg)
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    return (np.asarray(P, float) - np.asarray(shift) - [W / 2, H / 2]) @ R + [W / 2, H / 2]


def bands_of(P):
    """The planted band of positions P (DNB units, unrotated)."""
    return np.minimum((np.asarray(P)[:, 1] * SVG_BANDS // SVG_DOMAIN[1]).astype(int), SVG_BANDS - 1)


def obs_frame(**cols):
    import pandas as pd

    n = len(next(iter(cols.values())))
    return pd.DataFrame(cols, index=[f"c{i}" for i in range(n)])


def cast_stages(stt, n_cells=EXT_CELLS, n_genes=EXT_GENES, epochs=200, iters=(500, 400), device="cuda",
                profile=True, sections=None):
    """Phase 28a on `device`: {stage: stats} for `cast_mark`, CAST_STACK and
    CAST_PROJECT, with the aligned query's median distance to its planted
    positions and its median error across the bands (y), each beside the
    unaligned one, and the share of query cells projected into their own
    band. The bands vary in y only: a shift or mirror along them changes no
    expression, so only the error across them is the alignment's to fix. `cast_mark` embeds both sections in one
    call (one model over both, as CAST trains one over its samples; the
    query's graph is kept apart from the reference's by an offset), at the
    JAX defaults. The projection's features are a joint PCA (50) of both
    sections' norm_1e4. `sections`, a dict, receives the reference section
    under "r"."""
    import scipy.sparse as sp

    import spateo_tpu_torch.external as ext
    from spateo_tpu_torch.tools.dimensionality_reduction import randomized_pca_centered

    ref = norm_1e4(stt, cortex_section(n_cells, n_genes))
    qry = norm_1e4(stt, cortex_section(n_cells, n_genes, seed=1, expr_seed=0, theta_deg=EXT_THETA, shift=EXT_SHIFT))
    truth = unrotated(qry.obsm["spatial"])
    if sections is not None:
        sections["r"] = ref
    coords = {"q": np.asarray(qry.obsm["spatial"]), "r": np.asarray(ref.obsm["spatial"])}
    both = stt.AnnData(X=sp.vstack([ref.layers["counts"], qry.layers["counts"]]).tocsr(), var=ref.var.copy(),
                       obs=obs_frame(protocol=["r"] * n_cells + ["q"] * n_cells,
                                     band=np.r_[bands_of(ref.obsm["spatial"]), bands_of(truth)].astype(str)))
    stt.SKM.init_adata_type(both, stt.SKM.ADATA_UMI_TYPE)
    both.layers["norm_1e4"] = sp.vstack([ref.layers["norm_1e4"], qry.layers["norm_1e4"]]).tocsr()
    both.obsm["spatial"] = np.r_[coords["r"], coords["q"] + [4 * SVG_DOMAIN[0], 0.0]]
    out = {}

    def stage(name, fn, window=None):
        res, out[name] = stage_run(fn, device, window, profile)
        return res

    stage("cast_mark", lambda: ext.cast_mark(both, n_epochs=epochs, device=device),
          lambda: ext.cast_mark(both, n_epochs=5, key_added="X_cast_window", device=device))
    embed = {"r": both.obsm["X_cast"][:n_cells], "q": both.obsm["X_cast"][n_cells:]}
    check(np.isfinite(both.obsm["X_cast"]).all() and both.obsm["X_cast"].shape == (2 * n_cells, 64),
          "cast_mark: embeddings")

    def stack(it, it_bs):
        params = ext.reg_params(dataname="q", iterations=it, iterations_bs=(it_bs,))
        return ext.CAST_STACK(coords, embed, ["q", "r"], params_dist=params, rescale=True, device=device), params

    aligned, params = stage("cast_stack", lambda: stack(*iters), lambda: stack(10, 10))
    check(np.isfinite(aligned["q"]).all(), "CAST_STACK: aligned coordinates")
    out["cast_stack"].update(
        residual_median=float(np.median(np.linalg.norm(aligned["q"] - truth, axis=1))),
        unaligned_median=float(np.median(np.linalg.norm(coords["q"] - truth, axis=1))),
        residual_y_median=float(np.median(np.abs(aligned["q"][:, 1] - truth[:, 1]))),
        unaligned_y_median=float(np.median(np.abs(coords["q"][:, 1] - truth[:, 1]))),
        theta_r1=params.theta_r1.tolist(), theta_r2=params.theta_r2.tolist())
    both.obsm["X_pca"] = randomized_pca_centered(both.layers["norm_1e4"], 50, device=device)[0]
    proj, _ = stage("cast_project", lambda: ext.CAST_PROJECT(
        both, "r", "q", coords["r"], aligned["q"], batch_key="protocol", raw_layer="X",
        source_sample_ctype_col="band", pc_feature="X_pca", device=device))
    out["cast_project"]["own_band_share"] = float(
        (np.asarray(proj.obs["band_projected"]) == bands_of(truth).astype(str)).mean())
    return out


def stagate_stages(stt, n_spots=STAGATE_SPOTS, n_genes=STAGATE_GENES, epochs=1000, device="cuda", profile=True):
    """Phase 28b on `device`: Cal_Spatial_Net (Radius), train_STAGATE at its
    defaults, mclust_R(EEE) at the planted band count (ARI against the
    bands), then `tl.pySTAGATE(...).train()` on a copy of the section."""
    import spateo_tpu_torch.external as ext
    from spateo_tpu_torch.tools.find_neighbors import knn

    ad = norm_1e4(stt, cortex_section(n_spots, n_genes))
    P = np.asarray(ad.obsm["spatial"])
    r = float(np.median(knn(P, STAGATE_NEIGHBOURS + 1, device=device)[1][:, -1]))
    out = {}

    def stage(name, fn, window=None):
        res, out[name] = stage_run(fn, device, window, profile)
        return res

    stage("Cal_Spatial_Net", lambda: ext.Cal_Spatial_Net(ad, rad_cutoff=r, verbose=False, device=device))
    out["Cal_Spatial_Net"].update(radius=r, neighbours=ad.uns["Spatial_Net"].shape[0] / n_spots)

    def train(n):
        ext.train_STAGATE(ad, n_epochs=n, save_loss=True, verbose=False, device=device)
        return np.asarray(ad.obsm["STAGATE"]).copy(), ad.uns["STAGATE_loss"]

    z, loss = stage("train_STAGATE", lambda: train(epochs), lambda: train(20))
    check(np.isfinite(z).all() and z.shape == (n_spots, 30), "train_STAGATE: latent")
    ad.obsm["STAGATE"] = z
    out["train_STAGATE"]["final_loss"] = loss
    stage("mclust_R", lambda: ext.mclust_R(ad, SVG_BANDS, "EEE", device=device))
    out["mclust_R"]["ari"] = ari(ad.obs["mclust"], bands_of(P))
    twin = ad.copy()

    def py_train(n):
        stt.tl.pySTAGATE(twin, rad_cutoff=r, num_epoch=n, device=device).train()
        return np.asarray(twin.obsm["STAGATE"]).copy()

    zt = stage("pySTAGATE.train", lambda: py_train(PYSTAGATE_EPOCHS), lambda: py_train(20))
    check(np.isfinite(zt).all() and zt.shape == (n_spots, 30), "pySTAGATE.train: latent")
    return out


def merfishvi_stages(stt, n_cells=VI_CELLS, n_genes=VI_GENES, n_spatial_cells=VI_SPATIAL_CELLS, epochs=300,
                     device="cuda", profile=True):
    """Phase 28c on `device`: MERFISHVI at its defaults (nb, n_latent 10,
    n_hidden 128, full batch) on n_cells counts, then with the spatial
    encoder on n_spatial_cells: the loss (the negative ELBO) at the first and
    the last epoch, and the k-means (6) ARI of the latent against the
    bands."""
    import spateo_tpu_torch.external as ext
    from spateo_tpu_torch.ops.kmeans import KMeans

    out = {}
    for name, n, kw in (("merfishvi", n_cells, {}), ("merfishvi_spatial", n_spatial_cells, {"spatial_encoder": True})):
        ad = cortex_section(n, n_genes)

        def fit(e, ad=ad, kw=kw):
            model = ext.MERFISHVI(ad, device=device, **kw)
            return model, model.train(max_epochs=e)

        (model, losses), out[name] = stage_run(lambda: fit(epochs), device, lambda: fit(5), profile)
        z = model.get_latent_representation()
        check(np.isfinite(z).all() and np.isfinite(losses).all(), f"{name}: latent and losses")
        labels = KMeans(SVG_BANDS, random_state=0, device=device).fit(z).labels_
        out[name].update(loss_first=float(losses[0]), loss_last=float(losses[-1]),
                         latent_ari=ari(labels, bands_of(ad.obsm["spatial"])))
    return out


def phase_external(stt):
    """Phase 28: CAST (a), STAGATE (b) and merfishVI (c) at full width on the
    card, after a warm-up of each at a small size; `tl.CAST` on (a)'s
    reference section."""
    t_phase = time.perf_counter()
    cast_stages(stt, 1_000, 200, epochs=5, iters=(5, 5), profile=False)
    stagate_stages(stt, 500, 200, epochs=5, profile=False)
    merfishvi_stages(stt, 1_000, 100, 500, epochs=5, profile=False)
    sections = {}
    for tag, stages in (("28a", cast_stages(stt, sections=sections)), ("28b", stagate_stages(stt)),
                        ("28c", merfishvi_stages(stt))):
        print(f"phase {tag}: " + "; ".join(f"{k} {fmt_stats(v)} " + ", ".join(
            f"{m} {v[m]!r}" for m in v if m not in ("seconds", "idle", "launches", "peak_gb")) for k, v in stages.items()))
        if tag == "28a":
            cs = stages
        elif tag == "28b":
            check(stages["mclust_R"]["ari"] >= EXT_ARI_BAR["stagate"], f"STAGATE ARI {stages['mclust_R']['ari']}")
        else:
            for k in stages:
                check(stages[k]["loss_last"] < stages[k]["loss_first"], f"{k}: the loss did not fall")
                check(stages[k]["latent_ari"] >= EXT_ARI_BAR[k], f"{k}: latent ARI {stages[k]['latent_ari']}")
    st = cs["cast_stack"]
    check(st["residual_y_median"] <= EXT_Y_RESIDUAL_BAR * st["unaligned_y_median"],
          f"CAST_STACK: residual across the bands {st['residual_y_median']}")
    check(cs["cast_project"]["own_band_share"] >= EXT_BAND_BAR, "CAST_PROJECT: own band share")
    ad = sections["r"]
    _, stats = stage_run(lambda: stt.tl.CAST(ad, device="cuda"), "cuda", profile=False)
    check(np.isfinite(ad.obsm["X_cast"]).all(), "tl.CAST: embedding")
    print(f"phase 28: tl.CAST on the {EXT_CELLS:,}-cell reference section {fmt_stats(stats)}; "
          f"phase 28 {time.perf_counter() - t_phase!r} s")


#: Phase 29's steps and bars, card against CPU at EXT_CVC_CELLS cells: the
#: first steps of CAST-Mark, STAGATE and merfishVI from one init and one set
#: of draws (losses relative; weights of scale, merfishVI's absolute, as they
#: start at 0; the noise-driven STAGATE source vectors absolute), a CAST-Stack
#: pair (theta and coordinates of scale; the FFD mesh of two card runs equal;
#: flips, the points whose cost differs at the same coordinates, at most
#: 1%), the projection (index flips at most 1%, weights where the indices
#: agree). Measured on one H100 80GB HBM3 at 700 W (PERF.md): 4.1e-7, 5.2e-5,
#: 1.3e-7, 2.5e-7, 6.0e-8, 2.0e-7, 7.4e-6; 1.7e-7, 2.6e-8, 1.6e-5, 0, 0; 0,
#: 2.8e-5.
EXT_CVC_CELLS, EXT_CVC_STEPS = 1_000, 10
EXT_CVC_BAR = {"CAST-Mark losses": 1e-4, "CAST-Mark weights": 1e-4, "STAGATE losses": 1e-4,
               "STAGATE weights": 1e-4, "STAGATE source vectors": 1e-2, "merfishVI losses": 1e-4,
               "merfishVI weights": 1e-4, "affine theta": 1e-4, "affine coords": 1e-4, "FFD coords": 1e-3,
               "FFD mesh repeat": 0.0, "J flips": 0.01, "projection index flips": 0.01, "projection weights": 1e-4}
#: Phase 28's bars, below the card's first run (one H100 80GB HBM3, PERF.md:
#: mclust's ARI on the STAGATE latent 0.9436, merfishVI's latent k-means ARI
#: 0.9630 and with the spatial encoder 0.9266, the projection's own-band share
#: 0.9924, the aligned residual across the bands 0.017 of the unaligned one).
EXT_ARI_BAR = {"stagate": 0.85, "merfishvi": 0.85, "merfishvi_spatial": 0.85}
EXT_BAND_BAR, EXT_Y_RESIDUAL_BAR = 0.95, 0.1


def external_cuda_vs_cpu(stt, card="cuda", n=EXT_CVC_CELLS, steps=EXT_CVC_STEPS):
    """Phase 29's comparisons of `card` against the CPU at `n` cells:
    {check: (value, bar)}; `check` fails where a value passes its bar."""
    from spateo_tpu_torch.core.bridge import merfishvi_params_from_reference
    from spateo_tpu_torch.external import MERFISHVI
    from spateo_tpu_torch.external import cast as ec
    from spateo_tpu_torch.external import cast_projection as ep
    from spateo_tpu_torch.external import cast_stack as es
    from spateo_tpu_torch.external import stagate as eg

    sides = (card, "cpu")
    rng = np.random.default_rng(0)
    ad = norm_1e4(stt, cortex_section(n, 200))
    P = np.asarray(ad.obsm["spatial"])
    X = np.asarray(ad.layers["norm_1e4"].toarray(), np.float32)
    out = {}

    def rel(a, b):
        a, b = np.asarray(a, float), np.asarray(b, float)
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))

    def dev(a, d):
        return torch.from_numpy(np.asarray(a)).to(d)

    init = {"W1": rng.normal(0, 0.1, (200, 64)).astype(np.float32), "W2": rng.normal(0, 0.1, (64, 16)).astype(np.float32)}
    masks = rng.random((steps, 2, 200)) < 0.8
    mark = [ec._train_cast({k: dev(v, d) for k, v in init.items()}, ec._norm_adj(P, 10, d), dev(X, d), n_epochs=steps,
                           masks=dev(masks, d)) for d in sides]
    out["CAST-Mark losses"] = rel(*(m[1].cpu() for m in mark))
    out["CAST-Mark weights"] = max(rel(mark[0][0][k].cpu(), mark[1][0][k]) for k in init)

    st_init = eg.STAGATE(200, (64, 8), seed=0, device="cpu").params
    sg = [eg._train_stagate({k: v.to(d) for k, v in st_init.items()}, eg._adj_mask(P, None, 6, d), dev(X, d),
                            n_epochs=steps) for d in sides]
    out["STAGATE losses"] = rel(sg[0][3].cpu(), sg[1][3])
    noisy = ("a2s", "a3s", "a4s")  # gradients of rounding size (tests/test_torch_external.py)
    out["STAGATE weights"] = max(rel(sg[0][0][k].cpu(), sg[1][0][k]) for k in st_init if k not in noisy)
    out["STAGATE source vectors"] = max(float((sg[0][0][k].cpu() - sg[1][0][k]).abs().max()) for k in noisy)

    counts = stt.AnnData(X=ad.layers["counts"], obs=ad.obs.copy(), var=ad.var.copy())
    counts.obsm["spatial"] = P
    vi = [MERFISHVI(counts.copy(), spatial_encoder=True, device=d) for d in sides]
    merfishvi_params_from_reference(vi[1].params.to_tree(), model=vi[0])
    noise = [[torch.from_numpy(rng.normal(size=(n, 10)).astype(np.float32)) for _ in range(2)] for _ in range(steps)]
    losses = [m.train(max_epochs=steps, noise=noise) for m in vi]
    out["merfishVI losses"] = rel(*losses)
    wt = [{k: p.detach().cpu().numpy() for k, p in m.params.named_parameters()} for m in vi]
    out["merfishVI weights"] = max(float(np.abs(wt[0][k] - wt[1][k]).max()) for k in wt[1])

    pts_r = rng.uniform(0, 2000, (n, 2)).astype(np.float32)
    th = np.deg2rad(25.0)
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]], np.float32)
    q = pts_r @ R.T
    q, r = (q - q.mean(0)).astype(np.float32), (pts_r - pts_r.mean(0)).astype(np.float32)
    W = rng.normal(0, 1.0 / 400, (2, 16)).astype(np.float32)
    E = np.c_[np.sin(pts_r @ W), np.cos(pts_r @ W)].astype(np.float32)
    cov = es.max_minus_value(es.corr_dist(E, E, device="cpu")).astype(np.float32)
    ab = np.array([1 / 300, 1 / 300, 1 / 10, 10, 10], np.float32)
    aff = [es._affine_gd(dev(q, d), dev(r, d), dev(cov, d), 500.0, 0.0, dev(ab, d), 25.0, 50, False) for d in sides]
    out["affine theta"] = rel(aff[0][0].cpu(), aff[1][0])
    ca = [es._affine_trans(a[0], dev(q, d)) for a, d in zip(aff, sides)]
    out["affine coords"] = rel(ca[0].cpu(), ca[1])
    lo = ca[1].numpy().min(0)
    qq, rr = ca[1].numpy() - lo, r - lo
    mx = qq.max(0).astype(np.float32)
    ffd = [es._bspline_gd(dev(qq, d), dev(rr, d), dev(cov, d), 500.0, 0.0, 300.0, 25.0, dev(mx, d), 20, 6)
           for d in sides]
    out["FFD coords"] = rel(ffd[0][0].cpu(), ffd[1][0])
    again = es._bspline_gd(dev(qq, card), dev(rr, card), dev(cov, card), 500.0, 0.0, 300.0, 25.0, dev(mx, card), 20, 6)
    out["FFD mesh repeat"] = float((again[1] - ffd[0][1]).abs().max())
    final = ffd[1][0].numpy()
    J = [es._J_points(dev(final, d), dev(rr, d), dev(cov, d), 500.0, 0.0).cpu().numpy() for d in sides]
    out["J flips"] = float((J[0] != J[1]).mean())

    feats = E + rng.normal(0, 0.05, E.shape).astype(np.float32)
    pj = [ep.physical_dist_priority_project(feats, E, q, r, k2=3, pdist_thres=150.0, block=256, device=d)
          for d in sides]
    same = (pj[0][0] == pj[1][0]).all(1)
    out["projection index flips"] = float(1 - same.mean())
    out["projection weights"] = rel(pj[0][1][same], pj[1][1][same])
    return {k: (v, EXT_CVC_BAR[k]) for k, v in out.items()}


def phase_external_cuda_vs_cpu(stt):
    """Phase 29: phase 28's trainers and the CAST-Stack and projection
    steps on the card against the CPU, at a small size."""
    t_phase = time.perf_counter()
    out = external_cuda_vs_cpu(stt)
    print(f"phase 29: card vs CPU at {EXT_CVC_CELLS:,} cells: " + "; ".join(
        f"{k} {v!r} (bar {b})" for k, (v, b) in out.items()) + f"; phase 29 {time.perf_counter() - t_phase!r} s")
    for k, (v, bar) in out.items():
        check(v <= bar, f"{k}: card vs CPU {v} (bar {bar})")


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="Drive the port on one NVIDIA GPU and check it.")
    parser.add_argument("--phases", default=None,
                        help="comma-separated phases to run besides 0-2, 5 and 8 (the build and the kernels line); "
                             "all when omitted")
    phases = parser.parse_args(argv).phases
    phases = None if phases is None else {int(p) for p in phases.split(",") if p.strip()}
    if phases is not None and phases & {9, 10}:
        phases.add(3)  # the labeling chain of phase 9 runs on phase 3's mask
    if phases is not None and phases & {18, 19}:
        phases |= {18, 19}  # phase 19 compares phase 18's samples

    def want(n):
        return phases is None or n in phases

    # -- phase 0: environment --------------------------------------------------
    t_start = time.perf_counter()
    phase_seconds, last = {}, [t_start]

    def mark(group):  # the seconds since the last mark, under `group`
        now = time.perf_counter()
        phase_seconds[group], last[0] = now - last[0], now

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 0: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    from bench import make_raster
    import spateo_tpu_torch as stt
    from spateo_tpu_torch.ops import _build, bp_cuda, em
    from spateo_tpu_torch.segmentation import starro as ts

    mark("0")
    # -- phase 1: build -------------------------------------------------------
    t0 = time.perf_counter()
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    check({"bp_step", "estep", "inlier", "jacobi"} <= set(sources), f"CUDA sources missing: {sources}")
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = [f.result() for f in [pool.submit(_build.build, name) for name in sources]]
    for name in sources:
        _build.load(name)
    print(f"phase 1: built {', '.join(lib.name for lib in libs)} in {time.perf_counter() - t0:.2f} s")

    mark("1")
    # -- phase 2: kernel vs plain version ----------------------------------------
    kstats = phase_kernel_vs_plain(bp_cuda)

    mark("2")
    # -- phase 3: main path ------------------------------------------------------
    launches = delta_launches = 0
    if want(3):
        launches, delta_launches, mask = phase_starro_main(stt, bp_cuda, em, ts, make_raster)
    if want(4):
        phase_starro_cuda_vs_cpu_512(em, ts, make_raster)

    mark("3-4")
    # -- phases 5-7: Morpho ---------------------------------------------------------
    estats = phase_estep_kernels()
    istats = phase_inlier_kernel()
    est_launches = phase_morpho_main() if want(6) else {"colnorm": 0, "rowred": 0, "inlier": 0}
    if want(7):
        phase_morpho_cuda_vs_cpu()

    mark("5-7")
    # -- phases 8-10: digitization and labeling ---------------------------------------
    from spateo_tpu_torch.ops import jacobi_cuda

    jstats = phase_jacobi_kernel()
    jacobi_cuda.jacobi_block.launches = jacobi_cuda.jacobi_block.err_launches = 0
    if want(9):
        pde_launches = phase_pde_configs()
        dig_launches = phase_digitize(stt)
    jacobi_launches = jacobi_cuda.jacobi_block.launches
    reduce_launches = jacobi_cuda.jacobi_block.err_launches
    if want(9):
        check(jacobi_launches > 0 and jacobi_launches >= pde_launches + dig_launches,
              f"jacobi_block launches in the main path {jacobi_launches}")
        check(reduce_launches > 0, "the fused reduction never ran in the main path")
        print(f"phase 9: jacobi_block launches in the main path {jacobi_launches}, fused-reduction launches "
              f"{reduce_launches}")
        phase_labeling(mask)
    if want(10):
        phase_digitization_cuda_vs_cpu(stt)

    mark("8-10")
    # -- phases 11-13: morphofields, and the atlas chain through the port ---------
    if want(11):
        phase_morphofield_main(stt)
    if want(12):
        phase_morphofield_cuda_vs_cpu(stt)
    if want(13):
        phase_atlas_chain()

    mark("11-13")
    # -- phases 14-15: MuSIC ----------------------------------------------------------
    if want(14):
        phase_music_bench()
        phase_music_fit()
    if want(15):
        phase_music_cuda_vs_cpu()

    mark("14-15")
    # -- phases 16-17: the rest of Starro ------------------------------------------------
    staged_launches, staged_deltas = phase_starro_tutorial() if want(16) else (0, 0)
    if want(17):
        phase_starro_cuda_vs_cpu()

    mark("16-17")
    # -- phases 18-19: SVG detection and PASTE -------------------------------------------
    if want(18):
        phase_svg_paste_cuda_vs_cpu(*phase_svg_paste())

    mark("18-19")
    # -- phases 20-21: rigid alignment, mesh correction, st.pp, k-means --------------------
    if want(20):
        phase_e95(stt)
    if want(21):
        phase_e95_cuda_vs_cpu(stt)

    mark("20-21")
    # -- phases 22-23: 3D reconstruction ------------------------------------------------------
    backbone = phase_tdr(stt) if want(22) else None
    if want(23):
        phase_tdr_cuda_vs_cpu(stt)

    mark("22-23")
    # -- phases 24-25: MuSIC's interpretation, refine_alignment, the Frobenius NMF --------------
    if want(24):
        phase_interpretation()
    if want(25):
        phase_interpretation_cuda_vs_cpu()

    mark("24-25")
    # -- phases 26-27: interpolation engines, clustering, UMAP, the CCI test ---------------------
    if want(26):
        phase_interp_cluster(stt, backbone)
    if want(27):
        phase_interp_cluster_cuda_vs_cpu(stt)

    mark("26-27")
    # -- phases 28-29: the external models (CAST, STAGATE, merfishVI) ------------------------------
    if want(28):
        phase_external(stt)
    if want(29):
        phase_external_cuda_vs_cpu(stt)

    mark("28-29")
    print("chip_smoke: seconds by phase group " + json.dumps({k: round(v, 1) for k, v in phase_seconds.items()}))
    print(f"chip_smoke: every chosen phase passed in {time.perf_counter() - t_start!r} s")
    print(card)
    print(json.dumps({"kernels": [
        {
            "name": "bp_step",
            "route": "cuda",
            "source": "spateo_tpu_torch/csrc/bp_step.cu",
            "replaces": "spateo_tpu/ops/bp_pallas.py:63",
            "launches": launches + staged_launches,
            "delta_launches": delta_launches + staged_deltas,
            "launches_by_path": {"phase 3 (fused EM+BP)": launches, "phase 16 (staged EM+BP with bins)":
                                 staged_launches},
            **kstats,
        },
        {
            "name": "estep_colnorm",
            "route": "cuda",
            "source": "spateo_tpu_torch/csrc/estep.cu",
            "replaces": "spateo_tpu/ops/estep_pallas.py:107",
            "launches": est_launches["colnorm"],
            **estats["colnorm"],
        },
        {
            "name": "estep_rowred",
            "route": "cuda",
            "source": "spateo_tpu_torch/csrc/estep.cu",
            "replaces": "spateo_tpu/ops/estep_pallas.py:149",
            "launches": est_launches["rowred"],
            **estats["rowred"],
        },
        {
            "name": "inlier_fit",
            "route": "cuda",
            "source": "spateo_tpu_torch/csrc/inlier.cu",
            "replaces": "spateo_tpu/ops/inlier_pallas.py:38",
            "launches": est_launches["inlier"],
            **istats,
        },
        {
            "name": "jacobi_block",
            "route": "cuda",
            "source": "spateo_tpu_torch/csrc/jacobi.cu",
            "replaces": "spateo_tpu/ops/stencil.py:20",
            "launches": jacobi_launches,
            "reduce_launches": reduce_launches,
            **jstats,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
