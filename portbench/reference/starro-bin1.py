"""Plain reference of Starro's EM+BP mask, one raster at a time.

Written from the method's description (Spateo's `score_and_mask_pixels(...,
method="EM+BP")`), in plain PyTorch on whatever device it is given, with
nothing of the program under test: density convolution with a disk of
diameter k, an Otsu split for the initial negative-binomial parameters, a
weighted downsample drawn by the Gumbel top-k trick, a two-component
negative-binomial mixture fitted by EM in the (lambda, theta) form, the
per-pixel conditionals, loopy belief propagation on the 4-neighbour grid,
an Otsu threshold and a close-then-open with a disk of diameter mk.

What the program derives from the seed (the downsample's uniforms), this
file draws again from the same seed with the same generator on the same
device. Arithmetic is float32 as the configuration states; BP's messages
are stored in the configuration's message type (bfloat16) between
iterations, with float32 arithmetic. `mask_and_scores(..., msg_dtype=...)`
stores them in another type: float8 (e4m3) is the control, the step below
bfloat16 that a later change might be tempted by.

`mask_and_scores` takes a raster on the host and gives its mask on the host.
"""

from __future__ import annotations

import numpy as np
import torch

#: The compared numbers and their limits (PERF.md gives the readings they
#: were set from), each the worst judged tile of a run: the share of the
#: tile's pixels whose mask differs from this reference's, and the mean
#: absolute gap between the program's BP scores and this reference's.
LIMITS = {"mask_mismatch_share": 3e-5, "score_mean_gap": 1e-5}

_MSG = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn}
# incoming message d at pixel p comes from the neighbour at p + _OFF[d];
# seen from that neighbour, p lies in direction _REV[d]
_OFF = ((-1, 0), (1, 0), (0, -1), (0, 1))
_REV = (1, 0, 3, 2)


def disk_offsets(k: int):
    r = (k - 1) // 2
    return [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1) if dy * dy + dx * dx <= r * r]


def density(X: torch.Tensor, k: int) -> torch.Tensor:
    """Sum of the counts under a disk of diameter k around each pixel, the
    raster mirrored at its edges (the edge pixel repeated)."""
    r = (k - 1) // 2
    H, W = X.shape
    iy = torch.as_tensor(np.pad(np.arange(H), r, mode="symmetric"), device=X.device)
    ix = torch.as_tensor(np.pad(np.arange(W), r, mode="symmetric"), device=X.device)
    P = X[iy][:, ix]
    out = torch.zeros_like(X)
    for dy, dx in disk_offsets(k):
        out = out + P[r + dy : r + dy + H, r + dx : r + dx + W]
    return out


def otsu(values: torch.Tensor, nbins: int = 256) -> torch.Tensor:
    """Otsu's threshold over `nbins` equal bins between the values' min and
    max: the centre of the bin that maximises the between-class variance."""
    vmin, vmax = values.min(), values.max()
    span = torch.clamp_min(vmax - vmin, 1e-30)
    idx = torch.clamp(((values - vmin) / span * nbins).to(torch.int32), 0, nbins - 1)
    hist = torch.bincount(idx, minlength=nbins).to(torch.float32)
    edges = vmin + span * torch.arange(nbins + 1, dtype=torch.float32, device=values.device) / nbins
    centers = (edges[:-1] + edges[1:]) / 2
    w0 = torch.cumsum(hist, 0)
    w1 = w0[-1] - w0
    cm = torch.cumsum(hist * centers, 0)
    m0 = cm / torch.clamp_min(w0, 1e-30)
    m1 = (cm[-1] - cm) / torch.clamp_min(w1, 1e-30)
    var = torch.where((w0 > 0) & (w1 > 0), w0 * w1 * (m0 - m1) ** 2, torch.full_like(w0, -torch.inf))
    return centers[torch.argmax(var)]


def n_samples(size: int, downsample: float) -> int:
    n = max(int(size * downsample), 1000) if downsample <= 1 else int(downsample)
    return min(n, size)


def initial_sample(res: torch.Tensor, n: int, seed: int):
    """Initial mixture (w, mu, var) from an Otsu split of the density, and a
    weighted sample of n density values without replacement, weights
    log1p(x + 1), by the Gumbel top-k trick on uniforms drawn from `seed`."""
    flat = res.ravel()
    size = flat.shape[0]
    thr = torch.clamp_min(otsu(flat), 1.0)
    fg = flat > thr
    n_fg = fg.sum()
    n_bg = size - n_fg
    w0 = torch.stack([n_bg, n_fg]).to(torch.float32) / size
    s_all, s_fg = flat.sum(), torch.where(fg, flat, 0.0).sum()
    q_all, q_fg = (flat * flat).sum(), torch.where(fg, flat * flat, 0.0).sum()
    mu_bg = (s_all - s_fg) / torch.clamp_min(n_bg, 1)
    mu_fg = torch.where(n_fg > 0, s_fg / torch.clamp_min(n_fg, 1), thr * 2.0)
    var_bg = (q_all - q_fg) / torch.clamp_min(n_bg, 1) - mu_bg**2
    var_fg = torch.where(n_fg > 0, q_fg / torch.clamp_min(n_fg, 1) - mu_fg**2, thr * 4.0)
    mu, var = torch.stack([mu_bg, mu_fg]), torch.stack([var_bg, var_fg])
    var = torch.where(var <= mu, mu * 1.1, var)
    gen = torch.Generator(device=flat.device)
    gen.manual_seed(int(seed))
    u = torch.clamp_min(torch.rand(size, generator=gen, device=flat.device) * (1.0 - 1e-12) + 1e-12, 1e-12)
    keys = torch.log(torch.log1p(flat + 1.0) + 1e-30) - torch.log(-torch.log(u))
    return flat[torch.topk(keys, n).indices], w0, mu, var


def nb_logpmf(x, r, p):
    """log NB(x; r, p): x failures before the r-th success of probability p."""
    return torch.lgamma(x + r) - torch.lgamma(r) - torch.lgamma(x + 1.0) + r * torch.log(p) + x * torch.log1p(-p)


def nb_mixture_em(x: torch.Tensor, w, mu, var, max_iter: int, precision: float):
    """Two-component NB mixture fitted by EM in the (lambda, theta) form
    until no parameter moves by `precision`; a step that gives an invalid
    parameter (NaN, Inf, r <= 0, theta or w outside [0, 1]) is not taken
    and ends the fit. Returns (w, r, theta), [2] each."""
    r = mu**2 / (var - mu)
    theta = mu / var
    lam = -r * torch.log(theta)
    xs = x[None, :]
    for _ in range(max_iter):
        r = -lam / torch.log(theta)
        tau = torch.clamp(w[:, None] * torch.exp(nb_logpmf(xs, r[:, None], theta[:, None])), 1e-10, 1e10)
        tau = tau / tau.sum(0, keepdim=True)
        beta = 1.0 - 1.0 / (1.0 - theta) - 1.0 / torch.log(theta)
        delta = r[:, None] * (torch.digamma(r[:, None] + xs) - torch.digamma(r[:, None]))
        tau_sum = tau.sum(1)
        w_new = tau_sum / tau_sum.sum()
        td = (tau * delta).sum(1)
        lam_new = td / tau_sum
        theta_new = beta * td / (tau * (xs - (1.0 - beta)[:, None] * delta)).sum(1)
        r_new = -lam_new / torch.log(theta_new)
        new = torch.stack([w_new, r_new, theta_new])
        if bool(~torch.isfinite(new).all() | (r_new <= 0).any() | (theta_new < 0).any() | (theta_new > 1).any()
                | (w_new < 0).any() | (w_new > 1).any()):
            break
        moved = torch.stack([(w_new - w).abs().max(), (lam_new - lam).abs().max(), (theta_new - theta).abs().max()])
        w, lam, theta = w_new, lam_new, theta_new
        if bool(moved.max() < precision):
            break
    return w, -lam / torch.log(theta), theta


def conditionals(res: torch.Tensor, r, theta) -> torch.Tensor:
    """[2, H, W]: P(density | background), P(density | cell), normalised."""
    phi = torch.stack([torch.exp(nb_logpmf(res, r[0], theta[0])), torch.exp(nb_logpmf(res, r[1], theta[1]))])
    return phi / torch.clamp_min(phi.sum(0, keepdim=True), 1e-30)


def belief_propagation(phi: torch.Tensor, p: float, q: float, precision: float, max_iter: int, msg_dtype,
                       check_every: int = 10) -> torch.Tensor:
    """Synchronous sum-product BP on the binary 4-neighbour grid with the
    pairwise potential [[p, q], [q, p]]: P(cell) a pixel. Messages hold
    their state-0 probability, normalised, stored in `msg_dtype`; a
    neighbour outside the raster sends 0.5. The change of the messages
    (L2 over both states) is measured on every `check_every`-th iteration
    and ends the loop under `precision`."""
    _, H, W = phi.shape
    M = torch.full((4, H, W), 0.5, dtype=msg_dtype, device=phi.device)
    it = 0
    while it < max_iter:
        for _ in range(min(check_every, max_iter - it)):
            m0 = M.to(torch.float32)
            m1 = 1.0 - m0
            new = torch.full((4, H, W), 0.5, dtype=torch.float32, device=phi.device)
            for d, (dy, dx) in enumerate(_OFF):
                others = [k for k in range(4) if k != _REV[d]]
                e0 = phi[0] * m0[others[0]] * m0[others[1]] * m0[others[2]]
                e1 = phi[1] * m1[others[0]] * m1[others[1]] * m1[others[2]]
                o0, o1 = e0 * p + e1 * q, e0 * q + e1 * p
                o = o0 / torch.clamp_min(o0 + o1, 1e-30)  # what each pixel sends its neighbour at -_OFF[d]
                new[d, _dst(dy, H), _dst(dx, W)] = o[_src(dy, H), _src(dx, W)]
            old, M = M, new.to(msg_dtype)
            it += 1
        change = torch.sqrt(2.0 * ((M.to(torch.float64) - old.to(torch.float64)) ** 2).sum())
        if float(change) < precision:
            break
    m0 = M.to(torch.float32)
    b0 = phi[0] * m0[0] * m0[1] * m0[2] * m0[3]
    b1 = phi[1] * (1 - m0[0]) * (1 - m0[1]) * (1 - m0[2]) * (1 - m0[3])
    return b1 / torch.clamp_min(b0 + b1, 1e-30)


def _dst(off: int, n: int) -> slice:
    """The rows (or columns) i whose neighbour i + off lies inside [0, n)."""
    return slice(max(0, -off), n - max(0, off))


def _src(off: int, n: int) -> slice:
    """Those neighbours i + off, in the order of `_dst`."""
    return slice(max(0, off), n + min(0, off))


def morph(mask: torch.Tensor, k: int, erode: bool) -> torch.Tensor:
    """Binary dilation (outside counts as background) or erosion (outside
    counts as foreground) by a disk of diameter k."""
    r = (k - 1) // 2
    H, W = mask.shape
    P = torch.nn.functional.pad(mask.to(torch.uint8), (r, r, r, r), value=1 if erode else 0).bool()
    out = None
    for dy, dx in disk_offsets(k):
        s = P[r + dy : r + dy + H, r + dx : r + dx + W]
        out = s if out is None else (out & s if erode else out | s)
    return out


def mask_and_scores(raster, settings: dict, device, msg_dtype: str = None):
    """The mask [H, W] (host, bool) and BP scores [H, W] (f32, on `device`)
    of one raster under the configuration's `settings` (the stream's
    arguments), messages stored in `msg_dtype` (the configuration's by
    default)."""
    k = int(settings["k"])
    mk = int(settings.get("mk") or k + 2)
    if int(settings["bp_k"]) != 3 or settings.get("bp_square"):
        raise ValueError("the reference runs the 4-neighbour grid (bp_k=3, round) only")
    dtype = _MSG[msg_dtype or settings["bp_msg_dtype"]]
    X = torch.as_tensor(np.asarray(raster, np.float32), device=device)
    res = density(X, k)
    n = n_samples(res.numel(), float(settings["downsample"]))
    sample, w0, mu0, var0 = initial_sample(res, n, 0 if settings.get("seed") is None else int(settings["seed"]))
    _, r, theta = nb_mixture_em(sample, w0, mu0, var0, int(settings["em_max_iter"]), float(settings["em_precision"]))
    scores = belief_propagation(conditionals(res, r, theta), float(settings["bp_p"]), float(settings["bp_q"]),
                                float(settings["bp_precision"]), int(settings["bp_max_iter"]), dtype)
    mask = scores >= otsu(scores.ravel())
    mask = morph(morph(mask, mk, erode=False), mk, erode=True)  # close
    mask = morph(morph(mask, mk, erode=True), mk, erode=False)  # open
    return mask.cpu().numpy(), scores


def control_stream(tiles, settings: dict, device, msg_dtype: str = "float8_e4m3fn"):
    """The control in the program's place: (scores, mask) for each raster
    of `tiles`, computed by this reference with messages in `msg_dtype`."""
    for raster in tiles:
        mask, scores = mask_and_scores(raster, settings, device, msg_dtype)
        yield scores, mask


def mismatch_share(mask, ref: np.ndarray) -> float:
    """The share of pixels whose mask differs (1 where the shapes differ)."""
    mask = np.asarray(mask, bool)
    if mask.shape != ref.shape:
        return 1.0
    return float(np.count_nonzero(mask != ref)) / ref.size


def score_gap(scores, ref: torch.Tensor) -> float:
    """The mean absolute gap between two tiles' scores (1 where the shapes
    differ or a score is missing)."""
    if scores is None or tuple(np.shape(scores)) != tuple(ref.shape):
        return 1.0
    got = torch.as_tensor(np.asarray(scores, np.float32), device=ref.device)
    gap = (got.double() - ref.double()).abs().mean()
    return float(gap) if bool(torch.isfinite(gap)) else 1.0
