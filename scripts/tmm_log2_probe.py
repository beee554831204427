"""Why TMM takes its logarithms on the host: on one card, compare the card's
and the CPU's ``torch.log2`` of the TMM logratios bit for bit, and the TMM
factors of `chip_smoke.pp_counts(2000, 300, seed=3)` (integer counts, many
tied ratios) with the logarithms taken on each device against the port's
`calcNormFactors` (numpy's logarithms on the host).

    python3 scripts/tmm_log2_probe.py     # on a GPU machine, from the repo root
"""

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from spateo_tpu_torch.preprocessing import normalize  # noqa: E402


def tmm_device_logs(counts, ref_col, device):
    """`_tmm_batched` with its logarithms taken by torch on `device`."""
    t = lambda x: torch.as_tensor(x, dtype=torch.float64, device=device)  # noqa: E731
    C, lib = t(counts), t(counts.sum(1))
    R, nR = C[ref_col], float(counts[ref_col].sum())
    nO = lib[:, None]
    logR = torch.log2((C / nO) / (R / nR))
    absE = (torch.log2(C / nO) + torch.log2(R / nR)) / 2.0
    v = (nO - C) / nO / C + (nR - R) / nR / R
    fin = torch.isfinite(logR) & torch.isfinite(absE)
    n = fin.sum(1, keepdim=True).double()
    pos = torch.arange(C.shape[1], device=device).expand_as(C)

    def rank(x):
        order = torch.argsort(torch.where(fin, x, torch.inf), dim=1, stable=True)
        return torch.empty_like(order).scatter_(1, order, pos)

    keep = fin & (rank(logR) >= torch.floor(n * 0.3).long() + 1) & (rank(absE) >= torch.floor(n * 0.05).long() + 1)
    w = torch.where(keep, 1.0 / v, 0.0)
    f = (torch.where(keep, logR, 0.0) * w).sum(1) / w.sum(1)
    return torch.where(torch.isnan(f), 1.0, 2.0**f).cpu().numpy(), logR.cpu().numpy()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("tmm_log2_probe: needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    counts = chip_smoke.pp_counts(2000, 300, seed=3).toarray().astype(float)
    counts = counts[:, (counts > 0).sum(0) > 0]  # as calcNormFactors drops all-zero genes
    f95 = np.percentile(counts, 95, axis=1) / counts.sum(1)
    ref_col = int(np.argmax(np.sum(np.sqrt(counts), axis=1))) if np.median(f95) < 1e-20 else \
        int(np.argmin(np.abs(f95 - np.mean(f95))))
    dev = {d: tmm_device_logs(counts, ref_col, d) for d in ("cuda", "cpu")}
    a, b = dev["cuda"][1], dev["cpu"][1]
    m = np.isfinite(a) & np.isfinite(b)
    print(f"logratios: {int((a[m] != b[m]).sum())} of {int(m.sum())} differ in their bits between the card's and the "
          f"CPU's log2 (largest {float(np.abs(a[m] - b[m]).max())!r})")
    d_dev = np.abs(dev["cuda"][0] - dev["cpu"][0])
    print(f"TMM with each device's log2: factors {float(d_dev.max())!r} apart at most, {int((d_dev > 1e-12).sum())} "
          f"of {len(d_dev)} samples beyond 1e-12")
    port = {d: normalize.calcNormFactors(counts, method="TMM", refColumn=ref_col, device=d) for d in ("cuda", "cpu")}
    print(f"the port (host logarithms): card and CPU {float(np.abs(port['cuda'] - port['cpu']).max())!r} apart")


if __name__ == "__main__":
    main()
