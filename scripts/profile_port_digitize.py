"""Where digitization and the labeling chain spend their time on the card,
for the PyTorch/CUDA port (`spateo_tpu_torch`).

Profiles, each once warm under `torch.profiler`: `dd.digitize` + `dd.gridit`
on `chip_smoke.py`'s 2048x2048 quadrilateral domain (262,144 cells, 20,000
iterations per heat solve), and `ops.labels.label_cells_from_mask` on the
Starro mask of `bench.make_raster(2048, 2048, seed=0)`. For each prints the
wall time with and without the profiler, the device's busy time and idle
share (device-side events only), and the kernels and host ops that take the
most time. Needs one NVIDIA GPU; run from the repository root:

    python3 scripts/profile_port_digitize.py
"""

import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bench  # noqa: E402
import chip_smoke  # noqa: E402
import spateo_tpu_torch as stt  # noqa: E402
from spateo_tpu_torch.ops import labels  # noqa: E402


def report(name, run):
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
    print(f"{name}: {plain_ms!r} ms without the profiler, {wall_ms!r} ms under it; device busy {busy_ms!r} ms, "
          f"idle share {1 - busy_ms / wall_ms!r} (under the profiler), {1 - busy_ms / plain_ms!r} (busy time "
          f"against the unprofiled wall), device events {len(device)}")
    by_name = {}
    for e in device:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    print("device time by kernel (count, ms):")
    for kname, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"  {n:6d} {t:9.3f}  {kname[:100]}")
    print("host self time by op (count, ms):")
    for e in sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:10]:
        print(f"  {e.count:6d} {e.self_cpu_time_total / 1e3:9.3f}  {e.key[:100]}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    print(torch.cuda.get_device_name(0))
    ctrs, corners, coords, _ = chip_smoke.quad_domain(2048, 24, 4, 3)

    def digitize():
        adata = chip_smoke.digitize_adata(stt, coords)
        stt.dd.digitize(adata, ctrs, 0, *corners, max_itr=20_000, device="cuda")
        stt.dd.gridit(adata, layer_num=10, column_num=10)

    report("digitize + gridit 2048x2048, 262,144 cells", digitize)

    adata = stt.AnnData(X=bench.make_raster(2048, 2048, seed=0))
    stt.SKM.init_adata_type(adata, stt.SKM.ADATA_AGG_TYPE)
    stt.cs.score_and_mask_pixels(adata, "X", k=5, method="EM+BP", em_kwargs=dict(seed=0), bp_kwargs=dict(max_iter=50))
    mask = np.asarray(adata.layers["X_mask"])
    report("label_cells_from_mask 2048x2048 Starro mask", lambda: labels.label_cells_from_mask(mask, 3, device="cuda"))


if __name__ == "__main__":
    main()
