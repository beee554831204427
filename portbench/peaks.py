"""Published peaks of the card, the least time a kernel could take, and the
card's identity as each result states it.

NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
power limit of 700 W. A card set below it runs slower under load, so every
result carries the card's `power.limit` beside its numbers.
"""

from __future__ import annotations

import subprocess

H100 = {
    "f32_flops_per_s": 67e12,  # outside the tensor cores
    "hbm_bytes_per_s": 3.35e12,
}


def bound_s(flops: float, nbytes: float, peaks=H100):
    """(seconds, "operations" or "bytes"): the least time the card could
    take for `flops` f32 operations and `nbytes` bytes, and which of the
    two sets it."""
    t_ops, t_bytes = flops / peaks["f32_flops_per_s"], nbytes / peaks["hbm_bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them, or the
    reason it could not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable: {exc}"
    return out.stdout.strip() or out.stderr.strip()
