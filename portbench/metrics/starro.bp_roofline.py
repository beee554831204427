"""The BP kernel's share of its roofline over the traced chunks, in percent.

Bytes an iteration needs on an H x W tile, each input read once and each
output written once: phi [2, H, W] float32 in, the messages [4, H, W] in
and out in the configuration's message type; no operation count comes
near the bytes' time at 67 TFLOP/s. The iterations are the BP kernel's
launches (`bp_step.launches`) over the span, taken as equal for the tiles
computed in it; the time is the summed duration of the traced `bp_step`
kernels, which must number the launches. Source: the device trace and the
program's launch counter. Moves `starro_mpix_s` by BP's share of a chunk."""

import sys

from portbench import peaks

KERNEL = ("bp_step_kernel",)
MSG_BYTES = {"bfloat16": 2, "float32": 4}


def bytes_per_pixel(msg_dtype: str) -> int:
    return 2 * 4 + 2 * 4 * MSG_BYTES[msg_dtype]


def read(span):
    tiles = span.extra.get("computed_tiles", [])
    launched = span.counters.get("bp_step.launches", 0)
    events = span.matching(KERNEL)
    if not tiles or not launched or not events:
        return None
    if len(events) < launched:
        print(f"starro.bp_roofline: {len(events)} bp_step kernels traced, {launched} launched; records lost",
              file=sys.stderr)
        return None
    nbytes = launched / len(tiles) * sum(h * w for h, w in tiles) * bytes_per_pixel(span.extra["msg_dtype"])
    least_s, _ = peaks.bound_s(0.0, nbytes)
    return 100.0 * least_s / (sum(b - a for _, _, a, b in events) / 1e9)
