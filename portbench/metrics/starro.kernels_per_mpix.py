"""Kernels the card ran over the traced chunks, per Mpixel the stream
computed while they were traced: the dispatch cost of the batched NB-EM,
the conditionals, BP and the mask. Source: the device trace, checked
against the BP kernel's launch counter (a trace that holds fewer BP
kernels than were launched lost records, and reads nothing). Moves
`starro_mpix_s`: the EM and the per-tile stages are launch-bound."""

import sys

from portbench import trace

BP_KERNEL = ("bp_step_kernel",)


def read(span):
    pixels = sum(h * w for h, w in span.extra.get("computed_tiles", []))
    launched = span.counters.get("bp_step.launches", 0)
    if not pixels or not span.kernels():
        return None
    if span.kernel_count(BP_KERNEL) < launched:
        print(f"starro.kernels_per_mpix: {span.kernel_count(BP_KERNEL)} bp_step kernels traced, {launched} launched;"
              " records lost", file=sys.stderr)
        return None
    return span.kernel_count() / (pixels / 1e6)
