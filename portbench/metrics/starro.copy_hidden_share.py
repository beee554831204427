"""The share of the stream's side-stream copy time (rasters up, packed masks
back) that ran under a kernel on another stream, over the traced chunks.
Source: the device trace. Moves `starro_mpix_s`: a copy that runs in a gap
of the compute stream holds nothing up only if the gap was there anyway."""

from portbench import trace


def read(span):
    total, under = trace.copy_hidden(span)
    return under / total if total else None
