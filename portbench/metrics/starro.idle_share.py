"""1 - (the union of kernel and copy intervals on all streams) / (the
traced span), over the traced chunks. Source: the device trace. Moves
`starro_mpix_s`: the stream is host-bound while the card idles."""

from portbench import trace


def read(span):
    return trace.idle_share(span)
