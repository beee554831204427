"""1 - (the union of kernel and copy intervals on all streams) / (the
traced span), over the two traced pairs. Source: the device trace. Moves
`morpho_pairs_min`: the EM loop is host-bound while the card idles."""

from portbench import trace


def read(span):
    return trace.idle_share(span)
