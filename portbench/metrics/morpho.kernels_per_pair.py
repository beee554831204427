"""Kernels the card ran per traced pair (two pairs after the window's
first): the dispatch cost of the EM loop and its stages. Source: the device
trace, checked against the E-step kernels' launch counters (a trace that
holds fewer of them than were launched lost records, and reads nothing).
Moves `morpho_pairs_min`: the EM is launch-bound."""

import sys

ESTEP = {"colnorm.launches": ("colnorm_kernel",), "rowred.launches": ("rowred_kernel",)}


def read(span):
    if not span.units or not span.kernels():
        return None
    for counter, names in ESTEP.items():
        if span.kernel_count(names) < span.counters.get(counter, 0):
            print(f"morpho.kernels_per_pair: {span.kernel_count(names)} {names[0]} traced, "
                  f"{span.counters[counter]} launched; records lost", file=sys.stderr)
            return None
    return span.kernel_count() / span.units
