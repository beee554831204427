"""Milliseconds a traced pair spent in the E-step kernels (`csrc/estep.cu`:
`colnorm_kernel`, `rowred_kernel` and their finalize kernels), summed from
the device trace, whose kernels must number the launches that
`colnorm.launches` and `rowred.launches` count. A time, not a roofline
share: the kernels skip tiles by the data, so the work they need is not
known from the shapes alone. Moves `morpho_pairs_min` by the E-step's share
of a pair."""

import sys

KERNELS = ("colnorm_kernel", "colnorm_finalize", "rowred_kernel", "rowred_finalize")
COUNTED = {"colnorm.launches": ("colnorm_kernel",), "rowred.launches": ("rowred_kernel",)}


def read(span):
    events = span.matching(KERNELS)
    if not span.units or not events:
        return None
    for counter, names in COUNTED.items():
        if span.kernel_count(names) < span.counters.get(counter, 0):
            print(f"morpho.estep_ms_per_pair: {span.kernel_count(names)} {names[0]} traced, "
                  f"{span.counters[counter]} launched; records lost", file=sys.stderr)
            return None
    return sum(b - a for _, _, a, b in events) / 1e6 / span.units
