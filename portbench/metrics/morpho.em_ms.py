"""Milliseconds of the EM loop (`_morpho_em`, 200 iterations), the median
over the traced run's pairs. Source: the program's stage marks
(`_phase_times` "preem_done" to "em_dispatched"; the program synchronises
at each mark, so the span holds the loop's device work). Moves
`morpho_pairs_min`."""

import statistics


def read(span):
    marks = [m for m in span.extra.get("phases", []) if "preem_done" in m and "em_dispatched" in m]
    if not marks:
        return None
    return 1e3 * statistics.median(m["em_dispatched"] - m["preem_done"] for m in marks)
