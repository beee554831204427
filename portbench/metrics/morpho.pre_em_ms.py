"""Milliseconds from `Morpho_pairwise.run`'s start to the EM's start (the
coarse init with the inlier kernel, sigma2's guess, U, the factorised
distances), the median over the traced run's pairs. Source: the program's
stage marks (`_phase_times` "start" to "preem_done"). Moves
`morpho_pairs_min`."""

import statistics


def read(span):
    marks = [m for m in span.extra.get("phases", []) if "start" in m and "preem_done" in m]
    if not marks:
        return None
    return 1e3 * statistics.median(m["preem_done"] - m["start"] for m in marks)
