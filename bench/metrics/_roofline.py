"""Shared arithmetic of the ``*_roofline`` readers: the least time of a
kernel's launches in the profiled rounds (``bench/counts/kernels.py``)
over their device time, matched by symbol."""
import re

from bench.counts import kernels


def share(trace, ctx, kernel: str, pattern: str):
    rx = re.compile(pattern)
    ks = [k for k in trace.kernels if rx.search(k.name)]
    least = kernels.round_least_s(kernel, ctx["traffic"], ctx["d"]) * \
        trace.rounds
    if not ks or least <= 0:
        return None
    return 100.0 * least / (sum(k.dur for k in ks) * 1e-6)
