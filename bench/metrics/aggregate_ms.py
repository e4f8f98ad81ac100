"""Device ms a round of the ``aggregate`` phase, from its mark
``fl_phase_aggregate`` to the next mark, idle time included: Steps 4-5:
the statistics, the rule's aggregation and the param apply (a streamed
block's fold)."""
from bench.metrics._phases import phase_ms


def read(trace, ctx):
    return phase_ms(trace, ctx, "aggregate")
