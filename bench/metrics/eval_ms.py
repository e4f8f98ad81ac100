"""Device ms a round of the ``eval`` phase, from its mark ``fl_phase_eval``
to the next mark, idle time included: each eval point's evaluation."""
from bench.metrics._phases import phase_ms


def read(trace, ctx):
    return phase_ms(trace, ctx, "eval")
