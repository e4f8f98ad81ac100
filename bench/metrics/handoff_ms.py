"""Device ms a round of the ``handoff`` phase, from its mark
``fl_phase_handoff`` to the next mark, idle time included: each
segment's edge: the copies out, the host sync, the next segment's copies
in, its generator state and learning rates."""
from bench.metrics._phases import phase_ms


def read(trace, ctx):
    return phase_ms(trace, ctx, "handoff")
