"""Device ms a round of the ``guides`` phase, from its mark
``fl_phase_guides`` to the next mark, idle time included: Step 3: the
enclave's guides (and FLTrust's root update)."""
from bench.metrics._phases import phase_ms


def read(trace, ctx):
    return phase_ms(trace, ctx, "guides")
