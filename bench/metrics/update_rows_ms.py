"""Device ms a round of the ``update_rows`` phase, from its mark
``fl_phase_update_rows`` to the next mark, idle time included: the
update rows: flattening the clients' updates, the update attacks, the
codec and the residual write."""
from bench.metrics._phases import phase_ms


def read(trace, ctx):
    return phase_ms(trace, ctx, "update_rows")
