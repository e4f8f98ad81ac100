"""Device ms a round of the ``local_sgd`` phase, from its mark
``fl_phase_local_sgd`` to the next mark, idle time included: Step 2: the
selection, the minibatch gather, the data attacks and the clients' local
SGD (per fold block when streaming)."""
from bench.metrics._phases import phase_ms


def read(trace, ctx):
    return phase_ms(trace, ctx, "local_sgd")
