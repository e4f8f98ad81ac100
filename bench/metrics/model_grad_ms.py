"""Device time a round of the kernels launched inside the model's
gradient (the ``bench.model_grad`` range the harness puts around the
model's ``grad``: the clients' local steps and the guides).  Under a
replayed CUDA graph the range exists only at capture, and the reader
finds nothing."""
from bench.harness.trace import launched_within


def read(trace, ctx):
    ks = launched_within(trace, "bench.model_grad")
    if not ks:
        return None
    return sum(k.dur for k in ks) / 1e3 / trace.rounds
