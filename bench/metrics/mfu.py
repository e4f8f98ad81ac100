"""Model FLOPs of the profiled rounds (``bench/counts/flops.py``: local
steps, guides and evals, no recomputation) over the window's wall time
times the peak of the configuration's compute type."""


def read(trace, ctx):
    flops = ctx["model_flops_per_round"] * trace.rounds
    if flops <= 0 or trace.window_us <= 0:
        return None
    return 100.0 * flops / (trace.window_us * 1e-6 * ctx["peak_flops"])
