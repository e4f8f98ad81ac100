"""Device kernels launched in the profiled window, per round."""


def read(trace, ctx):
    n = len(trace.kernels)
    return n / trace.rounds if n and trace.rounds else None
