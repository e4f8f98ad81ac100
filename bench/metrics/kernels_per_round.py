"""Device kernels launched in the profiled window, per round; the
program's phase marks are no work and are left out."""


def read(trace, ctx):
    n = len(trace.kernels)
    return n / trace.rounds if n and trace.rounds else None
