"""Share of the profiled window in which no operation runs on the device
(the window less the union of kernel, copy and set intervals; the
program's phase marks are no work and are left out)."""
from bench.harness.trace import busy_us


def read(trace, ctx):
    if not trace.work or trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - busy_us(trace) / trace.window_us)
