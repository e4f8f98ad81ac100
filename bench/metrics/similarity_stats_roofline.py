"""``similarity_stats`` (``kernels/csrc/similarity.cu``): bytes of U and G
read once at 3.35 TB/s over the kernel's device time."""
from bench.metrics._roofline import share

# the kernel's symbol, demangled or mangled
PATTERN = r"similarity_stats_kernel"


def read(trace, ctx):
    return share(trace, ctx, "similarity_stats", PATTERN)
