"""``masked_aggregate`` (``kernels/csrc/masked_agg.cu`` with a bool mask:
Eq. 6's dense masked mean): bytes read once over the device time."""
from bench.metrics._roofline import share

# masked_agg_kernel<R, U, W> with W = bool, demangled or mangled (b)
PATTERN = r"masked_agg_kernel(<\d+, [\w:]+, bool>|ILi\d+E\w+?bEv)"


def read(trace, ctx):
    return share(trace, ctx, "masked_aggregate", PATTERN)
