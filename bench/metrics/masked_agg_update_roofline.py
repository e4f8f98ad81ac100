"""``masked_agg_update`` (``kernels/csrc/masked_agg.cu`` with fp32
weights and an accumulator: the streaming fold): bytes read once over the
device time."""
from bench.metrics._roofline import share

# masked_agg_kernel<R, U, W> with W = float, demangled or mangled (f)
PATTERN = r"masked_agg_kernel(<\d+, [\w:]+, float>|ILi\d+E\w+?fEv)"


def read(trace, ctx):
    return share(trace, ctx, "masked_agg_update", PATTERN)
