"""``dequant_fold_update`` (``kernels/csrc/dequant_fold.cu``: the int8
stream's decode fused into the fold, one launch a streamed block): the
least time of a round's launches (``bench/counts/kernels.py``: the int8
codes, the scales, the weights, the accumulator read and written) over
their device time, matched by symbol."""
from bench.metrics._roofline import share

# dequant_fold_kernel<kStaged, R>, demangled or mangled; not the
# per-column kernel the program keeps only for its own check
PATTERN = r"dequant_fold_kernel"


def read(trace, ctx):
    return share(trace, ctx, "dequant_fold_update", PATTERN)
