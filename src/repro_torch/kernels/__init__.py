from . import ops
from .masked_agg import masked_agg_cuda, masked_agg_plain
from .similarity import similarity_cuda, similarity_plain
