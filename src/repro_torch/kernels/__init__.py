from . import ops
from .masked_agg import (masked_agg_cuda, masked_agg_plain,
                         masked_agg_update_cuda, masked_agg_update_plain)
from .robust_agg import robust_agg_cuda, robust_agg_plain
from .similarity import similarity_cuda, similarity_plain
