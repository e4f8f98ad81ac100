from . import ops
from .dequant_fold import (dequant_fold_update_cuda, dequant_fold_update_plain,
                           dequant_int8)
from .masked_agg import (masked_agg_cuda, masked_agg_plain,
                         masked_agg_update_cuda, masked_agg_update_plain)
from .robust_agg import robust_agg_cuda, robust_agg_plain
from .similarity import similarity_cuda, similarity_plain
