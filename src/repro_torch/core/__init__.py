from .diversefl import (DiverseFLConfig, c2_ratio, criterion_logs,
                        diversefl_mask, guiding_update, masked_mean_flat,
                        masked_sum_fold, similarity_stats_matrix)
from . import aggregators, attacks, tee
