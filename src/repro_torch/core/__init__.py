from .diversefl import (DiverseFLConfig, c2_ratio, criterion_logs,
                        diversefl_aggregate, diversefl_mask, guiding_update,
                        masked_mean, masked_mean_flat, masked_sum_fold,
                        similarity_stats, similarity_stats_matrix,
                        similarity_stats_tree)
from . import aggregators, attacks, sample_filter, tee
