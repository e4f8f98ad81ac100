from .small_models import (SmallModel, mlp3, small_cnn, softmax_regression,
                           vgg11)
from .server import (AggregationContext, SecureServer, aggregate,
                     available_aggregators, get_aggregator,
                     register_aggregator)
from .chunking import chunked_vmap
from .compression import (Codec, available_codecs, encode_with_feedback,
                          get_codec, quantize_tree, register_codec,
                          wire_bytes)
from .faults import (FAULT_KINDS, DegenerateCohortError, FaultConfig,
                     draw_faults, make_cohort_chain, validate_cohort_chain)
from .streaming import (StreamingAggregator, fallback_reason, get_streaming,
                        register_streaming, stream_aggregate, streaming_rules,
                        tree_merge, weighted_mean_rule)
from .simulator import (FLConfig, Federation, host_sync,
                        run_federated_sweep, run_federated_training)
from .engine import (RoundEngine, make_round_body, make_scenario,
                     trace_counter, trace_counts)
from .sweep import SweepCell, SweepSpec, group_cells, structural_key
from .telemetry import (GENESIS, AuditLog, Recorder, event, export_jsonl,
                        get_recorder, load_jsonl, recording, span,
                        verify_entries)
from .zoo import (ZooModel, make_zoo_data, make_zoo_federation,
                  zoo_model)
from . import metrics, rsa, telemetry
