from .small_models import (SmallModel, mlp3, small_cnn, softmax_regression,
                           vgg11)
from .server import (AggregationContext, SecureServer, aggregate,
                     available_aggregators, get_aggregator,
                     register_aggregator)
from .simulator import (FLConfig, Federation, make_round_body,
                        run_federated_training)
from .telemetry import GENESIS, AuditLog, verify_entries
from . import metrics
