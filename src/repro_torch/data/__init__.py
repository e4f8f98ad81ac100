from .synthetic import make_classification, make_mnist_like
from .partition import partition_sorted_shards
from .pipeline import FederatedData
