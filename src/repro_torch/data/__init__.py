from .synthetic import (make_cifar_like, make_classification, make_mnist_like,
                        make_token_stream)
from .partition import (partition_dirichlet, partition_sorted_shards,
                        partition_two_shards)
from .pipeline import ClientDataset, FederatedData, batch_iterator
