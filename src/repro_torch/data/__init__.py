from repro_torch.data.partition import (dirichlet_partition, pad_to_matrix,
                                        random_sizes_partition,
                                        uniform_partition)
from repro_torch.data.synthetic import (Dataset, covtype_like, ijcnn1_like,
                                        lm_tokens, mnist_like)

__all__ = ["Dataset", "covtype_like", "ijcnn1_like", "lm_tokens",
           "mnist_like", "dirichlet_partition", "pad_to_matrix",
           "random_sizes_partition", "uniform_partition"]
