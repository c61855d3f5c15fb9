"""Data path of the port: file reading -> reduction and filtering ->
Markov pairing or sliding windows -> normalization -> batched loaders with resolution
buckets. Host-side numpy (spectral transforms on CPU tensors), as in the
JAX package's data/ layer; the Trainer copies batches to the card.
"""

from resolution_pde_tpu_torch.data.dataset import (
    ArrayDataset,
    MinMaxNormalizer,
    MultiResDataset,
    MultiResTrajectoryDataset,
    TrajectoryDataset,
    fit_normalizers,
)
from resolution_pde_tpu_torch.data.factories import (
    ks_markov_dataset,
    ks_multires_markov_dataset,
    ks_pino_markov_dataset,
    ks_resize_multires_markov_dataset,
    ks_true_multires_markov_dataset,
    ks_window_dataset,
    ns_markov_dataset,
    ns_true_multires_markov_dataset,
)
from resolution_pde_tpu_torch.data.loader import (
    Loader,
    ResolutionBucketedLoader,
    create_grouped_dataloaders,
)

__all__ = [
    "ArrayDataset",
    "Loader",
    "MinMaxNormalizer",
    "MultiResDataset",
    "MultiResTrajectoryDataset",
    "ResolutionBucketedLoader",
    "TrajectoryDataset",
    "create_grouped_dataloaders",
    "fit_normalizers",
    "ks_markov_dataset",
    "ks_multires_markov_dataset",
    "ks_pino_markov_dataset",
    "ks_resize_multires_markov_dataset",
    "ks_true_multires_markov_dataset",
    "ks_window_dataset",
    "ns_markov_dataset",
    "ns_true_multires_markov_dataset",
]
