"""Numpy data generators, copied from ``repro.data`` so that the port
imports nothing of the JAX package: the same seed gives the same arrays in
both packages, which is what the parity tests feed them."""
from repro_torch.data.pipeline import ShardedBatches, epoch_batches, partitioned_static
from repro_torch.data import synthetic
