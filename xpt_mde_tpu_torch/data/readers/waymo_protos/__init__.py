"""Vendored minimal Waymo Open Dataset proto schema (see dataset.proto);
a copy of the JAX package's, byte for byte, so both can load in one
process."""

from xpt_mde_tpu_torch.data.readers.waymo_protos import dataset_pb2

__all__ = ["dataset_pb2"]
