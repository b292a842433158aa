"""repro_torch.data — deterministic token pipeline with packing and the
host-to-device copy of a batch."""
from repro_torch.data.pipeline import TokenDataset, pack_documents, shard_batch

__all__ = ["TokenDataset", "pack_documents", "shard_batch"]
