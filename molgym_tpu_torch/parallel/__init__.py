"""Data parallelism over torch.distributed (counterpart of
molgym_tpu/parallel)."""
