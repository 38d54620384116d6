"""PyTorch/CUDA port of molgym_tpu for NVIDIA Hopper GPUs.

The JAX package `molgym_tpu` is the reference; this package mirrors its
module layout and names. It imports torch, numpy and scipy, and nothing of
JAX or of `molgym_tpu`. Entry points run on `cuda` unless the caller passes
`device="cpu"`; without a card and without that argument they raise.
"""
__version__ = '0.1.0'
