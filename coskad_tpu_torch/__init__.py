"""coskad_tpu_torch: the PyTorch/CUDA port of coskad_tpu, for NVIDIA H100.

A second package beside `coskad_tpu` (the JAX reference, left unchanged).
It imports torch and numpy, never jax and nothing of `coskad_tpu`. Entry
points default to `device="cuda"` and raise where CUDA is missing; pass
`device="cpu"` for the plain PyTorch path (what the tests do).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
