"""PyTorch / CUDA port of the bulk work-stealing queue and the parallel DD
solver built on it.

Mirrors the JAX package ``repro`` module by module (``repro_torch.core.ops``
is the counterpart of ``repro.core.ops``, and so on), imports neither JAX
nor ``repro``, and runs its ring-buffer hot path through CUDA kernels
written for Hopper (``repro_torch.kernels``).  Entry points run on the GPU
unless the caller passes ``device="cpu"``.
"""
