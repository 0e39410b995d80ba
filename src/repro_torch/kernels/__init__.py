"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Built at first use by :mod:`repro_torch.kernels._lib`; see its docstring.
"""
