"""Wrapper of K7 ``ssd_scan`` at the model layout.

``ssd(x, dt, A, Bm, Cm, D, chunk=Q)`` takes x ``(B, S, nh, hd)``, dt
``(B, S, nh)``, A and D ``(nh,)`` and Bm, Cm ``(B, S, ns)``, as the JAX
package's ``kernels.ssd_scan.ops.ssd`` does, and returns ``(y (B, S, nh,
hd) in x's dtype, final_state (B, nh, hd, ns) float32)``.  For a CUDA
tensor it launches the CUDA kernel (``ssd_scan.cu``: x, Bm, Cm in float32
or bfloat16, dt, A, D in float32; head dims 8, 16, 32, 64; state widths
8 to 128; any ``S >= 0`` and chunk, a ragged last chunk masked in the
kernel); for a CPU tensor it runs the plain version
(``ref.ssd_chunked``).  There is no other route: a CUDA tensor the kernel
does not take raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ssd_scan.ref import ssd_chunked

__all__ = ["ssd", "HEAD_DIMS", "STATE_DIMS"]

HEAD_DIMS = (8, 16, 32, 64)
STATE_DIMS = (8, 16, 32, 64, 128)
MAX_CHUNK = 2048
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor, *,
        chunk: int):
    """Chunked SSD scan; ``ssd.launches`` counts the CUDA launches."""
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, Bm, Cm, D, chunk)
    B, S, nh, hd = x.shape
    ns = Bm.shape[-1]
    dev = _lib.check_cuda(x, dt, A, Bm, Cm, D)
    shapes = {"dt": (dt, (B, S, nh)), "A": (A, (nh,)), "D": (D, (nh,)),
              "Bm": (Bm, (B, S, ns)), "Cm": (Cm, (B, S, ns))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")
    if hd not in HEAD_DIMS or ns not in STATE_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS} or state width "
                         f"{ns} not in {STATE_DIMS}")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"dtypes {x.dtype}, {Bm.dtype}, {Cm.dtype}: the "
                         f"kernel takes float32 or bfloat16, all alike")
    if any(t.dtype != torch.float32 for t in (dt, A, D)):
        raise ValueError("dt, A and D must be float32")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} not in 1..{MAX_CHUNK}")
    if B > 65535:
        raise ValueError(f"batch {B} past the grid's 65,535")
    y = torch.empty_like(x)
    fin = torch.empty((B, nh, hd, ns), dtype=torch.float32, device=dev)
    if B == 0 or nh == 0:
        return y, fin
    _lib.launch("ss_ssd_scan", x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(), y.data_ptr(),
                fin.data_ptr(), B, S, nh, hd, ns, chunk, _DTYPES[x.dtype],
                device=dev)
    ssd.launches += 1
    return y, fin


ssd.launches = 0
