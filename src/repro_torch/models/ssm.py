"""Mamba2 (SSD — state-space duality) blocks (port of ``repro.models.ssm``).

The chunked SSD algorithm (Dao & Gu, arXiv:2405.21060): split the sequence
into chunks of length Q; within a chunk the output is an attention-like
masked product, across chunks a small recurrence over the per-chunk
states (hd x ns per head) carries the history.  Prefill runs the whole
scan through K7 (:func:`repro_torch.kernels.ssd_scan.ops.ssd`): on the card
its tensor-core kernel in bfloat16 at the SSM archs' widths (the SIMT
kernel in float32), its plain version (``ssd_chunked``, the JAX package's
jnp path) on the CPU.  The JAX package's models call the jnp path; the
port routes it through the kernel, which computes the same function.

Decode is O(1): a state update and a readout per token, plain PyTorch as
in the JAX package.  Parameters keep the JAX package's layout (separate
z / x / B / C / dt projections and per-stream conv weights, stacked on a
leading ``(L, ...)`` dim), so its weights carry over unchanged.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.layers import dense_init, rms_norm

Pytree = Any

__all__ = ["SSMConfig", "SSMCache", "ssm_init", "mamba_block",
           "mamba_decode_step"]


class SSMConfig(NamedTuple):
    d_model: int
    d_inner: int
    n_heads: int          # d_inner // head_dim
    head_dim: int
    state: int            # N — SSM state size
    conv_dim: int         # depthwise causal conv width
    chunk: int            # SSD chunk length


def ssm_init(gen: torch.Generator, L: int, cfg: SSMConfig, dtype) -> Pytree:
    """Parameters for L stacked blocks, on the generator's device."""
    di, ns, nh, D = cfg.d_inner, cfg.state, cfg.n_heads, cfg.d_model
    f32, dev = torch.float32, gen.device
    return {
        "w_z": dense_init(gen, (L, D, di), dtype),
        "w_x": dense_init(gen, (L, D, di), dtype),
        "w_B": dense_init(gen, (L, D, ns), dtype),
        "w_C": dense_init(gen, (L, D, ns), dtype),
        "w_dt": dense_init(gen, (L, D, nh), dtype),
        "conv_x": dense_init(gen, (L, cfg.conv_dim, di), dtype, scale=0.5),
        "conv_B": dense_init(gen, (L, cfg.conv_dim, ns), dtype, scale=0.5),
        "conv_C": dense_init(gen, (L, cfg.conv_dim, ns), dtype, scale=0.5),
        "A_log": torch.zeros((L, nh), dtype=f32, device=dev),  # A = -exp(A_log)
        "D": torch.ones((L, nh), dtype=f32, device=dev),
        "dt_bias": torch.zeros((L, nh), dtype=f32, device=dev),
        "out_proj": dense_init(gen, (L, di, D), dtype),
        "gate_norm": torch.ones((L, di), dtype=dtype, device=dev),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B, S, C), w (K, C)."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):  # K is tiny (4)
        out = out + pad[:, i:i + S, :] * w[i]
    return out


def _project(p: Pytree, x: torch.Tensor, cd):
    """z, x, B, C, dt projections of a (..., D) input in the compute
    dtype ``cd``."""
    xc = x.to(cd)
    return tuple(xc @ p[k].to(cd) for k in ("w_z", "w_x", "w_B", "w_C",
                                            "w_dt"))


def _gate_out(p: Pytree, y: torch.Tensor, z: torch.Tensor, cd):
    """Gated RMSNorm of the scan output, then the out projection."""
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["gate_norm"])
    return y.to(cd) @ p["out_proj"].to(cd)


def mamba_block(p: Pytree, x: torch.Tensor, cfg: SSMConfig, compute_dtype,
                *, capture: bool = False):
    """One Mamba2 block (the pre-norm residual is the caller's).

    x: (B, S, D) -> (B, S, D); ``p`` leaves are one layer's (no L dim).
    With ``capture`` it also returns what decode starts from: the conv
    inputs of the last ``conv_dim - 1`` positions (B, K-1, conv_ch) and
    the final SSD state (B, nh, hd, ns) float32.
    """
    B, S, _ = x.shape
    di, nh, hd = cfg.d_inner, cfg.n_heads, cfg.head_dim
    cd = compute_dtype
    z, xs, Bm, Cm, dt = _project(p, x, cd)
    if capture:
        tail = torch.cat([xs, Bm, Cm], dim=-1)[:, S - (cfg.conv_dim - 1):]
    xs = F.silu(_causal_conv(xs, p["conv_x"].to(cd)))
    Bm = F.silu(_causal_conv(Bm, p["conv_B"].to(cd)))
    Cm = F.silu(_causal_conv(Cm, p["conv_C"].to(cd)))
    dt = F.softplus(dt.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"])
    y, final = ssd_ops.ssd(xs.reshape(B, S, nh, hd), dt, A, Bm, Cm, p["D"],
                           chunk=cfg.chunk)
    out = _gate_out(p, y.reshape(B, S, di), z, cd)
    if capture:
        return out, (tail.to(cd), final)
    return out


# ---------------------------------------------------------------------------
# O(1) decode
# ---------------------------------------------------------------------------


class SSMCache(NamedTuple):
    """conv_buf: (B, K-1, conv_ch) last inputs; state: (B, nh, hd, ns)."""

    conv_buf: torch.Tensor
    state: torch.Tensor


def mamba_decode_step(p: Pytree, x: torch.Tensor, cache: SSMCache,
                      cfg: SSMConfig, compute_dtype
                      ) -> Tuple[torch.Tensor, SSMCache]:
    """x: (B, 1, D) -> ((B, 1, D), the new cache); an O(1) state update."""
    B = x.shape[0]
    di, nh, hd, ns = cfg.d_inner, cfg.n_heads, cfg.head_dim, cfg.state
    cd, f32 = compute_dtype, torch.float32
    z, xs, Bm, Cm, dt = _project(p, x[:, 0], cd)

    conv_in = torch.cat([xs, Bm, Cm], dim=-1)             # (B, conv_ch)
    window = torch.cat([cache.conv_buf, conv_in[:, None, :]], dim=1)
    w = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]],
                  dim=-1).to(cd)                          # (K, conv_ch)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window, w))
    xs, Bm, Cm = (conv_out[..., :di], conv_out[..., di:di + ns],
                  conv_out[..., di + ns:])

    dt = F.softplus(dt.float() + p["dt_bias"][None, :])  # (B, nh)
    A = -torch.exp(p["A_log"])                            # (nh,)
    dA = torch.exp(dt * A[None, :])                       # (B, nh)
    xh = xs.reshape(B, nh, hd).to(f32)
    dBx = torch.einsum("bn,bh,bhd->bhdn", Bm.to(f32), dt, xh)
    state = cache.state * dA[:, :, None, None] + dBx
    y = torch.einsum("bn,bhdn->bhd", Cm.to(f32), state)
    y = (y + xh * p["D"][None, :, None]).reshape(B, di)
    out = _gate_out(p, y, z, cd)
    return out[:, None, :], SSMCache(conv_buf=window[:, 1:, :], state=state)
