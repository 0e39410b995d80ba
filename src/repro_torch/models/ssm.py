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
in the JAX package.

In the sharded step (``sh`` given, ``with mesh.spmd():``) the mixer
follows the JAX package's specs (``models.hybrid._ssm_specs``): ``w_z``,
``w_x``, ``w_dt``, ``conv_x``, ``A_log``, ``D``, ``dt_bias``, ``gate_norm``
and ``out_proj`` hold this ``tp`` rank's heads (``out_proj``
row-parallel), ``w_B`` / ``w_C`` / ``conv_B`` / ``conv_C`` are whole on
every rank, K7 scans this rank's heads, and the gated RMSNorm sums its
squares over ``tp``.  The decode cache's conv buffer holds every channel
(``P(dp, None, None)``), so a decode step gathers the new x channels.  Parameters keep the JAX package's layout (separate
z / x / B / C / dt projections and per-stream conv weights, stacked on a
leading ``(L, ...)`` dim), so its weights carry over unchanged.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.layers import (dense_init, rms_norm, rms_norm_tp,
                                       tp_copy, tp_gather, tp_info, tp_sum)

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


def _gate_out(p: Pytree, y: torch.Tensor, z: torch.Tensor, cd, sh=None):
    """Gated RMSNorm of the scan output, then the out projection (in the
    sharded step over this ``tp`` rank's columns, summed over ``tp``)."""
    g = y * F.silu(z.float()).to(y.dtype)
    if sh is None:
        return rms_norm(g, p["gate_norm"]).to(cd) @ p["out_proj"].to(cd)
    y = rms_norm_tp(g, p["gate_norm"], sh)
    return tp_sum(y.to(cd) @ p["out_proj"].to(cd), sh)


def _project_tp(p: Pytree, x: torch.Tensor, cd, sh):
    """:func:`_project` on this ``tp`` rank: z, x and dt of its heads (a
    column-parallel input), B and C whole (every rank computes them)."""
    xc = x.to(cd)
    xp = tp_copy(xc, sh)
    return (xp @ p["w_z"].to(cd), xp @ p["w_x"].to(cd),
            xc @ p["w_B"].to(cd), xc @ p["w_C"].to(cd),
            xp @ p["w_dt"].to(cd))


def mamba_block(p: Pytree, x: torch.Tensor, cfg: SSMConfig, compute_dtype,
                *, capture: bool = False, sh=None):
    """One Mamba2 block (the pre-norm residual is the caller's).

    x: (B, S, D) -> (B, S, D); ``p`` leaves are one layer's (no L dim).
    With ``capture`` it also returns what decode starts from: the conv
    inputs of the last ``conv_dim - 1`` positions (B, K-1, conv_ch) and
    the final SSD state (B, nh, hd, ns) float32 (in the sharded step,
    every conv channel and this rank's heads' state).
    """
    B, S, _ = x.shape
    cd = compute_dtype
    if sh is not None and tp_info(sh)[0] > 1:
        z, xs, Bm, Cm, dt = _project_tp(p, x, cd, sh)
    else:
        sh = None
        z, xs, Bm, Cm, dt = _project(p, x, cd)
    hd = cfg.head_dim
    nh = xs.shape[-1] // hd       # this rank's heads
    di = nh * hd
    if capture:     # the last conv_dim - 1 inputs (cut before the cat)
        last = [t[:, S - (cfg.conv_dim - 1):] for t in (xs, Bm, Cm)]
        if sh is not None:
            last[0] = tp_gather(last[0], sh, -1)
        tail = torch.cat(last, dim=-1)
    xs = F.silu(_causal_conv(xs, p["conv_x"].to(cd)))
    Bm = F.silu(_causal_conv(Bm, p["conv_B"].to(cd)))
    Cm = F.silu(_causal_conv(Cm, p["conv_C"].to(cd)))
    if sh is not None:    # each rank scans its own heads with them
        Bm, Cm = tp_copy(Bm, sh), tp_copy(Cm, sh)
    dt = F.softplus(dt.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"])
    y, final = ssd_ops.ssd(xs.reshape(B, S, nh, hd), dt, A, Bm, Cm, p["D"],
                           chunk=cfg.chunk)
    out = _gate_out(p, y.reshape(B, S, di), z, cd, sh)
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
                      cfg: SSMConfig, compute_dtype, sh=None
                      ) -> Tuple[torch.Tensor, SSMCache]:
    """x: (B, 1, D) -> ((B, 1, D), the new cache); an O(1) state update.
    In the sharded step the conv buffer holds every channel and the state
    this ``tp`` rank's heads."""
    B = x.shape[0]
    hd, ns = cfg.head_dim, cfg.state
    cd, f32 = compute_dtype, torch.float32
    n, r = tp_info(sh)
    if n > 1:
        z, xs, Bm, Cm, dt = _project_tp(p, x[:, 0], cd, sh)
    else:
        sh = None
        z, xs, Bm, Cm, dt = _project(p, x[:, 0], cd)
    nh = dt.shape[-1]
    di = nh * hd

    xs_all = xs if sh is None else tp_gather(xs, sh, -1)
    conv_in = torch.cat([xs_all, Bm, Cm], dim=-1)         # (B, conv_ch)
    window = torch.cat([cache.conv_buf, conv_in[:, None, :]], dim=1)
    w = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]],
                  dim=-1).to(cd)                          # (K, conv_ch)
    if sh is None:
        mine = window
    else:       # this rank's x channels, then B and C
        di_all = xs_all.shape[-1]
        mine = torch.cat([window[..., r * di:(r + 1) * di],
                          window[..., di_all:]], dim=-1)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", mine, w))
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
    out = _gate_out(p, y, z, cd, sh)
    return out[:, None, :], SSMCache(conv_buf=window[:, 1:, :], state=state)
