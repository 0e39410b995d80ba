"""Plain PyTorch version of K7 ``ssd_scan``: the Mamba2 SSD chunked scan.

For ONE chunk (per batch x head): given x (Q, hd), dt (Q,), a (scalar,
negative), B (Q, ns), C (Q, ns) and the carried state (hd, ns):

    cs_i   = cumsum(dt * a)                      (within-chunk log decay)
    L_ij   = exp(cs_i - cs_j) * dt_j   (j <= i)
    y_i    = sum_j (C_i . B_j) L_ij x_j          (intra)
           + (C_i . state) exp(cs_i)             (inter: carried state)
           + D x_i                               (skip)
    state' = state * exp(cs_Q) + sum_j B_j dt_j exp(cs_Q - cs_j) x_j

:func:`ssd_chunk_ref` is that one chunk (port of the JAX package's
``kernels/ssd_scan/ref.ssd_chunk_ref``); :func:`ssd_chunked` is the whole
scan at the model layout (port of ``models/ssm.ssd_chunked``), a loop over
the chunks carrying the float32 ``(B, nh, hd, ns)`` state — the function
the CUDA kernel (``ssd_scan.cu``) computes.  All arithmetic is float32
but, in ``ssd_chunked``, the within-chunk cumsum and its differences,
which are float64 (then exp in float32), as in the CUDA kernel: at chunk
256 the cumsum reaches about -170, where a float32 step is 1.5e-5, and
its rounding, which differs with the order of summation, would be the
scan's largest error (``scripts/ssd_precision.py`` measures it).  The
JAX package keeps the cumsum in float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["ssd_chunk_ref", "ssd_chunked"]


def ssd_chunk_ref(x: torch.Tensor, dt: torch.Tensor, a, B: torch.Tensor,
                  C: torch.Tensor, D, state: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (Q, hd), dt: (Q,), a: scalar, B/C: (Q, ns), D: scalar,
    state: (hd, ns).  Returns (y (Q, hd), new_state (hd, ns)), float32."""
    Q = x.shape[0]
    x, dt, B, C, state = (t.float() for t in (x, dt, B, C, state))
    cs = torch.cumsum(dt * a, 0)                          # (Q,)
    diff = cs[:, None] - cs[None, :]                      # (Q, Q)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))
    L = torch.where(causal, torch.exp(diff), 0.0) * dt[None, :]
    G = C @ B.T                                           # (Q, Q)
    y = (G * L) @ x                                       # intra
    y = y + torch.exp(cs)[:, None] * (C @ state.T)        # inter
    y = y + D * x                                         # skip
    seg = torch.exp(cs[-1])
    w = dt * torch.exp(cs[-1] - cs)                       # (Q,)
    new_state = state * seg + torch.einsum("qh,qn->hn", x * w[:, None], B)
    return y, new_state


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
                chunk: int, init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan at the model layout.

    x:  (B, S, nh, hd)    dt: (B, S, nh) (softplus'd, > 0)
    A:  (nh,) (negative)  Bm/Cm: (B, S, ns)   D: (nh,)
    Returns (y (B, S, nh, hd) in x's dtype, final_state (B, nh, hd, ns)
    float32).

    A ragged tail is padded up to a chunk multiple with dt = 0: zero dt
    adds nothing to the state and decays it by exp(0) = 1, so the final
    state is exact; the padded rows of y are cut off.
    """
    Bsz, S, nh, hd = x.shape
    ns = Bm.shape[-1]
    Q = chunk
    f32 = torch.float32
    S_orig = S
    if S % Q:
        pad = Q - S % Q
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        Bm = torch.nn.functional.pad(Bm, (0, 0, 0, pad))
        Cm = torch.nn.functional.pad(Cm, (0, 0, 0, pad))
        S = S + pad
    nc = S // Q
    xq = x.reshape(Bsz, nc, Q, nh, hd).to(f32)
    dtq = dt.reshape(Bsz, nc, Q, nh).to(f32)
    Bq = Bm.reshape(Bsz, nc, Q, ns).to(f32)
    Cq = Cm.reshape(Bsz, nc, Q, ns).to(f32)
    A, D = A.to(f32), D.to(f32)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))[None, :, :, None]

    state = (torch.zeros((Bsz, nh, hd, ns), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    ys = []
    for c in range(nc):
        xc, dtc, Bc, Cc = xq[:, c], dtq[:, c], Bq[:, c], Cq[:, c]
        dA = dtc * A[None, None, :]                       # (B,Q,nh), <= 0
        cs = torch.cumsum(dA.double(), 1)                 # float64
        seg_end = cs[:, -1, :]                            # (B,nh)

        # intra-chunk: L[i,j,h] = exp(cs_i - cs_j) for j <= i
        diff = cs[:, :, None, :] - cs[:, None, :, :]      # (B,Q,Q,nh)
        Lmat = torch.where(causal, torch.exp(diff.to(f32)), 0.0)
        G = torch.einsum("bin,bjn->bij", Cc, Bc)          # (B,Q,Q)
        M = G[..., None] * Lmat * dtc[:, None, :, :]      # (B,Q,Q,nh)
        y_intra = torch.einsum("bijh,bjhd->bihd", M, xc)

        # inter-chunk: contribution of the carried state, then update it.
        y_inter = torch.einsum("bin,bhdn,bih->bihd", Cc, state,
                               torch.exp(cs.to(f32)))
        decay_to_end = torch.exp((seg_end[:, None, :] - cs).to(f32))
        st_c = torch.einsum("bjn,bjh,bjhd->bhdn", Bc, dtc * decay_to_end,
                            xc)
        state = state * torch.exp(seg_end.to(f32))[:, :, None, None] + st_c
        ys.append(y_intra + y_inter + xc * D[None, None, :, None])
    y = torch.cat(ys, 1)[:, :S_orig]
    return y.to(x.dtype), state
