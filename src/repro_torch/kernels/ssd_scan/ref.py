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
both CUDA kernels compute, and the one the wrapper runs on the CPU.
:func:`ssd_chunk_parallel` computes it in the tensor-core kernel's
(``ssd_scan_wgmma.cu``) order, the chunk-parallel form of the SSD paper
(arXiv:2405.21060, section 6), as three tensor functions:
:func:`chunk_states` (each chunk's own state), :func:`pass_states` (the
one sequential step: the state entering each chunk) and
:func:`chunk_output` (y of every chunk at once).  All arithmetic is float32
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

__all__ = ["ssd_chunk_ref", "ssd_chunked", "ssd_chunk_parallel",
           "chunk_states", "pass_states", "chunk_output"]


def _causal(causal: torch.Tensor, diff: torch.Tensor) -> torch.Tensor:
    """``diff`` (the log decay ``cs_i - cs_j``) where ``j <= i``, -inf
    above the diagonal, so that its ``exp`` is the causal decay with zeros
    above.  Masking before the ``exp`` (the JAX package masks after it,
    ``where(causal, exp(diff), 0)``) gives the same values and a finite
    gradient: above the diagonal ``diff`` is the positive sum of the decay
    in between, whose ``exp`` overflows to inf once a chunk's decay passes
    ~88 (at chunk 256 mamba2's reaches ~170), and the backward of the
    masking ``where`` then multiplies that inf by a zero gradient: NaN."""
    return diff.masked_fill(~causal, float("-inf"))


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
    L = torch.exp(_causal(causal, diff)) * dt[None, :]
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
        Lmat = torch.exp(_causal(causal, diff).to(f32))
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


def _chunks(x, dt, Bm, Cm, chunk):
    """x, dt, Bm, Cm in float32 as ``(B, nc, Q, ...)`` chunks, the ragged
    tail padded with dt = 0."""
    S = x.shape[1]
    pad = -S % chunk
    f32 = torch.float32
    out = []
    for t in (x, dt, Bm, Cm):
        t = torch.nn.functional.pad(t.to(f32),
                                    (0, 0) * (t.dim() - 2) + (0, pad))
        out.append(t.reshape((t.shape[0], -1, chunk) + tuple(t.shape[2:])))
    return out


def chunk_states(xq: torch.Tensor, dtq: torch.Tensor, A: torch.Tensor,
                 Bq: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per chunk, from a zero state: the float64 cumsum ``cs`` ``(B, nc, Q,
    nh)`` of dt * a and the chunk's own final state ``(B, nc, nh, hd, ns)``,
    ``sum_j (x_j dt_j exp(cs_last - cs_j))^T B_j``."""
    cs = torch.cumsum((dtq * A.float()).double(), 2)
    w = dtq * torch.exp((cs[:, :, -1:] - cs).float())
    return cs, torch.einsum("bcjh,bcjhd,bcjn->bchdn", w, xq, Bq)


def pass_states(local: torch.Tensor, cs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The state entering each chunk ``(B, nc, nh, hd, ns)`` (zero for the
    first) and the final state: ``S_in[c] = S_in[c - 1] exp(cs_last[c - 1])
    + local[c - 1]``, in float32."""
    seg = torch.exp(cs[:, :, -1].float())[..., None, None]  # (B, nc, nh,..)
    state = torch.zeros_like(local[:, 0])
    s_in = []
    for c in range(local.shape[1]):
        s_in.append(state)
        state = state * seg[:, c] + local[:, c]
    return torch.stack(s_in, 1), state


def chunk_output(xq: torch.Tensor, dtq: torch.Tensor, cs: torch.Tensor,
                 Bq: torch.Tensor, Cq: torch.Tensor, D: torch.Tensor,
                 s_in: torch.Tensor) -> torch.Tensor:
    """y of every chunk ``(B, nc, Q, nh, hd)``: ``(G o L) x + exp(cs) (C
    S_in^T) + D x`` with ``G = C B^T`` once per batch and chunk, ``L_ij =
    exp(cs_i - cs_j) dt_j`` for ``j <= i``."""
    Q = xq.shape[2]
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=xq.device))[:, :, None]
    G = torch.einsum("bcin,bcjn->bcij", Cq, Bq)
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]      # (B,nc,Q,Q,nh)
    L = torch.exp(_causal(causal, diff).float()) * dtq[:, :, None]
    y = torch.einsum("bcij,bcijh,bcjhd->bcihd", G, L, xq)
    y = y + torch.exp(cs.float())[..., None] * torch.einsum(
        "bcin,bchdn->bcihd", Cq, s_in)
    return y + xq * D.float()[:, None]


def ssd_chunk_parallel(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
                       chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`ssd_chunked`'s function (no initial state) in the tensor-core
    kernel's order: chunk states, state passing, chunk output.  float32
    throughout (the kernel splits x w and G o L into three bfloat16 parts
    and S_in into two for its products)."""
    Bsz, S, nh, hd = x.shape
    xq, dtq, Bq, Cq = _chunks(x, dt, Bm, Cm, chunk)
    cs, local = chunk_states(xq, dtq, A, Bq)
    s_in, final = pass_states(local, cs)
    y = chunk_output(xq, dtq, cs, Bq, Cq, D, s_in)
    return y.reshape(Bsz, -1, nh, hd)[:, :S].to(x.dtype), final
