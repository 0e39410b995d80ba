"""Tests that need the card (``cuda`` marker): each CUDA ring kernel against
its plain version, flash attention (K6) against its plain version, the
kernel backend against the reference backend on CUDA tensors, the solver
on the GPU against the same solver on the CPU, and the serving model's
prefill on the GPU against the CPU.
Each skips where ``torch.cuda.is_available()`` is false.  This file imports
neither JAX nor the JAX package, so on a GPU machine it runs on its own:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.core import ops as tops
from repro_torch.core.dd.knapsack import random_instance
from repro_torch.core.dd.parallel import parallel_solve
from repro_torch.kernels import cases as C
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.kernels.queue_push.ops import pop_slice, push_scatter
from repro_torch.kernels.queue_steal.ops import steal_gather
from repro_torch.kernels.queue_transfer.ops import transfer_splice
from repro_torch.models.zoo import build_model

ROOT = Path(__file__).resolve().parents[1]
COUNTERS = (steal_gather, push_scatter, pop_slice, transfer_splice)


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _bits(t):
    t = t.detach().cpu()
    return t.view({4: torch.int32, 2: torch.int16, 1: torch.uint8}[
        t.element_size()]) if t.is_floating_point() else t


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """Bitwise, on the case tables and at the solver's geometry in f32,
    i32 and bf16 — the checks ``chip_smoke.py`` runs."""
    dev = _cuda()
    smoke = _chip_smoke()
    seen = set()
    for name, what, k_out, p_out in smoke.kernel_cases(
            dev, np.random.default_rng(0)):
        smoke._compare(k_out, p_out, f"{name} {what}")
        seen.add(name)
    assert len(seen) == 4


@pytest.mark.cuda
def test_kernel_backend_matches_reference_backend_on_the_card():
    """Random op programs on stacked lanes: the ``cuda`` backend (the
    kernels) and the ``reference`` backend (plain PyTorch) on the same
    CUDA tensors give the same states, batches and counts, and the kernels
    really launched."""
    dev = _cuda()
    rng = np.random.default_rng(0)
    lanes, cap = 4, 64
    cuda_ops, ref_ops = tops.make_ops("cuda"), tops.make_ops("reference")

    def rows(*lead):
        return {"id": torch.tensor(rng.integers(0, 10 ** 6, lead),
                                   dtype=torch.int32, device=dev),
                "vec": torch.tensor(rng.standard_normal(lead + (2,)),
                                    dtype=torch.float32, device=dev)}

    def count(hi):
        return torch.tensor(rng.integers(0, hi, lanes), dtype=torch.int32,
                            device=dev)

    q = tops.QueueState(rows(lanes, cap),
                        count(cap), count(cap + 1))
    for fn in COUNTERS:
        fn.launches = 0
    for _ in range(40):
        op = rng.integers(6)
        # each closure binds its random arguments once, for both backends
        if op == 0:
            def apply(o, q, b=rows(lanes, 16), n=count(19)):
                return o.push(q, b, n)
        elif op == 1:
            def apply(o, q, n=count(11)):
                return o.pop_bulk(q, 8, n)
        elif op == 2:
            def apply(o, q, p=float(rng.choice([0.1, 0.5, 0.7]))):
                return o.steal(q, p, max_steal=16)
        elif op == 3:
            def apply(o, q, n=count(21)):
                return o.steal_exact(q, n, max_steal=16)
        elif op == 4:
            def apply(o, q):
                return q, o.window(q, max_steal=16)
        else:
            def apply(o, q, g=rows(3, 16), s=count(3), n=count(21)):
                return o.transfer(q, g, s, n, max_steal=16)
        got, want = apply(cuda_ops, q), apply(ref_ops, q)
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(_bits(a), _bits(b))
        q = want[0]
    assert all(fn.launches > 0 for fn in COUNTERS)


@pytest.mark.cuda
def test_solver_on_the_card_matches_the_cpu():
    dev = _cuda()
    inst = random_instance(20, seed=0)
    kw = dict(n_workers=8, explore_width=8, batch=4)
    on_gpu = parallel_solve(inst, device=dev, backend="cuda", **kw)
    on_cpu = parallel_solve(inst, device="cpu", backend="cuda", **kw)
    assert on_gpu == on_cpu


@pytest.mark.cuda
def test_flash_attention_kernel_matches_plain_version():
    """K6 within the JAX package's tolerances (2e-5 float32, 2e-2 bfloat16)
    on the case tables and at the serving slice's prefill shape, launching
    once per call."""
    dev = _cuda()
    before = mha.launches
    err, n = _chip_smoke().flash_checks(dev, np.random.default_rng(0),
                                        C.FLASH_SLICE)
    torch.cuda.synchronize()
    assert mha.launches - before == n
    assert err < C.FLASH_TOL["bfloat16"]


@pytest.mark.cuda
def test_prefill_on_the_card_matches_the_cpu():
    """Reduced llama3.2-1b and gemma2-9b (window, softcaps, sandwich
    norms) in float32: the same parameters give the same last-position
    logits through K6 on the card as through its plain version on the
    CPU."""
    dev = _cuda()
    for arch in ("llama3.2-1b", "gemma2-9b"):
        cfg = dataclasses.replace(configs.reduced(configs.get(arch)),
                                  compute_dtype="float32")
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        toks = torch.tensor(np.random.default_rng(0).integers(
            1, cfg.vocab_size, (2, 40)), dtype=torch.int32)
        want, _ = model.prefill(params, toks)
        got, cache = model.prefill(tree_map(lambda t: t.to(dev), params),
                                   toks.to(dev))
        assert cache["g0"]["k"].device.type == "cuda"
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
