"""Tests that need the card (``cuda`` marker): each CUDA ring kernel against
its plain version, DD layer expansion (K5) and its redesign, the fused DD
explore, flash attention (K6) and the SSD scan (K7, both routes) against
their plain versions, the kernel backend against the reference backend on
CUDA tensors, the relaxed and the sanitized backends against the kernel
backend and the linearizability sweep on the card, the solver on the GPU
against the same solver on the CPU, two gloo ranks' lanes on the card
against the stacked runtime, and the serving models' prefill on the GPU
against the CPU.
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
from repro_torch.kernels.dd_expand.ops import expand_pool, explore_fused
from repro_torch.kernels.flash_attention.ops import mha, mha_simt
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.queue_push.ops import pop_slice, push_scatter
from repro_torch.kernels.queue_steal.ops import steal_gather
from repro_torch.kernels.queue_transfer.ops import transfer_splice
from repro_torch.kernels.ssd_scan.ops import (TENSOR_CORE, route, ssd,
                                              ssd_simt)
from repro_torch.kernels.ssd_scan.ref import ssd_chunked
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
def test_ring_copy_kernels_launch_once_per_tree():
    """K1 and K4 move a payload tree in one launch per eight leaves, not
    one per leaf, bit for bit against the plain versions: the mixed-dtype
    tree in one launch each, twelve leaves in two."""
    dev = _cuda()
    smoke = _chip_smoke()
    rng = np.random.default_rng(0)
    for leaves, launches in ((C.TREE_LEAVES, 1), (smoke.many_leaves(), 2)):
        before = (steal_gather.launches, transfer_splice.launches)
        rows = list(smoke.tree_cases(dev, rng, leaves))
        for name, what, k_out, p_out in rows:
            smoke._compare(k_out, p_out, f"{name} {what}")
        assert len(rows) == 2 * len(leaves)
        assert (steal_gather.launches - before[0],
                transfer_splice.launches - before[1]) == (launches, launches)


@pytest.mark.cuda
def test_ring_copy_kernels_match_plain_versions_on_misaligned_rows():
    """K1, K2 and K4's byte path bit for bit against the plain versions:
    rows of 4, 12, 20 and 6 bytes at every offset mod 16, bases off a
    16-byte boundary, segments that lap the ring, K2's negative starts and
    n past max_push, a short last window."""
    dev = _cuda()
    smoke = _chip_smoke()
    names = set()
    for name, what, k_out, p_out in smoke.byte_cases(
            dev, np.random.default_rng(0)):
        smoke._compare(k_out, p_out, f"{name} {what}")
        names.add(name)
    assert names == {"ring_gather", "ring_scatter", "ring_transfer"}


@pytest.mark.cuda
def test_ring_transfer_on_the_shared_scatter_matches_plain_version():
    """K4, whose direct part runs on the scatter it shares with K2, stays
    bit for bit with its plain version on ``cases.TRANSFER_BYTE_CASES``
    (negative source rows, rows past the stack, n = cap), one launch a
    case."""
    dev = _cuda()
    smoke = _chip_smoke()
    rng = np.random.default_rng(0)
    before = transfer_splice.launches
    for cap, d, w, m, head, src, n, dt in C.TRANSFER_BYTE_CASES:
        name, what, k_out, p_out = smoke._transfer_case(
            dev, rng, len(head), cap, d, w * m, m, head, src, n, dt,
            f"bytes {cap},{d},{w},{m},{dt}")
        smoke._compare(k_out, p_out, f"{name} {what}")
    assert transfer_splice.launches - before == len(C.TRANSFER_BYTE_CASES)


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
@pytest.mark.parametrize("exchange", ["compact", "dense"])
def test_relaxed_and_checked_supersteps_match_cuda_on_the_card(exchange):
    """Rebalancing rounds from a seeded backlog on the card: the relaxed
    backend and the kernel backend under the sanitizer end bit-equal to
    the plain kernel backend, with no violation; the relaxed steal went
    through K1."""
    from repro_torch.analysis import sanitize
    from repro_torch.core.policy import StealPolicy
    from repro_torch.runtime.executor import StealRuntime

    dev = _cuda()
    rng = np.random.default_rng(1)
    ids = torch.tensor(rng.permutation(4 * 700) + 1, dtype=torch.int32)
    spec = {"id": torch.zeros((), dtype=torch.int32),
            "w": torch.zeros((), dtype=torch.float32)}
    sanitize.reset_violations()
    out = {}
    for name in ("cuda", "relaxed", "cuda+check"):
        backend = (tops.make_ops("cuda", check=True) if name == "cuda+check"
                   else name)
        rt = StealRuntime(8, 1024, spec, backend=backend, device=dev,
                          policy=StealPolicy(max_steal=512,
                                             exchange=exchange))
        assert rt.ops.resolved == name.split("+")[0]
        for j in range(4):
            part = ids[j * 700:(j + 1) * 700]
            rt.push(2 * j, {"id": part, "w": part.float() / 7}, 700)
        steal_gather.launches = 0
        rt.run_fused(6)
        rt.round()
        if name == "relaxed":
            assert steal_gather.launches > 0
        out[name] = rt.queues
    for name in ("relaxed", "cuda+check"):
        for a, b in zip(tree_leaves(out[name]), tree_leaves(out["cuda"])):
            assert torch.equal(_bits(a), _bits(b)), name
    assert sanitize.violations() == ()


@pytest.mark.cuda
def test_linearize_sweep_on_the_card():
    """The model checker at (4, 2) with the shared queue on the card: the
    pinned history counts, no violation, both mutations caught."""
    from repro_torch.analysis import linearize

    dev = _cuda()
    counts = {}
    _, bad = linearize.check_all(("reference", "cuda", "relaxed"),
                                 geometries=((4, 2),), device=dev,
                                 counts=counts)
    assert bad == [], bad[:3]
    assert counts == {("reference", 4, 2): 330, ("cuda", 4, 2): 330,
                      ("relaxed", 4, 2): 636}
    assert all(n > 0 for n in linearize.run_mutations(device=dev).values())


@pytest.mark.cuda
def test_flash_attention_kernel_matches_plain_version():
    """K6 within the JAX package's tolerances (2e-5 float32, 2e-2 bfloat16)
    on the case tables (the unmasked S != T and ragged rows among them)
    and at the serving slice's and zamba2-7b's prefill shapes, launching
    once per call: bfloat16 on the tensor-core route, float32 on the SIMT
    kernel."""
    dev = _cuda()
    shapes = (C.FLASH_SLICE, C.FLASH_ZAMBA)
    before, before_tc = mha.launches, mha.launches_tc
    err, n = _chip_smoke().flash_checks(dev, np.random.default_rng(0),
                                        shapes)
    torch.cuda.synchronize()
    bf16 = sum(c[-1] == "bfloat16" for c in
               C.FLASH_CASES + C.FLASH_EXTRA_CASES + C.FLASH_RAGGED_CASES
               + list(shapes))
    assert mha.launches - before == n
    assert mha.launches_tc - before_tc == bf16 < n
    assert err < C.FLASH_TOL["bfloat16"]


@pytest.mark.cuda
def test_simt_flash_kernel_in_bfloat16_matches_plain_version():
    """The earlier bf16 design, kept for timing beside the tensor-core
    kernel, still holds its tolerance and stays off ``mha``'s counters."""
    dev = _cuda()
    smoke = _chip_smoke()
    rng = np.random.default_rng(0)
    before = (mha.launches, mha.launches_tc)
    for case in C.FLASH_CASES + C.FLASH_EXTRA_CASES + C.FLASH_RAGGED_CASES:
        if case[-1] != "bfloat16":
            continue
        q, k, v = smoke._flash_inputs(dev, rng, case)
        kw = dict(causal=case[6], window=case[7], softcap=case[8])
        smoke._close(mha_simt(q, k, v, **kw), attention_ref(q, k, v, **kw),
                     C.FLASH_TOL["bfloat16"], f"SIMT kernel {case}")
    assert (mha.launches, mha.launches_tc) == before


@pytest.mark.cuda
def test_dd_expand_kernel_matches_plain_version():
    """K5 bit for bit on the JAX package's table and at the solver's pools,
    launching once per call."""
    dev = _cuda()
    before = expand_pool.launches
    err, n = _chip_smoke().expand_checks(dev, np.random.default_rng(0))
    torch.cuda.synchronize()
    assert expand_pool.launches - before == n
    assert err == 0.0


@pytest.mark.cuda
def test_slice_tree_launches_once_per_tree():
    """K3 moves a payload tree in one launch per eight leaves, bit for bit
    against the plain version: the mixed-dtype tree in one launch, twelve
    leaves in two."""
    dev = _cuda()
    smoke = _chip_smoke()
    rng = np.random.default_rng(0)
    for leaves, launches in ((C.TREE_LEAVES, 1), (smoke.many_leaves(), 2)):
        before = pop_slice.launches
        rows = list(smoke.slice_tree_cases(dev, rng, leaves))
        for name, what, k_out, p_out in rows:
            smoke._compare(k_out, p_out, f"{name} {what}")
        assert len(rows) == len(leaves)
        assert pop_slice.launches - before == launches


@pytest.mark.cuda
def test_scatter_tree_launches_once_per_tree():
    """K2 moves a payload tree in one launch per eight leaves, bit for bit
    against the plain version at ``cases.SCATTER_TREE_CASE`` (a wrapping
    lane, n = 0, a negative start with n past max_push): the mixed-dtype
    tree in one launch, twelve leaves in two."""
    dev = _cuda()
    smoke = _chip_smoke()
    rng = np.random.default_rng(0)
    for leaves, launches in ((C.TREE_LEAVES, 1), (smoke.many_leaves(), 2)):
        before = push_scatter.launches
        rows = list(smoke.scatter_tree_cases(dev, rng, leaves))
        for name, what, k_out, p_out in rows:
            smoke._compare(k_out, p_out, f"{name} {what}")
        assert len(rows) == len(leaves)
        assert push_scatter.launches - before == launches


@pytest.mark.cuda
def test_explore_kernel_matches_plain_version():
    """K5's redesign, the fused DD explore, bit for bit against its plain
    version on ``cases.EXPLORE_CASES``, one launch per call and no K5
    launch per layer."""
    dev = _cuda()
    before = (explore_fused.launches, expand_pool.launches)
    err, n = _chip_smoke().explore_checks(dev, np.random.default_rng(0))
    torch.cuda.synchronize()
    assert n == len(C.EXPLORE_CASES)
    assert (explore_fused.launches - before[0],
            expand_pool.launches - before[1]) == (n, 0)
    assert err == 0.0


@pytest.mark.cuda
def test_explore_kernel_refuses_widths_it_does_not_take():
    """Pool widths 2 to 32 (one slot per lane); any other raises, as do
    inputs of another type, and nothing launches."""
    dev = _cuda()
    z = torch.zeros((4,), dtype=torch.int32, device=dev)
    before = explore_fused.launches
    for width in (1, 33):
        with pytest.raises(ValueError, match="widths 2 to 32"):
            explore_fused(z, z, z, z.bool(), z, z, width=width, n_vars=4)
    with pytest.raises(ValueError, match="int32"):
        explore_fused(z.long(), z, z, z.bool(), z, z, width=4, n_vars=4)
    with pytest.raises(ValueError, match="bool"):
        explore_fused(z, z, z, z, z, z, width=4, n_vars=4)
    with pytest.raises(ValueError, match="n_vars"):
        explore_fused(z, z, z, z.bool(), z, z, width=4, n_vars=5)
    assert explore_fused.launches == before


@pytest.mark.cuda
def test_ssd_scan_kernel_matches_plain_version():
    """K7 within atol 5e-5 / rtol 5e-4 in float32 (2e-2 / 2e-2 in
    bfloat16) on the case tables and their bfloat16 copies, ragged lengths
    among them, and at the SSM slice's and zamba2-7b's prefill shapes,
    counted once per call; the bfloat16 calls at head dim 64, state widths
    64 and 128 and chunks of 64 to 256 on the tensor-core route.  Every
    output is then held once more to ``cases.SSD_TOL`` of its dtype in the
    JAX package's ``assert_allclose`` form, |got - want| <= atol + rtol x
    |want| (the tensor-core route sums in another order than the plain
    version, so an output of |y| >= 4 may land one bfloat16 step, 0.03125,
    away); on the tensor-core route's calls so is the SIMT kernel in
    bfloat16, its earlier design, outside ``ssd``'s counters."""
    dev = _cuda()
    shapes = (C.SSD_SLICE, C.SSD_HYBRID)
    before, before_tc = ssd.launches, ssd.launches_tc
    smoke = _chip_smoke()
    _, n = smoke.ssd_checks(dev, np.random.default_rng(0), shapes)
    torch.cuda.synchronize()
    cases = smoke.ssd_cases(shapes)
    tc = [route(getattr(torch, c[6]), c[3], c[4], c[5]) == TENSOR_CORE
          for c in cases]
    assert ssd.launches - before == n == len(cases)
    assert ssd.launches_tc - before_tc == sum(tc) == 8
    rng = np.random.default_rng(0)
    worst = 0.0
    for case, on_tc in zip(cases, tc):
        args = C.ssd_inputs(rng, case, dev)
        plain = ssd_chunked(*args, case[5])
        atol, rtol = C.SSD_TOL[case[6]]
        for fn in (ssd, ssd_simt) if on_tc else (ssd,):
            for got, want in zip(fn(*args, chunk=case[5]), plain):
                got, want = got.float(), want.float()
                assert bool(torch.isfinite(got).all()), (fn.__name__, case)
                ratio = float(((got - want).abs()
                               / (atol + rtol * want.abs())).max())
                assert ratio <= 1.0, (fn.__name__, case, ratio)
                worst = max(worst, ratio)
    print(f"ssd_scan: largest |got - want| / (atol + rtol |want|) {worst}")


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take():
    """No fallback: a CUDA tensor the kernel cannot take raises."""
    dev = _cuda()
    nodes = torch.zeros((2, 8), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="int32"):
        expand_pool(nodes, nodes, 3, 4)
    with pytest.raises(ValueError, match="int32"):
        expand_pool(nodes.int(), nodes.int(),
                    torch.tensor(3, device=dev), 4)
    x = torch.zeros((1, 8, 2, 48), device=dev)  # head dim 48
    with pytest.raises(ValueError, match="head dim"):
        ssd(x, torch.zeros((1, 8, 2), device=dev), torch.zeros(2, device=dev),
            torch.zeros((1, 8, 16), device=dev),
            torch.zeros((1, 8, 16), device=dev), torch.zeros(2, device=dev),
            chunk=4)
    q = torch.zeros((1, 8, 2, 48), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        mha(q, q, q)
    q = torch.zeros((1, 8, 2, 64), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mha(q, q, q)
    flat = torch.zeros(8 * 2 * 64 + 1, device=dev, dtype=torch.bfloat16)
    q = flat[1:].view(1, 8, 2, 64)  # 2 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte aligned"):
        mha(q, q, q)


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


@pytest.mark.cuda
def test_encdec_prefill_on_the_card_launches_k6_per_attention():
    """Reduced seamless-m4t-medium: a bf16 prefill launches K6 once per
    encoder layer and twice per decoder layer (self, cross), all on the
    tensor-core kernel; in float32 the card's logits and both caches
    equal the CPU's (K6's plain version) within 1e-4."""
    dev = _cuda()
    cfg = configs.reduced(configs.get("seamless-m4t-medium"))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    frames = torch.tensor(rng.standard_normal((2, 100, cfg.frontend_dim)),
                          dtype=torch.float32)
    toks = torch.tensor(rng.integers(1, cfg.vocab_size, (2, 24)),
                        dtype=torch.int32)
    on_card = tree_map(lambda t: t.to(dev), params)
    before, before_tc = mha.launches, mha.launches_tc
    logits, _ = model.prefill(on_card, frames.to(dev), toks.to(dev))
    torch.cuda.synchronize()
    n = cfg.n_encoder_layers + 2 * cfg.n_layers
    assert mha.launches - before == n == mha.launches_tc - before_tc
    assert bool(torch.isfinite(logits).all())
    f32 = build_model(dataclasses.replace(cfg, compute_dtype="float32"))
    want, wcache = f32.prefill(params, frames, toks)
    got, gcache = f32.prefill(on_card, frames.to(dev), toks.to(dev))
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    for part in ("self", "cross"):
        for kv in ("k", "v"):
            torch.testing.assert_close(gcache[part][kv].cpu(),
                                       wcache[part][kv], atol=1e-4,
                                       rtol=1e-4)


@pytest.mark.cuda
def test_ssm_prefill_on_the_card_matches_the_cpu():
    """Reduced mamba2-2.7b and zamba2-7b in float32 on a ragged length: the
    same parameters give the same last-position logits and SSD states
    through K7 (and K6) on the card as through the plain versions on the
    CPU."""
    dev = _cuda()
    for arch in ("mamba2-2.7b", "zamba2-7b"):
        cfg = dataclasses.replace(configs.reduced(configs.get(arch)),
                                  compute_dtype="float32")
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        toks = torch.tensor(np.random.default_rng(0).integers(
            1, cfg.vocab_size, (2, 45)), dtype=torch.int32)
        want, want_cache = model.prefill(params, toks)
        before = ssd.launches
        got, cache = model.prefill(tree_map(lambda t: t.to(dev), params),
                                   toks.to(dev))
        assert ssd.launches - before == cfg.n_layers
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
        for a, b in zip(tree_leaves({k: v for k, v in cache.items()
                                     if k != "pos"}),
                        tree_leaves({k: v for k, v in want_cache.items()
                                     if k != "pos"})):
            torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)


def _dag_replay(device, plan, pod_size):
    """chip_smoke's Fig. 9 DAG at its CPU size, drained on ``device``:
    ``(runtime, carry, rounds dispatched, launches)``."""
    smoke = _chip_smoke()
    cfg = smoke.PHASE8_SMALL
    rt = smoke._dag_runtime(device, cfg, plan, pod_size)
    body = smoke.dag_body(rt.ops, n_nodes=cfg["n_nodes"], pop=cfg["pop"],
                          fanout=cfg["fanout"])
    for fn in COUNTERS:
        fn.launches = 0
    carry, _, dispatched = smoke._drain(
        rt, body, torch.zeros((cfg["lanes"],), dtype=torch.int32,
                              device=device), cfg["block"])
    launches = [fn.launches for fn in COUNTERS]
    return rt, carry, dispatched, launches


@pytest.mark.cuda
@pytest.mark.parametrize("hier", [False, True])
def test_fault_replays_on_the_card_match_the_cpu(hier):
    """The flat and the hierarchical fault replays on CUDA tensors are bit
    for bit the same program on the CPU, with K1 and K4 launched 2 (flat)
    or 4 (pods) times a round and K3 and K2 once a worker body."""
    dev = _cuda()
    cfg = _chip_smoke().PHASE8_SMALL
    plan = cfg["hier_plan"] if hier else cfg["flat_plan"]
    pod = cfg["pod_size"] if hier else None
    gpu, gcarry, dispatched, launches = _dag_replay(dev, plan, pod)
    cpu, ccarry, _, _ = _dag_replay(torch.device("cpu"), plan, pod)
    assert gcarry.cpu().tolist() == ccarry.tolist()
    assert int(ccarry.sum()) == cfg["n_nodes"]
    for a, b in zip(gpu.queues, cpu.queues):
        assert torch.equal(a.cpu(), b)
    assert gpu.telemetry.summary() == cpu.telemetry.summary()
    assert gpu.controller.history == cpu.controller.history
    per = 4 if hier else 2
    # steal_gather, push_scatter, pop_slice, transfer_splice
    assert launches == [per * dispatched, dispatched, dispatched,
                        per * dispatched]


@pytest.mark.cuda
def test_sequential_solver_on_the_card_matches_the_cpu():
    from repro_torch.core.dd.bnb import solve

    _cuda()
    inst = random_instance(20, seed=2)
    explore_fused.launches = 0
    got = solve(inst)
    assert explore_fused.launches == got[1]["supersteps"]
    assert got == solve(inst, device="cpu")


@pytest.mark.cuda
def test_two_gloo_ranks_hold_a_backlog_on_the_card():
    """One lane per rank on the card (two gloo ranks, collectives staged
    through the host) equals the stacked runtime on the card, and each
    rank launches the ring kernels on its own lane."""
    _cuda()
    import _torch_mesh as M
    from repro_torch.launch.mesh import run_workers

    want = M.card_backlog(0, execution="vmap")
    for rank, got in enumerate(run_workers(M.card_backlog, 2, timeout=300)):
        for exchange in ("compact", "dense"):
            g, w = got[exchange], want[exchange]
            for key in ("buf", "lo", "size"):
                np.testing.assert_array_equal(g[key], w[key],
                                              err_msg=f"{rank} {key}")
            assert g["telemetry"] == w["telemetry"]
            assert g["history"] == w["history"]
            assert min(g["launches"][:2 if exchange == "compact" else 1]) > 0
        assert got["compact"]["telemetry"][0][3] > 0  # items moved


@pytest.mark.cuda
@pytest.mark.parametrize("steal", ["queue", "migrate"])
def test_decode_cluster_on_the_card_matches_the_cpu(steal):
    """The decode engine on stacked lanes on the card (K3 in its body, K1
    and K4 in every round's superstep, K2 at admission) schedules exactly
    as on the CPU: the same rounds, steals, migrations, stalls and request
    stamps (none of which reads a model output), and in float32 it serves
    every request the CPU's tokens (the per-row decode, the paged gather,
    the write-back and, under migrate, the moved pages, on the card)."""
    from repro_torch.serve.decode import DecodeCluster, DecodePolicy
    from repro_torch.serve.scheduler import Request

    dev = _cuda()
    import _torch_mesh as M

    cfg = dataclasses.replace(configs.reduced(configs.get("llama3.2-1b")),
                              compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    pol = DecodePolicy(n_slots=4, max_prompt=8, max_new=8, page_size=4,
                       steal=steal)

    def run(device, p):
        c = DecodeCluster(model, p, policy=pol, n_lanes=4, capacity=64,
                          straggler_threshold=float("inf"), device=device)
        reqs = [Request(prompt=q, max_new=m, rid=i)
                for i, (q, m) in enumerate(M.decode_mix(28))]
        for fn in COUNTERS:
            fn.launches = 0
        for i in range(0, 28, 7):
            c.submit(reqs[i:i + 7])
            c.step()
        c.run_until_drained(max_steps=500)
        assert all(len(r.output) == r.max_new for r in reqs)
        return (dict(rounds=c.rounds, stolen=c.stolen, migrated=c.migrated,
                     stalls=c.stats()["stalls"],
                     stamps=[(r.rid, r.admit, r.first, r.finish)
                             for r in c.telemetry.requests],
                     outputs=[r.output for r in reqs]),
                [fn.launches for fn in COUNTERS])

    want, _ = run("cpu", params)
    got, (k1, k2, k3, k4) = run(dev, tree_map(lambda t: t.to(dev), params))
    assert got == want
    assert k3 == k1 == k4 == got["rounds"] and k2 > 0
    assert (got["migrated"] > 0) == (steal == "migrate")


# --------------------------------------------- training: K6 and K7's gradient


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_gradient_on_the_card_is_the_plain_one(dtype, hd):
    """``mha`` on CUDA tensors (the SIMT kernel in float32, the tensor-core
    kernel in bf16) has a ``grad_fn``, launches once, and its q, k, v
    gradients are those of plain autograd through ``attention_ref`` (GQA 8
    query heads on 2 KV heads, window 40, softcap 30): its backward
    recomputes that function, so they agree to the dtype's K6 tolerance."""
    dev = _cuda()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(hd)
    shapes = ((2, 96, 8, hd), (2, 96, 2, hd), (2, 96, 2, hd))
    inputs = [torch.tensor(rng.standard_normal(s), dtype=dt, device=dev)
              for s in shapes]
    dout = torch.tensor(rng.standard_normal(shapes[0]), dtype=dt, device=dev)
    opts = dict(causal=True, window=40, softcap=30.0)
    grads, outs = [], []
    for fn in (mha, attention_ref):
        leaves = [t.clone().requires_grad_(True) for t in inputs]
        before = mha.launches
        out = fn(*leaves, **opts)
        assert mha.launches - before == (fn is mha)
        assert out.grad_fn is not None
        out.backward(dout)
        outs.append(out.detach())
        grads.append([t.grad for t in leaves])
    tol = C.FLASH_TOL[dtype]
    torch.testing.assert_close(outs[0], outs[1], atol=tol, rtol=tol)
    for g, w in zip(*grads):
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
        torch.testing.assert_close(g, w, atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_gradient_on_the_card_is_the_plain_one(dtype):
    """``ssd`` on CUDA tensors (bf16 at head dim 64, state 64, chunk 64: the
    tensor-core kernel; float32: the SIMT kernel) has a ``grad_fn`` and
    gives plain autograd's gradients through ``ssd_chunked`` for x, dt,
    A, Bm, Cm and D, from y and from y and the final state, to K7's
    tolerance of the dtype."""
    dev = _cuda()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(7)
    B, S, nh, hd, ns, chunk = 2, 200, 4, 64, 64, 64
    arrs = [(rng.standard_normal((B, S, nh, hd)), dt),
            (np.log1p(np.exp(rng.standard_normal((B, S, nh)) - 2.0)),
             torch.float32),
            (-np.exp(rng.standard_normal(nh) * 0.3), torch.float32),
            (rng.standard_normal((B, S, ns)) * 0.3, dt),
            (rng.standard_normal((B, S, ns)) * 0.3, dt),
            (rng.standard_normal(nh), torch.float32)]
    inputs = [torch.tensor(a, dtype=t, device=dev) for a, t in arrs]
    dy = torch.tensor(rng.standard_normal((B, S, nh, hd)), dtype=dt,
                      device=dev)
    atol, rtol = C.SSD_TOL[dtype]
    for use_final in (False, True):
        grads = []
        for fn in (lambda *t: ssd(*t, chunk=chunk),
                   lambda *t: ssd_chunked(*t, chunk)):
            leaves = [t.clone().requires_grad_(True) for t in inputs]
            y, final = fn(*leaves)
            assert y.grad_fn is not None
            loss = (y.float() * dy.float()).sum()
            if use_final:
                loss = loss + final.sum()
            loss.backward()
            grads.append([t.grad for t in leaves])
        for g, w in zip(*grads):
            assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
            torch.testing.assert_close(g.float(), w.float(), atol=atol,
                                       rtol=rtol)


@pytest.mark.cuda
def test_moe_routing_plan_on_the_card_equals_the_cpu():
    """The bulk-steal plan (expert, slot, valid) on CUDA tensors is the
    CPU's bit for bit: skewed probabilities that overflow, exactly tied
    rows, with and without the steal, at qwen3-moe's 128 experts top 8."""
    from repro_torch.models import moe

    dev = _cuda()
    rng = np.random.default_rng(3)
    for T, E, k in ((257, 8, 2), (1024, 128, 8), (64, 4, 1)):
        logits = rng.standard_normal((T, E)) * 2.0
        logits[:, : max(E // 4, 1)] += 3.0
        skewed = torch.softmax(torch.tensor(logits, dtype=torch.float32), -1)
        ints = torch.tensor(rng.integers(1, 4, (T, E)), dtype=torch.float32)
        tied = ints / ints.sum(-1, keepdim=True)
        for probs in (skewed, tied):
            for cf in (1.0, 1.25):
                cap = moe.capacity_of(T, k, E, cf)
                for steal in (False, True):
                    cpu = moe.route_with_bulk_steal(probs, k, cap, steal)
                    got = moe.route_with_bulk_steal(probs.to(dev), k, cap,
                                                    steal)
                    for i in (0, 1, 3):
                        assert torch.equal(got[i].cpu(), cpu[i]), (T, E, k)
                    torch.testing.assert_close(got[2].cpu(), cpu[2],
                                               atol=1e-6, rtol=1e-6)


@pytest.mark.cuda
def test_train_steps_on_the_card_match_the_cpu():
    """Reduced llama3.2-1b in float32: the same parameters and batches give
    the same losses, gradient norms and parameters after two
    ``make_train_step`` steps on the card (K6 forward, the plain backward,
    remat: 8 launches a step) as on the CPU (AdamW's eps 1e-6, as in
    tests/test_torch_train.py, so that a gradient element near 1e-8 does
    not turn rounding into a different fraction of a step)."""
    from repro_torch.data.synthetic import synth_batch
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.trainer import make_train_step

    dev = _cuda()
    cfg = dataclasses.replace(configs.reduced(configs.get("llama3.2-1b")),
                              compute_dtype="float32")
    model = build_model(cfg)
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=2,
                                              total_steps=10, eps=1e-6))
    params = model.init(torch.Generator().manual_seed(0))
    runs = {}
    for where in ("cpu", dev):
        p = tree_map(lambda t: t.to(where), params)
        opt = adamw_init(p)
        metrics = []
        for i in range(2):
            raw = synth_batch(0, 0, i, 4, 32, cfg.vocab_size)
            batch = {k: torch.from_numpy(v).to(where) for k, v in raw.items()}
            before = mha.launches
            p, opt, met = step(p, opt, batch)
            if where is dev:
                assert mha.launches - before == 2 * cfg.n_layers
            metrics.append({k: float(v) for k, v in met.items()})
        runs[str(where)] = (p, metrics)
    (p_cpu, m_cpu), (p_dev, m_dev) = runs["cpu"], runs[str(dev)]
    for a, b in zip(m_dev, m_cpu):
        for k in ("loss", "grad_norm", "lr"):
            assert abs(a[k] - b[k]) <= 1e-5 * (1 + abs(b[k])), (k, a, b)
    for a, b in zip(tree_leaves(p_dev), tree_leaves(p_cpu)):
        torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=0)
