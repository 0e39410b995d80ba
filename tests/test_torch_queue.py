"""The port's bulk queue contract (``repro_torch.core.ops``) against the JAX
package's (``repro.core.ops``): random programs of push / pop / pop_bulk /
steal / steal_exact / window / transfer on wrapped rings, op by op, for
one queue and for stacked lanes, across the reference and kernel backends
of both packages — state, batch and count must be equal, dead rows zero.
Also ``donate``, the ``auto`` resolution, its one-shot downgrade warning
and the ``REPRO_QUEUE_BACKEND`` override."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ops as jops
from repro_torch.core import ops as tops

from _torch_parity import assert_same, tree_np, one_torch_thread  # noqa: F401

CAP = 64
W_SRC = 3
OPS = ("push", "pop", "pop_bulk", "steal", "steal_exact", "window",
       "transfer")
PROPORTIONS = (0.1, 0.25, 0.3, 0.5, 0.6, 0.7)


def _np_state(rng, lanes):
    shape = (lanes,) if lanes else ()
    buf = {"id": rng.integers(0, 10 ** 6, shape + (CAP,)).astype(np.int32),
           "vec": rng.standard_normal(shape + (CAP, 2)).astype(np.float32)}
    lo = rng.integers(0, CAP, shape).astype(np.int32)
    size = rng.integers(0, CAP + 1, shape).astype(np.int32)
    return tops.QueueState(buf, lo, size)


def _rows(rng, lead, rows):
    return {"id": rng.integers(0, 10 ** 6, lead + (rows,)).astype(np.int32),
            "vec": rng.standard_normal(lead + (rows, 2)).astype(np.float32)}


def _jax_lane(q, l):
    pick = (lambda x: x[l]) if l is not None else (lambda x: x)
    return jops.QueueState(
        buf={k: jnp.asarray(pick(v)) for k, v in q.buf.items()},
        lo=jnp.int32(pick(q.lo)), size=jnp.int32(pick(q.size)))


def _draw(rng, lanes):
    """One random op and its arguments (per lane where they vary)."""
    op = OPS[rng.integers(len(OPS))]
    per = (lanes,) if lanes else ()
    if op == "push":
        b = int(rng.choice([4, 8, 16]))
        return op, dict(batch=_rows(rng, per, b),
                        n=rng.integers(0, b + 3, per).astype(np.int32))
    if op == "pop_bulk":
        m = int(rng.choice([4, 8]))
        return op, dict(max_n=m,
                        n=rng.integers(0, m + 3, per).astype(np.int32))
    if op == "steal":
        return op, dict(proportion=float(rng.choice(PROPORTIONS)),
                        max_steal=int(rng.choice([8, 16])))
    if op == "steal_exact":
        return op, dict(n=rng.integers(0, 21, per).astype(np.int32),
                        max_steal=16)
    if op == "window":
        return op, dict(max_steal=16)
    if op == "transfer":
        return op, dict(gathered=_rows(rng, (W_SRC,), 16),
                        src_row=rng.integers(0, W_SRC, per).astype(np.int32),
                        n=rng.integers(0, 21, per).astype(np.int32),
                        max_steal=16)
    return op, {}


def _call(ops, q, op, args, to):
    """Apply ``op`` through backend ``ops``; ``to`` converts a numpy leaf
    into the backend's array type.  Returns the op's result tuple with the
    state first (``window`` returns ``(state, batch)``)."""
    conv = lambda tree: jax.tree_util.tree_map(to, tree)  # noqa: E731
    if op == "push":
        return ops.push(q, conv(args["batch"]), to(args["n"]))
    if op == "pop":
        return ops.pop(q)
    if op == "pop_bulk":
        return ops.pop_bulk(q, args["max_n"], to(args["n"]))
    if op == "steal":
        return ops.steal(q, args["proportion"], max_steal=args["max_steal"])
    if op == "steal_exact":
        return ops.steal_exact(q, to(args["n"]),
                               max_steal=args["max_steal"])
    if op == "window":
        return q, ops.window(q, max_steal=args["max_steal"])
    return ops.transfer(q, conv(args["gathered"]), to(args["src_row"]),
                        to(args["n"]), max_steal=args["max_steal"])


def _lane_args(args, l):
    out = {}
    for k, v in args.items():
        if k == "gathered" or l is None or not isinstance(v, (dict,
                                                               np.ndarray)):
            out[k] = v
        else:
            out[k] = jax.tree_util.tree_map(lambda x: x[l], v)
    return out


@pytest.mark.parametrize("lanes", [0, 3])
@pytest.mark.parametrize("port_backend", ["reference", "cuda"])
@pytest.mark.parametrize("jax_backend", ["reference", "pallas"])
@pytest.mark.parametrize("seed", [0, 1])
def test_random_programs_match_reference(seed, jax_backend, port_backend,
                                         lanes):
    rng = np.random.default_rng(100 * seed + lanes)
    jo, to = jops.make_ops(jax_backend), tops.make_ops(port_backend)
    q0 = _np_state(rng, lanes)
    lane_ids = list(range(lanes)) if lanes else [None]
    jq = [_jax_lane(q0, l) for l in lane_ids]
    tq = tops.queue_from_numpy(q0, device="cpu")
    for step in range(24):
        op, args = _draw(rng, lanes)
        t_out = _call(to, tq, op, args, torch.as_tensor)
        for i, l in enumerate(lane_ids):
            j_out = _call(jo, jq[i], op, _lane_args(args, l), jnp.asarray)
            pick = (lambda x: x[l]) if l is not None else (lambda x: x)
            what = f"step {step} {op} lane {l}"
            for a, b in zip(jax.tree_util.tree_leaves(tree_np(j_out)),
                            jax.tree_util.tree_leaves(
                                jax.tree_util.tree_map(
                                    lambda x: tops.to_numpy(pick(x)),
                                    t_out, is_leaf=torch.is_tensor))):
                assert_same(a, b, what)
            jq[i] = j_out[0]
        if op in ("pop_bulk", "steal", "steal_exact"):
            _, batch, n = t_out
            n = n.reshape(-1)
            for leaf in batch.values():
                view = leaf if lanes else leaf[None]  # (lanes, rows, ...)
                dead = torch.arange(view.shape[1])[None, :] >= n[:, None]
                assert not view[dead].any(), f"{op}: dead rows not zeroed"
        tq = t_out[0]


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_donate_false_leaves_inputs_and_donate_true_writes_in_place(backend):
    rng = np.random.default_rng(7)
    ops = tops.make_ops(backend)
    q = tops.queue_from_numpy(_np_state(rng, 3), device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in _rows(rng, (3,), 8).items()}
    gathered = {k: torch.as_tensor(v)
                for k, v in _rows(rng, (W_SRC,), 16).items()}
    n = torch.full((3,), 6, dtype=torch.int32)
    before = {k: v.clone() for k, v in q.buf.items()}
    calls = [
        lambda q, d: ops.push(q, batch, n, donate=d),
        lambda q, d: ops.transfer(q, gathered, torch.tensor([2, 0, 1],
                                                            dtype=torch.int32),
                                  n, max_steal=16, donate=d),
    ]
    q = q._replace(size=torch.tensor([0, 10, 20], dtype=torch.int32))
    for call in calls:
        pure, _ = call(q, False)
        for k in q.buf:
            assert torch.equal(q.buf[k], before[k]), "donate=False wrote"
            assert pure.buf[k].data_ptr() != q.buf[k].data_ptr()
        inplace, _ = call(q, True)
        for k in q.buf:
            assert inplace.buf[k] is q.buf[k]
            assert torch.equal(q.buf[k], pure.buf[k])
            before[k] = q.buf[k].clone()
        assert torch.equal(inplace.size, pure.size)


def test_steal_counted_equals_steal_and_reference():
    rng = np.random.default_rng(8)
    q0 = _np_state(rng, 0)
    jq, tq = _jax_lane(q0, None), tops.queue_from_numpy(q0, device="cpu")
    for p in PROPORTIONS:
        want = jops.steal_counted(jq, p, max_steal=16)
        got = tops.steal_counted(tq, p, max_steal=16)
        plain = tops.make_ops("reference").steal(tq, p, max_steal=16)
        for a, b, c in zip(jax.tree_util.tree_leaves(tree_np(want)),
                           jax.tree_util.tree_leaves(got),
                           jax.tree_util.tree_leaves(plain)):
            assert_same(a, b)
            assert torch.equal(b, c)


def test_float32_proportion_tensor_matches_traced_reference():
    """A float32 proportion tensor steals what JAX steals with a traced
    float32 proportion (``1 - p`` in float32 arithmetic)."""
    rng = np.random.default_rng(9)
    q0 = _np_state(rng, 0)
    steal = jax.jit(lambda q, p: jops.make_ops("reference").steal(
        q, p, max_steal=CAP))
    for p in (0.1, 0.3, 0.35, 0.7):
        for size in range(0, CAP + 1, 3):
            q = q0._replace(size=np.int32(size))
            j = steal(_jax_lane(q, None), jnp.float32(p))
            t = tops.make_ops("cuda").steal(
                tops.queue_from_numpy(q, device="cpu"),
                torch.tensor(p, dtype=torch.float32), max_steal=CAP)
            assert int(j[2]) == int(t[2]), (p, size)


def test_item_nbytes_and_numpy_round_trip():
    jspec = {"a": jax.ShapeDtypeStruct((), jnp.int32),
             "b": jax.ShapeDtypeStruct((3,), jnp.bfloat16),
             "c": jax.ShapeDtypeStruct((2, 2), jnp.float32)}
    tspec = {"a": torch.zeros((), dtype=torch.int32),
             "b": torch.zeros((3,), dtype=torch.bfloat16),
             "c": torch.zeros((2, 2), dtype=torch.float32)}
    assert tops.item_nbytes(tspec) == jops.item_nbytes(jspec) == 26
    jq = jops.make_queue(8, jspec)
    jq = jops.make_ops("reference").push(
        jq, {"a": jnp.arange(4, dtype=jnp.int32),
             "b": jnp.full((4, 3), 1.5, jnp.bfloat16),
             "c": jnp.ones((4, 2, 2), jnp.float32)}, 4)[0]
    tq = tops.queue_from_numpy(tree_np(jq), device="cpu")
    assert tq.buf["b"].dtype == torch.bfloat16
    back = tops.queue_to_numpy(tq)
    for a, b in zip(jax.tree_util.tree_leaves(tree_np(jq)),
                    jax.tree_util.tree_leaves(back)):
        assert_same(a, b)


def test_auto_resolution_warning_and_env_override(monkeypatch):
    monkeypatch.delenv(tops.BACKEND_ENV_VAR, raising=False)
    tops.reset_fallback_warnings()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        # "auto" is the kernel routing, silently, for any geometry
        assert tops.make_ops("auto").resolved == "cuda"
        assert tops.make_ops(None) == tops.make_ops("cuda")
        assert tops.make_ops("reference").resolved == "reference"
    # the environment redirects "auto" wholesale, once with a warning,
    # never an explicit name
    monkeypatch.setenv(tops.BACKEND_ENV_VAR, "reference")
    with pytest.warns(tops.BackendFallbackWarning, match="override"):
        assert tops.make_ops("auto").resolved == "reference"
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # one-shot: no second warning
        assert tops.make_ops("auto").resolved == "reference"
    assert tops.make_ops("cuda").resolved == "cuda"
    with pytest.raises(ValueError, match="unknown queue backend"):
        tops.make_ops("pallas")
    tops.reset_fallback_warnings()
