"""Helpers shared by the resilience parity tests: the Fig. 9 DAG worker
body in both packages (one lane's view for the JAX package, the stacked
lanes for the port) and the drive loops that run it to the drain."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax import lax

from repro.core.policy import StealPolicy as JaxPolicy
from repro.runtime import FaultPlan as JaxFaultPlan
from repro.runtime import StealRuntime as JaxRuntime
from repro_torch._tree import tree_map
from repro_torch.core.ops import to_numpy
from repro_torch.core.policy import StealPolicy
from repro_torch.runtime import FaultPlan, StealRuntime

# The parity size: 8 lanes of 256 rows, max_steal 64, a DAG of 600 nodes
# (fan-out 4, pops of 16), pods of 4.
W, CAP, MAX_STEAL, N_NODES, BATCH, FANOUT, POD = 8, 256, 64, 600, 16, 4, 4
POLICY = dict(proportion=0.5, low_watermark=4, high_watermark=32,
              max_steal=MAX_STEAL)
SPEC = torch.zeros((), dtype=torch.int32)
JSPEC = jax.ShapeDtypeStruct((), jnp.int32)

# lane 3 dies mid-drain, lane 5 straggles, one exchange is dropped
FLAT_PLAN = dict(kills=((3, 6),), delays=((5, 4, 4),), drops=(8,))
# lane 3 dies (intra-pod recovery), then all of pod 1 (cross-pod)
DEAD_POD_PLAN = dict(kills=((3, 6), (4, 10), (5, 10), (6, 10), (7, 10)),
                     delays=((1, 3, 2),), drops=(9,))


def jax_dag_body(ops, n_nodes=N_NODES, batch=BATCH, fanout=FANOUT):
    """The JAX package's Fig. 9 body (``tests/test_resilience.py``)."""
    def body(q, carry):
        q, nodes, n_popped = ops.pop_bulk(q, batch, jnp.int32(batch))
        valid = jnp.arange(batch, dtype=jnp.int32) < n_popped
        kids = (nodes[:, None] * fanout + 1
                + jnp.arange(fanout, dtype=jnp.int32)[None, :])
        live = valid[:, None] & (kids < n_nodes)
        flat, flive = kids.reshape(-1), live.reshape(-1)
        order = jnp.argsort(~flive, stable=True)
        flat = jnp.where(flive[order], flat[order], 0)
        q, _ = ops.push(q, flat, jnp.sum(flive.astype(jnp.int32)))
        peak = lax.pmax(carry, "workers")
        return q, carry + jnp.sum(valid.astype(jnp.int32)) + 0 * peak
    return body


def torch_dag_body(ops, n_nodes=N_NODES, batch=BATCH, fanout=FANOUT):
    """The same body on the stacked lanes (``pmax`` is a max over lanes)."""
    def body(q, carry):
        q, nodes, n_popped = ops.pop_bulk(q, batch, batch, donate=True)
        w = q.size.shape[0]
        rows = torch.arange(batch, dtype=torch.int32, device=q.size.device)
        valid = rows[None, :] < n_popped[:, None]
        kids = (nodes[:, :, None] * fanout + 1
                + torch.arange(fanout, dtype=torch.int32,
                               device=q.size.device))
        live = valid[:, :, None] & (kids < n_nodes)
        flat, flive = kids.reshape(w, -1), live.reshape(w, -1)
        order = torch.argsort((~flive).to(torch.int32), dim=1, stable=True)
        flat = torch.where(flive.gather(1, order), flat.gather(1, order), 0)
        q, _ = ops.push(q, flat, flive.sum(1).to(torch.int32), donate=True)
        peak = carry.amax()
        return q, carry + valid.sum(1).to(torch.int32) + 0 * peak
    return body


def jax_runtime(plan=None, pod_size=None, policy=None, **kw):
    """The JAX package's runtime at the parity size (``policy``: fields
    that replace ``POLICY``'s)."""
    return JaxRuntime(W, CAP, JSPEC,
                      policy=JaxPolicy(**{**POLICY, **(policy or {})}),
                      max_pop=BATCH, pod_size=pod_size,
                      fault_plan=(None if plan is None
                                  else JaxFaultPlan(**plan)), **kw)


def port_runtime(plan=None, pod_size=None, backend="cuda", policy=None,
                 **kw):
    """The port's runtime at the parity size, on the CPU."""
    return StealRuntime(W, CAP, SPEC,
                        policy=StealPolicy(backend=backend,
                                           **{**POLICY, **(policy or {})}),
                        pod_size=pod_size,
                        fault_plan=None if plan is None else FaultPlan(**plan),
                        device="cpu", **kw)


def drain(rt, body, carry, k=16, limit=500):
    """``run_fused(k, until_drained=True)`` blocks until every lane is
    empty; returns ``(carry, rounds)``."""
    rounds = 0
    while rt.total_size() > 0 and rounds < limit:
        carry, _, r = rt.run_fused(k, body, carry, until_drained=True)
        rounds += r
    return carry, rounds


def run_jax_dag(plan=None, pod_size=None):
    rt = jax_runtime(plan, pod_size)
    rt.push(0, jnp.zeros((1,), jnp.int32), 1)
    carry, rounds = drain(rt, jax_dag_body(rt.ops), jnp.zeros((W,),
                                                              jnp.int32))
    return rt, np.asarray(carry), rounds


def run_port_dag(plan=None, pod_size=None, backend="cuda"):
    rt = port_runtime(plan, pod_size, backend)
    rt.push(0, torch.zeros((1,), dtype=torch.int32), 1)
    carry, rounds = drain(rt, torch_dag_body(rt.ops),
                          torch.zeros((W,), dtype=torch.int32))
    return rt, carry.numpy(), rounds


def queues_np(rt):
    """(buf, lo, size) of either package's runtime as numpy."""
    q = rt.queues
    if isinstance(q.size, torch.Tensor):
        q = tree_map(to_numpy, q)
    else:
        q = jax.tree_util.tree_map(np.asarray, q)
    return q.buf, q.lo, q.size


def items_of(rt):
    """The sorted multiset of live items across every lane."""
    buf, lo, size = queues_np(rt)
    cap = buf.shape[1]
    out = []
    for i in range(len(lo)):
        out += [int(buf[i][(lo[i] + j) % cap]) for j in range(size[i])]
    return sorted(out)


def assert_same_run(jax_run, port_run, what=""):
    """Carry, rounds, telemetry summary, proportion history, sizes and
    rings, bit for bit."""
    (jrt, jcarry, jrounds), (trt, tcarry, trounds) = jax_run, port_run
    assert int(jcarry.sum()) == int(tcarry.sum()) == N_NODES, what
    assert jcarry.tolist() == tcarry.tolist(), what
    assert jrounds == trounds, what
    assert jrt.telemetry.summary() == trt.telemetry.summary(), what
    assert jrt.controller.history == trt.controller.history, what
    for a, b in zip(queues_np(jrt), queues_np(trt)):
        np.testing.assert_array_equal(a, b, err_msg=what)
    assert (trt.sizes()[trt.dead_lanes()] == 0).all(), what
