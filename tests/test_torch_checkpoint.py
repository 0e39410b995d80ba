"""Snapshots and supervised restarts: the port's ``train.checkpoint``
(round trips, keep-k, the JAX package's keys), snapshots crossing between
the packages in both directions and from a flat runtime into a
hierarchical one, ``GracefulExit``, ``run_supervised`` and
``run_resilient`` with a simulated crash on the CPU."""

import os
import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch._tree import tree_leaves_with_path, tree_map
from repro_torch.core.ops import QueueState
from repro_torch.launch import resilient
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault import GracefulExit, run_supervised

from _torch_fault import (FLAT_PLAN, POD, W, drain, items_of,
                          jax_dag_body, jax_runtime, port_runtime, queues_np,
                          run_port_dag, torch_dag_body)
from _torch_parity import one_torch_thread  # noqa: F401


def _tree():
    q = QueueState({"id": torch.arange(12, dtype=torch.int32).reshape(2, 6),
                    "w": torch.rand(2, 6, 3)},
                   torch.tensor([1, 2], dtype=torch.int32),
                   torch.tensor([3, 0], dtype=torch.int32))
    return {"queues": q, "proportion": torch.tensor(0.25),
            "rounds_run": torch.tensor(7, dtype=torch.int32),
            "seq": [torch.ones(2), (torch.zeros(1, dtype=torch.int64),)]}


def test_save_restore_round_trip_and_keys(tmp_path):
    tree = _tree()
    path = ckpt.save(str(tmp_path), 7, tree, extra={"a": 1})
    assert os.path.basename(path) == "step_0000000007"
    with np.load(os.path.join(path, "arrays.npz")) as z:
        assert sorted(z.files) == [
            "proportion", "queues/buf/id", "queues/buf/w", "queues/lo",
            "queues/size", "rounds_run", "seq/0", "seq/1/0"]
    template = tree_map(torch.zeros_like, tree)
    got, step, extra = ckpt.restore(str(tmp_path), template)
    assert (step, extra) == (7, {"a": 1})
    for (k, a), (_, b) in zip(tree_leaves_with_path(tree),
                              tree_leaves_with_path(got)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    bad = dict(template, rounds_run=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="rounds_run"):
        ckpt.restore(str(tmp_path), bad)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), template)


def test_keep_k_and_checkpointer(tmp_path):
    tree = {"x": torch.arange(3)}
    for s in range(1, 6):
        ckpt.save(str(tmp_path), s, tree, keep=2)
    assert ckpt.latest_steps(str(tmp_path)) == [4, 5]
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    c = ckpt.Checkpointer(str(tmp_path / "c"), every=3, keep=1)
    saved = [s for s in range(1, 10) if c.maybe_save(s, tree)]
    assert saved == [3, 6, 9]
    assert ckpt.latest_steps(str(tmp_path / "c")) == [9]
    assert not any(n.startswith(".tmp") for n in os.listdir(tmp_path))


def _jax_part(snap_dir, rounds=8):
    """The JAX package's flat fault replay, snapshotted after ``rounds``;
    returns its carry there."""
    rt = jax_runtime(FLAT_PLAN)
    rt.push(0, jnp.zeros((1,), jnp.int32), 1)
    carry, _ = rt.run_fused(rounds, jax_dag_body(rt.ops),
                            jnp.zeros((W,), jnp.int32))
    rt.save_state(str(snap_dir))
    return np.asarray(carry)


def _port_part(snap_dir, rounds=8):
    rt = port_runtime(FLAT_PLAN)
    rt.push(0, torch.zeros((1,), dtype=torch.int32), 1)
    carry, _ = rt.run_fused(rounds, torch_dag_body(rt.ops),
                            torch.zeros((W,), dtype=torch.int32))
    rt.save_state(str(snap_dir))
    return carry.numpy()


def _finish_jax(snap_dir, carry):
    rt = jax_runtime(FLAT_PLAN)
    assert rt.restore_state(str(snap_dir)) == 8
    carry, _ = drain(rt, jax_dag_body(rt.ops), jnp.asarray(carry))
    return rt, np.asarray(carry)


def _finish_port(snap_dir, carry):
    rt = port_runtime(FLAT_PLAN)
    assert rt.restore_state(str(snap_dir)) == 8
    carry, _ = drain(rt, torch_dag_body(rt.ops), torch.tensor(carry))
    return rt, carry.numpy()


def _same_finish(a, b):
    (art, acarry), (brt, bcarry) = a, b
    assert acarry.tolist() == bcarry.tolist()
    assert acarry.sum() == 600
    assert art.rounds_run == brt.rounds_run
    assert art.telemetry.summary() == brt.telemetry.summary()
    assert art.controller.history == brt.controller.history
    for x, y in zip(queues_np(art), queues_np(brt)):
        np.testing.assert_array_equal(x, y)


def test_snapshots_cross_between_the_packages(tmp_path):
    """A snapshot the JAX package wrote restores into the port, and the
    port's into the JAX package; each drains to the same final state as
    the other package restoring the same snapshot, which is the state of
    the uninterrupted run."""
    jcarry = _jax_part(tmp_path / "jax")
    tcarry = _port_part(tmp_path / "port")
    assert jcarry.tolist() == tcarry.tolist()
    for d in ("jax", "port"):
        with np.load(os.path.join(tmp_path / d, "step_0000000008",
                                  "arrays.npz")) as z:
            assert sorted(z.files) == [
                "fault/delay_from", "fault/delay_until", "fault/drop_rounds",
                "fault/kill_round", "proportion", "queues/buf", "queues/lo",
                "queues/size", "rounds_run"]
    for d in ("jax", "port"):
        _same_finish(_finish_jax(tmp_path / d, jcarry),
                     _finish_port(tmp_path / d, jcarry))
    whole = run_port_dag(FLAT_PLAN)
    port = _finish_port(tmp_path / "jax", jcarry)
    for x, y in zip(queues_np(whole[0]), queues_np(port[0])):
        np.testing.assert_array_equal(x, y)
    assert whole[1].tolist() == port[1].tolist()


def test_flat_snapshot_restores_into_a_hierarchical_runtime(tmp_path):
    """An 8-lane flat snapshot taken mid-plan (kills still pending)
    restores bit for bit into a 2 x 4 hierarchical runtime, which runs
    the pending kills and finishes the drain with the exact multiset."""
    pol = dict(low_watermark=4, high_watermark=16)
    plan = dict(kills=((3, 6), (5, 7)), delays=((1, 2, 3),))
    flat = port_runtime(plan, policy=pol, backend="reference")
    rng = np.random.default_rng(13)
    for w in range(W):
        n = int(rng.integers(10, 40))
        flat.push(w, torch.arange(w * 100, w * 100 + n, dtype=torch.int32),
                  n)
    before = items_of(flat)
    for _ in range(4):
        flat.round()
    flat.save_state(str(tmp_path))
    runs = []
    for hier in (port_runtime({}, pod_size=POD, policy=pol),
                 jax_runtime({}, pod_size=POD, policy=pol)):
        assert hier.restore_state(str(tmp_path)) == 4
        for x, y in zip(queues_np(flat), queues_np(hier)):
            np.testing.assert_array_equal(x, y)
        assert np.asarray(hier.fault.kill_round).tolist() == \
            flat.fault.kill_round.tolist()
        for _ in range(10):
            hier.round()
        assert hier.dead_lanes()[3] and hier.dead_lanes()[5]
        assert hier.sizes()[3] == 0 and hier.sizes()[5] == 0
        assert items_of(hier) == before
        runs.append([np.asarray(x).tolist() for x in queues_np(hier)]
                    + [hier.telemetry.summary()])
    assert runs[0] == runs[1]


def test_graceful_exit_catches_sigterm_and_restores_the_handler():
    prev = signal.getsignal(signal.SIGTERM)
    with GracefulExit() as stop:
        assert not stop.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert stop.requested
    assert signal.getsignal(signal.SIGTERM) is prev


def test_run_supervised_restarts_from_the_latest_checkpoint():
    seen, restarts = [], []

    def run(resume):
        seen.append(resume)
        if len(seen) < 3:
            raise RuntimeError(f"crash {len(seen)}")
        return 42

    assert run_supervised(run, max_restarts=3,
                          on_restart=lambda a, e: restarts.append(a)) == 42
    assert seen == [None, -1, -1] and restarts == [0, 1]
    with pytest.raises(RuntimeError, match="crash 2"):
        run_supervised(lambda r: (_ for _ in ()).throw(
            RuntimeError(f"crash {2 if r else 1}")), max_restarts=1)
    calls = []

    def stop(resume):
        calls.append(resume)
        raise SystemExit(3)

    with pytest.raises(SystemExit):
        run_supervised(stop, max_restarts=3)
    assert calls == [None]


def _resilient_drive(snap_dir, crash_at=None, every=4, k=2,
                     metrics_path=None):
    """Drive the flat fault replay under ``run_resilient`` in blocks of
    ``k`` rounds, crashing once at ``crash_at`` (``metrics_path``: keep
    the Prometheus textfile there)."""
    crashed = []

    def make_runtime():
        rt = port_runtime(FLAT_PLAN)
        if ckpt.latest_step(snap_dir) is None:
            rt.push(0, torch.zeros((1,), dtype=torch.int32), 1)
        return rt

    final = {}

    def drive(rt, should_stop):
        body = torch_dag_body(rt.ops)
        carry = torch.zeros((W,), dtype=torch.int32)
        while rt.total_size() > 0 and not should_stop():
            if crash_at is not None and not crashed and \
                    rt.rounds_run >= crash_at:
                crashed.append(rt.rounds_run)
                raise RuntimeError("simulated crash")
            carry, _, _ = rt.run_fused(k, body, carry, until_drained=True)
        final["rt"] = rt
        return rt.rounds_run

    rounds = resilient.run_resilient(make_runtime, drive,
                                     snapshot_dir=str(snap_dir),
                                     snapshot_every=every,
                                     metrics_path=metrics_path)
    return rounds, final["rt"], crashed


def test_run_resilient_resumes_a_crash_to_the_uninterrupted_state(tmp_path):
    prom = tmp_path / "metrics" / "repro.prom"
    rounds, rt, crashed = _resilient_drive(tmp_path / "crash", crash_at=6,
                                           metrics_path=str(prom))
    assert crashed == [6]
    assert rt.telemetry.fault_events["restart"] == 1
    assert rt.telemetry.fault_events["restore"] == 1
    whole = run_port_dag(FLAT_PLAN)[0]
    assert rounds == rt.rounds_run == whole.rounds_run
    for x, y in zip(queues_np(whole), queues_np(rt)):
        np.testing.assert_array_equal(x, y)
    # the last snapshot is the final state
    assert ckpt.latest_step(str(tmp_path / "crash")) == rounds
    # the textfile's last write is the resumed runtime's final poll
    text = prom.read_text()
    assert text == rt.metrics().to_prometheus()
    assert 'repro_fault_events_total{kind="restart"} 1' in text
    assert f"repro_dead_lanes {int(rt.dead_lanes().sum())}" in text
    assert list(prom.parent.iterdir()) == [prom]


def test_resilient_cli_on_the_cpu(tmp_path, capsys):
    assert resilient.main(["--device", "cpu", "--simulate-crash-at", "6",
                           "--snapshot-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "rounds_run=64 remaining=0" in out
    assert "'restart': 1" in out
