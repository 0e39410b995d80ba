"""One queue lane per process (``repro_torch.distributed``) on 8 ``gloo``
CPU ranks, against the stacked runtime and the JAX package.

One module-scoped spawn of 8 ranks runs every mesh case of
``tests/_torch_mesh.py`` (with a time limit of its own, so a hang fails
here instead of holding the suite); the tests compare what the ranks
return with the same cases on the stacked runtime in this process, bit
for bit, and with the JAX package's vmapped ``launch_runtime`` on the
same inputs (the JAX package's own test holds its vmapped runtime equal
to its mesh):

* ``MeshStealRuntime`` == ``StealRuntime`` == JAX: queues, the stats a
  round returns, telemetry records and the proportion history, flat and
  in pods of 4, compact and dense, ``reference`` and ``auto``, through
  ``round()``, ``run_fused(2)`` and ``run_fused(3, until_drained=True)``;
  every rank returns the same stacked-layout results;
* the relaxed backend and the sanitizer on the mesh;
* the Fig. 9 DAG drain with a worker-body lane max, a ``FaultPlan`` flat
  and in pods, ``parallel_solve(execution="mesh")``;
* the elastic resizes on a mesh (the padded runtime's live resize, and
  ``shrink`` / ``grow`` through the rebuild, with ranks that hold no
  runtime while the mesh is small), and snapshots across the modes;
* ``launch_runtime``'s and ``make_worker_mesh``'s refusals;
* the serving masters on the mesh: ``DecodeCluster(execution="mesh")``
  (queued steals only, and with in-flight migration) and
  ``RuntimeAdmissionMaster(execution="mesh")`` under a ``ServeCluster``
  serve what the stacked lanes serve, with the same stamps, counters and
  telemetry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_mesh as M
from repro.core.dd.knapsack import dp_solve
from repro.core.dd.knapsack import random_instance as jax_random_instance
from repro.core.dd.parallel import parallel_solve as jax_parallel_solve
from repro.core.policy import StealPolicy as JaxPolicy
from repro.distributed import launch_runtime as jax_launch_runtime
from repro_torch.launch.mesh import run_workers

from _torch_fault import jax_dag_body
from _torch_parity import one_torch_thread  # noqa: F401

JSPEC = jax.ShapeDtypeStruct((), jnp.int32)
CASE_IDS = [f"{'pods' if p else 'flat'}-{b}-{e}" for p, b, e in M.PARITY]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results, and the snapshot directories of the stacked
    runtime and of the mesh."""
    base = tmp_path_factory.mktemp("mesh")
    restore, save = str(base / "stacked"), str(base / "mesh")
    # the stacked runtime's snapshot, which the mesh (in pods) restores
    M.snapshot_case("vmap", save_dir=restore)
    return (run_workers(M.program(restore, save), M.W, timeout=240),
            (restore, save))


def assert_equal(a, b, path=""):
    """Nested results equal, numpy leaves bit for bit with their dtypes."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            assert_equal(a[k], b[k], f"{path}/{k}")
    elif hasattr(a, "_fields"):
        for f in a._fields:
            assert_equal(getattr(a, f), getattr(b, f), f"{path}.{f}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (path, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            assert_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a, b)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


def jax_state(rt) -> dict:
    q = jax.tree_util.tree_map(np.asarray, rt.queues)
    return dict(buf=q.buf, lo=q.lo, size=q.size, rounds_run=rt.rounds_run,
                telemetry=M.records(rt),
                history=list(rt.controller.history))


def jax_parity(pod_size, backend, exchange) -> dict:
    """``_torch_mesh.parity_case`` on the JAX package's vmapped lanes."""
    pol = JaxPolicy(proportion=0.5, low_watermark=2, high_watermark=8,
                    max_steal=32, exchange=exchange)
    rt = jax_launch_runtime(M.W, 128, JSPEC, execution="vmap",
                            pod_size=pod_size, policy=pol, backend=backend)
    nxt = 1
    for i, n in enumerate(M.SIZES):
        if n:
            rt.push(i, jnp.arange(nxt, nxt + n, dtype=jnp.int32), n)
            nxt += n
    rt.round()
    rt.run_fused(2)
    _, _, rounds = rt.run_fused(3, until_drained=True)
    return dict(rounds=rounds, **jax_state(rt))


@pytest.mark.parametrize("case", M.PARITY, ids=CASE_IDS)
def test_mesh_runtime_is_bit_equal_to_the_stacked_runtime(ranks, case):
    got = ranks[0][0]["parity"][case]
    assert_equal(M.parity_case("vmap", *case), got, str(case))
    assert got["rounds"] == 3 and got["telemetry"]


@pytest.mark.parametrize("case", M.PARITY, ids=CASE_IDS)
def test_mesh_runtime_equals_the_jax_package(ranks, case):
    got = ranks[0][0]["parity"][case]
    want = jax_parity(*case)
    assert_equal(want, {k: got[k] for k in want}, str(case))


@pytest.mark.parametrize("case", M.CHECKED, ids=[
    f"{b}{'+check' if c else ''}-{'pods' if p else 'flat'}-{e}"
    for b, c, p, e in M.CHECKED])
def test_relaxed_and_sanitized_backends_on_the_mesh(ranks, case):
    got = ranks[0][0]["checked"][case]
    assert got["checked"] == case[1]
    assert_equal(M.checked_case("vmap", *case), got, str(case))


@pytest.mark.parametrize("case", M.SUPERSTEP, ids=[
    f"{'pods' if p else 'flat'}-{e}" for p, e in M.SUPERSTEP])
def test_sharded_superstep_equals_the_stacked_supersteps(ranks, case):
    """``sharded_superstep`` with one lane per rank: rings, cursors and
    each round's stats equal to ``vmapped_superstep``'s (flat) and the
    stacked ``hierarchical_superstep``'s (pods of 4), in the JAX function's
    lane-0 layout, the same on every rank."""
    results, _ = ranks
    got = results[0]["superstep"][case]
    assert_equal(M.superstep_case("vmap", *case), got, str(case))
    assert sum(got["size"]) == sum(M.SIZES)
    assert got["stats"][0].n_transferred[0] > 0
    assert got["stats"][0].sizes_after.shape == ((M.W // case[0],)
                                                    if case[0] else (M.W,))
    for r in range(1, M.W):
        assert_equal(got, results[r]["superstep"][case], f"rank {r}")


def test_every_rank_holds_the_stacked_layout(ranks):
    """The replicated master: every rank returns the same stats, queues,
    telemetry and history."""
    results, _ = ranks
    for r in range(1, M.W):
        for key in ("parity", "checked", "dag", "fault_flat", "fault_pods",
                    "solver", "padded", "snap_saved", "snap_restored",
                    "decode", "admission"):
            assert_equal(results[0][key], results[r][key], f"rank {r} {key}")


def test_dag_drain_with_a_worker_body_lane_max(ranks):
    got = ranks[0][0]["dag"]
    assert_equal(M.dag_case("vmap"), got, "dag")
    assert int(got["carry"].sum()) == M.DAG["n_nodes"]
    cfg = M.DAG
    rt = jax_launch_runtime(M.W, cfg["capacity"], JSPEC, execution="vmap",
                            policy=JaxPolicy(backend="reference",
                                             **cfg["policy"]),
                            max_pop=cfg["batch"])
    rt.push(0, jnp.zeros((1,), jnp.int32), 1)
    body = jax_dag_body(rt.ops, n_nodes=cfg["n_nodes"], batch=cfg["batch"],
                        fanout=cfg["fanout"])
    carry, ran = jnp.zeros((M.W,), jnp.int32), 0
    while rt.total_size() > 0 and ran < 500:
        carry, _, r = rt.run_fused(16, body, carry, until_drained=True)
        ran += r
    want = dict(carry=np.asarray(carry), ran=ran, **jax_state(rt))
    assert_equal(want, {k: got[k] for k in want}, "dag vs jax")


@pytest.mark.parametrize("name", ["fault_flat", "fault_pods"])
def test_fault_plan_on_the_mesh_equals_the_stacked_run(ranks, name):
    got = ranks[0][0][name]
    if name == "fault_flat":
        want = M.dag_case("vmap", M.FAULT, plan=M.FLAT_PLAN, rounds=2)
        dead = [3]
    else:
        want = M.dag_case("vmap", M.FAULT, plan=M.DEAD_POD_PLAN, pod_size=4,
                          rounds=2)
        dead = [3, 4, 5, 6, 7]
    assert_equal(want, got, name)
    assert int(got["carry"].sum()) == M.FAULT["n_nodes"]
    assert not got["size"][dead].any() and not got["size"].any()


def test_parallel_solve_on_the_mesh(ranks):
    got = ranks[0][0]["solver"]
    want = M.solver_case("vmap")
    assert got["execution"] == "mesh" and want["execution"] == "vmap"
    assert_equal({k: v for k, v in want.items() if k != "execution"},
                 {k: v for k, v in got.items() if k != "execution"})
    cfg = dict(M.SOLVER)
    inst = jax_random_instance(cfg.pop("n_items"), seed=cfg.pop("seed"))
    opt, st = jax_parallel_solve(inst, **cfg)
    assert got["optimum"] == opt == dp_solve(inst)
    for key in ("supersteps", "explored", "transferred",
                "per_worker_explored"):
        assert got[key] == st[key], key
    assert got["telemetry"] == st["telemetry"]


def test_padded_runtime_live_resize_on_the_mesh(ranks):
    got = ranks[0][0]["padded"]
    assert_equal(M.padded_case("vmap"), got, "padded")
    assert got["items"] == got["before"] and got["live"] == 7
    assert got["revived"] == [1, 6]


def test_shrink_and_grow_rebuild_the_mesh(ranks):
    results, _ = ranks
    got = results[0]["resize"]
    want = dict(M.resize_case("vmap"), kind="MeshStealRuntime")
    assert_equal(want, got, "resize")
    assert got["small"]["n"] == 6 and got["n"] == M.W
    assert got["small"]["items"] == got["items"] == got["before"]
    assert got["sizes"][-2:] != [0, 0]  # the regrown lanes took work
    # ranks past the smaller mesh held no runtime, then rejoined
    assert [res["resize"]["small"] is None for res in results] == \
        [False] * 6 + [True] * 2
    for res in results[1:]:
        assert_equal(got, res["resize"] | {"small": got["small"]})


def test_snapshots_cross_between_the_mesh_and_the_stacked_runtime(ranks):
    results, (stacked_dir, mesh_dir) = ranks
    # lane 0 wrote the W lanes' state in the stacked runtime's layout
    step = "step_0000000002/arrays.npz"
    with np.load(f"{stacked_dir}/{step}") as a, \
            np.load(f"{mesh_dir}/{step}") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert_equal(a[key], b[key], key)
    # saved on the flat mesh, restored into the stacked runtime
    restored = M.snapshot_case("vmap", restore_dir=mesh_dir)
    assert restored["saved"]["rounds_run"] == 4
    assert_equal(M.snapshot_case("vmap", restore_dir=stacked_dir), restored)
    # saved on the stacked runtime, restored into the mesh in pods
    assert_equal(M.snapshot_case("vmap", restore_dir=stacked_dir,
                                 pod_size=4),
                 results[0]["snap_restored"], "stacked -> pods mesh")


def test_refusals(ranks):
    results, _ = ranks
    got = results[0]["refusals"]
    assert "unknown execution 'threads'" in got["execution"]
    assert got["size"].startswith("ValueError: mesh has 8 ranks")
    assert "pod_size=4 was requested" in got["flat_with_pods"]
    assert "pod_size=None was requested" in got["pods_without"]
    assert "pinned mesh" in got["device"]
    assert "takes no mesh" in got["vmap_mesh"]
    assert got["derived"].startswith("TypeError") and \
        "pod_size" in got["derived"]
    assert "ranks 0-7" in got["oversized"]
    assert "not divisible by pod_size=3" in got["indivisible"]
    assert got["pinned"] == (4, 8, 1)
    for r, res in enumerate(results):
        assert res["refusals"]["half_member"] == (r < 4)
        assert (res["refusals"]["outside"] == "no error") == (r < 4)
        if r >= 4:
            assert f"rank {r} is outside the 4-lane mesh" in \
                res["refusals"]["outside"]


@pytest.mark.parametrize("steal", ["queue", "migrate"])
def test_decode_cluster_on_the_mesh_equals_the_stacked_run(ranks, steal):
    """One decode lane per rank: the donor broadcasts a migrating slot and
    its pages, every rank routes from one gather of the loads, and the
    harvest gathers every lane's records — so every rank serves what the
    stacked lanes serve, in the same order, with the same stamps."""
    got = ranks[0][0]["decode"][steal]
    assert_equal(M.decode_case("vmap", steal), got, steal)
    assert len(got["outputs"]) == M.DECODE["n_requests"]
    assert got["stolen"] > 0
    assert (got["migrated"] > 0) == (steal == "migrate")


def test_request_id_master_on_the_mesh_equals_the_stacked_run(ranks):
    got = ranks[0][0]["admission"]
    assert_equal(M.admission_case("vmap"), got, "admission")
    assert len(got["served"]) == 24 and got["stolen"] > 0
