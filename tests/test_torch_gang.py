"""kubernetes_tpu_torch gang scheduling against the reference package on the
CPU: `schedule_batch` with the gang gate equals JAX `schedule_batch`
(assignments, scores, feasible counts, both ledgers, rr_end) exactly, on
the cases of tests/test_gang.py and on random batches, and equals
tests/serial_reference.py `schedule_gang`; the Scheduler batches groups
whole, releases what it cannot place together, and commits nothing of a
reverted group, as the reference StateDB does; the encoder and the encode
cache serve gang members like any pod, their gang columns written after
encoding."""

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)
try:
    torch.set_num_interop_threads(1)
except RuntimeError:  # the interop pool already started in this process
    pass

from kubernetes_tpu.api import objects as jobj  # noqa: E402
from kubernetes_tpu.models.policy import DEFAULT_POLICY as J_POLICY  # noqa: E402
from kubernetes_tpu.ops import solver as jsolver  # noqa: E402
from kubernetes_tpu.perf import fixtures as jfixtures  # noqa: E402
from kubernetes_tpu.state import Capacities as JCaps  # noqa: E402
from kubernetes_tpu.state import encode_cluster as j_encode_cluster  # noqa: E402
from kubernetes_tpu.state.encode_cache import EncodeCache as JEncodeCache  # noqa: E402
from kubernetes_tpu.state.pod_batch import blob_col as j_blob_col  # noqa: E402
from kubernetes_tpu.state.pod_batch import empty_batch as j_empty_batch  # noqa: E402
from kubernetes_tpu.state.pod_batch import pack_batch as j_pack_batch  # noqa: E402
from kubernetes_tpu.state.pod_batch import unpack_batch as j_unpack_batch  # noqa: E402
from kubernetes_tpu.state.statedb import StateDB as JStateDB  # noqa: E402
from tests.serial_reference import SerialScheduler  # noqa: E402

from kubernetes_tpu_torch.api import objects as obj  # noqa: E402
from kubernetes_tpu_torch.gang import (  # noqa: E402
    GROUP_MIN_ANNOTATION,
    GROUP_NAME_ANNOTATION,
    annotation_min,
    pod_group_key,
)
from kubernetes_tpu_torch.ops.assign_scan import (  # noqa: E402
    GangInputs,
    assign_scan_gang,
    assign_scan_gang_plain,
)
from kubernetes_tpu_torch.ops.solver import (  # noqa: E402
    BatchFlags,
    schedule_batch,
    schedule_batch_plain,
)
from kubernetes_tpu_torch.perf import fixtures  # noqa: E402
from kubernetes_tpu_torch.perf.harness import run_throughput  # noqa: E402
from kubernetes_tpu_torch.scheduler import Scheduler, driver  # noqa: E402
from kubernetes_tpu_torch.state import Capacities, encode_cluster  # noqa: E402
from kubernetes_tpu_torch.state.convert import (  # noqa: E402
    batch_from_numpy,
    rr_from_numpy,
    state_from_numpy,
)
from kubernetes_tpu_torch.state.encode_cache import EncodeCache  # noqa: E402
from kubernetes_tpu_torch.state.pod_batch import (  # noqa: E402
    BATCH_FIELDS,
    blob_col,
    empty_batch,
    pack_batch,
    write_gang_columns,
)
from kubernetes_tpu_torch.state.statedb import StateDB  # noqa: E402
from tests.test_torch_state import random_cluster  # noqa: E402

N_NODES, P = 64, 32
CAPS = Capacities(num_nodes=N_NODES, batch_pods=P)
JCAPS = JCaps(num_nodes=N_NODES, batch_pods=P)
FIELDS = ("assignments", "scores", "feasible_counts", "new_requested",
          "new_nonzero")
# the reference solver's gates of every batch here: gang only (one compile)
GANG_ONLY = jsolver.BatchFlags(*(f == "gang" for f in (
    "ipa", "spread", "svcanti", "vol", "attach", "tt", "na", "ports", "gpu",
    "storage", "gang", "preempt")))
_JAX_SOLVE = jax.jit(lambda s, b, r: jsolver.schedule_batch(
    s, b, r, J_POLICY, flags=GANG_ONLY))


def jax_solve(state, batch, rr):
    return _JAX_SOLVE(state, batch, np.uint32(rr))


def assert_same(got, want, msg=""):
    for name in FIELDS:
        np.testing.assert_array_equal(
            getattr(got, name).cpu().numpy(), np.asarray(getattr(want, name)),
            err_msg=f"{msg} {name}")
    assert int(got.rr_end) == rr_from_numpy(want.rr_end), msg


def mk_node(name, cpu="4", mem="8Gi", pods="110"):
    return {"metadata": {"name": name},
            "status": {"allocatable": {"cpu": cpu, "memory": mem, "pods": pods},
                       "conditions": [{"type": "Ready", "status": "True"}]}}


def mk_pod(name, cpu=None, mem=None, group=None, quorum=None):
    req = {}
    if cpu:
        req["cpu"] = cpu
    if mem:
        req["memory"] = mem
    c = {"name": "c"}
    if req:
        c["resources"] = {"requests": req}
    meta = {"name": name}
    if group:
        meta["annotations"] = {GROUP_NAME_ANNOTATION: group}
        if quorum:
            meta["annotations"][GROUP_MIN_ANNOTATION] = str(quorum)
    return {"metadata": meta, "spec": {"containers": [c]}}


def solve_both(nodes, pods, gang_ids, gang_mins, rr=0, flags=None):
    """Encode in both packages, write the gang columns, solve: (this
    package's result, its plain path's, the reference's, name_of)."""
    state, batch, table = encode_cluster([obj.Node.from_dict(d) for d in nodes],
                                         [obj.Pod.from_dict(d) for d in pods], CAPS)
    jstate, jbatch, _ = j_encode_cluster([jobj.Node.from_dict(d) for d in nodes],
                                         [jobj.Pod.from_dict(d) for d in pods], JCAPS)
    n = len(pods)
    for b in (batch, jbatch):
        b.gang_id[:n] = np.asarray(gang_ids, np.int32)
        b.gang_min[:n] = np.asarray(gang_mins, np.int32)
    dstate, dbatch = state_from_numpy(state, "cpu"), batch_from_numpy(batch, "cpu")
    got = schedule_batch(dstate, dbatch, rr, flags=flags)
    plain = schedule_batch_plain(dstate, dbatch, rr, flags=flags)
    return got, plain, jax_solve(jstate, jbatch, rr), table.name_of


def oracle(nodes, pods, gang_ids, gang_mins):
    return SerialScheduler([jobj.Node.from_dict(d) for d in nodes]).schedule_gang(
        [jobj.Pod.from_dict(d) for d in pods], list(gang_ids), list(gang_mins))


def names_of(result, name_of, n):
    return [name_of[r] if r >= 0 else None
            for r in result.assignments[:n].tolist()]


# ---- schedule_batch with the gang gate: the cases of tests/test_gang.py ----

def _case(name):
    """(nodes, pods, gang_ids, gang_mins, expected names or None)."""
    small = [mk_node("a", cpu="2"), mk_node("b", cpu="2")]
    if name == "complete":
        return ([mk_node(f"n{i}", cpu="2") for i in range(4)],
                [mk_pod(f"p{i}", cpu="1500m") for i in range(4)],
                [1] * 4, [4] * 4, None)
    if name == "partial_reverts_everything":
        return (small, [mk_pod(f"g{i}", cpu="1500m") for i in range(3)]
                + [mk_pod("solo", cpu="1500m")],
                [1, 1, 1, 0], [3, 3, 3, 0], [None, None, None, "a"])
    if name == "quorum_below_size":
        return (small, [mk_pod(f"g{i}", cpu="1500m") for i in range(3)],
                [1, 1, 1], [2, 2, 2], None)
    if name == "larger_than_any_node":
        return ([mk_node(f"n{i}", cpu="2") for i in range(3)],
                [mk_pod(f"g{i}", cpu="3") for i in range(3)],
                [1, 1, 1], [3, 3, 3], [None] * 3)
    if name == "rr_restored":
        # every node ties; the reverted member's rr bump must not survive
        return ([mk_node(f"n{i}") for i in range(3)],
                [mk_pod("g0"), mk_pod("g1", cpu="100"), mk_pod("t0"), mk_pod("t1")],
                [1, 1, 0, 0], [2, 2, 0, 0], [None, None, "n0", "n1"])
    if name == "back_to_back":
        return (small, [mk_pod(n, cpu="1500m") for n in ("g0", "g1", "h0", "h1")],
                [1, 1, 2, 2], [2, 2, 2, 2], None)
    if name == "last_row_open_group":
        # a full batch whose last group, open at the last row, reverts at
        # the close-out (no padding row after it to cross a boundary)
        nodes = [mk_node(f"n{i}", cpu="2") for i in range(8)]
        pods = ([mk_pod(f"s{i}", cpu="250m") for i in range(P - 6)]
                + [mk_pod(f"g{i}", cpu="1500m") for i in range(6)])
        return (nodes, pods, [0] * (P - 6) + [3] * 6, [0] * (P - 6) + [6] * 6, None)
    if name == "last_row_group_placed":
        nodes = [mk_node(f"n{i}", cpu="2") for i in range(8)]
        pods = ([mk_pod(f"s{i}", cpu="100m") for i in range(P - 4)]
                + [mk_pod(f"g{i}", cpu="500m") for i in range(4)])
        return (nodes, pods, [0] * (P - 4) + [1] * 4, [0] * (P - 4) + [4] * 4, None)
    if name == "node_took_two_members":
        # one roomy node takes both members of a group whose third fits
        # nowhere: the node's row must end at its value before the first
        return ([mk_node("big", cpu="8"), mk_node("x", cpu="1")],
                [mk_pod("m0", cpu="3"), mk_pod("m1", cpu="3"), mk_pod("m2", cpu="9"),
                 mk_pod("after", cpu="500m")],
                [1, 1, 1, 0], [3, 3, 3, 0], [None, None, None, "big"])
    raise KeyError(name)


CASES = ("complete", "partial_reverts_everything", "quorum_below_size",
         "larger_than_any_node", "rr_restored", "back_to_back",
         "last_row_open_group", "last_row_group_placed", "node_took_two_members")


@pytest.mark.parametrize("case", CASES)
def test_schedule_batch_with_gang_matches_reference(case):
    nodes, pods, gang_ids, gang_mins, expected = _case(case)
    got, plain, want, name_of = solve_both(nodes, pods, gang_ids, gang_mins)
    assert_same(got, want, case)
    assert_same(plain, want, f"{case} plain")
    names = names_of(got, name_of, len(pods))
    assert names == oracle(nodes, pods, gang_ids, gang_mins)
    if expected is not None:
        assert names == expected
    # the groups the solver reports placed and reverted
    first = [i for i, g in enumerate(gang_ids) if g and (i == 0 or gang_ids[i - 1] != g)]
    reverted = sum(names[i] is None for i in first)
    assert (int(got.gang_placed), int(got.gang_reverted)) == (len(first) - reverted,
                                                              reverted)


def test_revert_restores_the_ledger_and_rr_exactly():
    nodes, pods, gang_ids, gang_mins, _ = _case("node_took_two_members")
    state, batch, _t = encode_cluster([obj.Node.from_dict(d) for d in nodes],
                                      [obj.Pod.from_dict(d) for d in pods[:3]], CAPS)
    batch.gang_id[:3], batch.gang_min[:3] = 1, 3
    dstate = state_from_numpy(state, "cpu")
    got = schedule_batch(dstate, batch_from_numpy(batch, "cpu"), 7)
    assert torch.equal(got.new_requested, dstate.requested)
    assert torch.equal(got.new_nonzero, dstate.nonzero_requested)
    assert int(got.rr_end) == 7
    assert (got.assignments[:3] == -1).all() and (got.scores[:3] == 0).all()


@pytest.mark.parametrize("rr", [0, 5, 2**32 - 1])
def test_rr_start_and_wraparound_through_a_revert(rr):
    nodes, pods, gang_ids, gang_mins, _ = _case("rr_restored")
    got, plain, want, _n = solve_both(nodes, pods, gang_ids, gang_mins, rr=rr)
    assert_same(got, want, f"rr={rr}")
    assert_same(plain, want, f"rr={rr} plain")


def test_non_gang_batch_equals_the_main_path():
    rng = np.random.RandomState(900)
    nodes, pods = random_cluster(rng, 40, P)
    forced = BatchFlags(*(f == "gang" for f in (
        "ipa", "spread", "svcanti", "vol", "attach", "tt", "na", "ports", "gpu",
        "storage", "gang", "preempt")))
    gang_build, _p, want, _n = solve_both(nodes, pods, [0] * P, [0] * P, rr=3,
                                          flags=forced)
    main, _p, _w, _n = solve_both(nodes, pods, [0] * P, [0] * P, rr=3)
    assert main.gang_placed is None and int(gang_build.gang_placed) == 0
    assert_same(gang_build, want, "gang build")
    assert_same(main, want, "main path")


def _random_groups(rng, n, gang_share=0.6, max_size=5):
    """Contiguous runs: gang groups (ids 1, 2, ...) of random size and
    quorum, and non-gang pods between them."""
    gang_ids, gang_mins, gid = [], [], 0
    while len(gang_ids) < n:
        size = min(int(rng.randint(1, max_size + 1)), n - len(gang_ids))
        if rng.rand() < gang_share:
            gid += 1
            quorum = int(rng.randint(1, size + 1))
            gang_ids += [gid] * size
            gang_mins += [quorum] * size
        else:
            gang_ids += [0] * size
            gang_mins += [0] * size
    return gang_ids, gang_mins


@pytest.mark.parametrize("seed", range(4))
def test_random_gang_batches_match_the_serial_oracle(seed):
    rng = np.random.RandomState(910 + seed)
    nodes = [mk_node(f"n{i}", cpu=str(rng.randint(1, 5)),
                     mem=f"{rng.randint(1, 9)}Gi", pods=str(rng.randint(2, 6)))
             for i in range(12)]
    pods = [mk_pod(f"p{i}", cpu=rng.choice(["250m", "500m", "1", "2"]),
                   mem=rng.choice([None, "512Mi", "2Gi"]))
            for i in range(P)]
    gang_ids, gang_mins = _random_groups(rng, P)
    got, plain, want, name_of = solve_both(nodes, pods, gang_ids, gang_mins)
    assert_same(got, want, f"seed {seed}")
    assert_same(plain, want, f"seed {seed} plain")
    names = names_of(got, name_of, P)
    assert names == oracle(nodes, pods, gang_ids, gang_mins)
    assert None in names and any(names)


@pytest.mark.parametrize("seed", range(3))
def test_random_gang_batches_on_the_main_paths_features_match_reference(seed):
    """random_cluster's nodes and pods (selectors, taints, conditions,
    nodeName pins, node affinity, avoid annotations) cut into groups."""
    rng = np.random.RandomState(920 + seed)
    nodes, pods = random_cluster(rng, 48, P)
    gang_ids, gang_mins = _random_groups(rng, P, gang_share=0.7)
    rr = [0, 9, 2**32 - 2][seed]
    got, plain, want, _n = solve_both(nodes, pods, gang_ids, gang_mins, rr=rr)
    assert_same(got, want, f"seed {seed}")
    assert_same(plain, want, f"seed {seed} plain")
    assert int(got.gang_reverted) > 0 and int(got.gang_placed) > 0


def test_gang_wrapper_runs_the_plain_scan_on_the_cpu():
    rng = np.random.RandomState(930)
    p, n = 24, 40
    masked = torch.from_numpy(np.where(rng.rand(p, n) < 0.3, -np.inf, 0.0)
                              .astype(np.float32))
    reqs = torch.zeros((p, 6))
    reqs[:, 0], reqs[:, 1], reqs[:, 2] = 1.0, 500.0, 256.0
    nz = reqs[:, 1:3].clone()
    alloc = torch.zeros((n, 6))
    alloc[:, 0], alloc[:, 1], alloc[:, 2] = 4.0, 1000.0, 1024.0
    gang = GangInputs(gang_id=torch.tensor([1] * 8 + [0] * 4 + [2] * 12, dtype=torch.int32),
                      gang_min=torch.tensor([8] * 8 + [0] * 4 + [12] * 12,
                                            dtype=torch.int32))
    args = (masked, reqs, nz, alloc, torch.zeros((n, 6)), torch.zeros((n, 2)), 4,
            1.0, 1.0, gang)
    got, want = assign_scan_gang(*args), assign_scan_gang_plain(*args)
    for name in ("assignments", "scores", "feasible_counts", "new_requested",
                 "new_nonzero", "rr_end"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    with pytest.raises(ValueError, match="gang_min"):
        assign_scan_gang(*args[:-1], GangInputs(gang.gang_id, gang.gang_min[:3]))


@pytest.mark.parametrize("gates", ["gang+spread", "gang+ipa"])
def test_gang_with_another_build_names_both_gates(gates):
    """The batch the solver once refused, naming both gates, since the gang
    carry in the spread and interpod builds: random_cluster's batch with a
    group of two whose first pod has a spread entry or whose second pod a
    required affinity term equals JAX's, all four ledgers included."""
    rng = np.random.RandomState(940)
    nodes, pods = random_cluster(rng, 24, P)
    state, batch, _t = encode_cluster([obj.Node.from_dict(d) for d in nodes],
                                      [obj.Pod.from_dict(d) for d in pods], CAPS)
    jstate, jbatch, jtable = j_encode_cluster([jobj.Node.from_dict(d) for d in nodes],
                                              [jobj.Pod.from_dict(d) for d in pods],
                                              JCAPS)
    for b in (batch, jbatch):
        b.gang_id[:2], b.gang_min[:2] = 1, 2
        if gates == "gang+spread":
            b.spread_q[0] = 0
        else:
            b.paff_q[1, 0] = 0
    jflags = jsolver.batch_flags(jbatch, len(pods), jtable)
    assert jflags.gang and getattr(jflags, gates[5:])
    want = jax.jit(lambda s, b, r: jsolver.schedule_batch(
        s, b, r, J_POLICY, flags=jflags))(jstate, jbatch, np.uint32(0))
    got = schedule_batch(state_from_numpy(state, "cpu"), batch_from_numpy(batch, "cpu"), 0)
    assert_same(got, want, gates)
    for name in ("new_podsel", "new_term"):
        if getattr(got, name) is not None:   # (None: passed through)
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)), name)


# ---- the encoder and the encode cache ----

def test_encoder_accepts_gang_members_and_leaves_their_columns_zero():
    rng = np.random.RandomState(950)
    nodes, pods = random_cluster(rng, 20, P)
    for i, d in enumerate(pods):
        d["metadata"]["annotations"] = {GROUP_NAME_ANNOTATION: f"g{i // 4}",
                                        GROUP_MIN_ANNOTATION: "3"}
    (state, batch, _t) = encode_cluster([obj.Node.from_dict(d) for d in nodes],
                                        [obj.Pod.from_dict(d) for d in pods], CAPS)
    jstate, jbatch, _jt = j_encode_cluster([jobj.Node.from_dict(d) for d in nodes],
                                           [jobj.Pod.from_dict(d) for d in pods], JCAPS)
    for name in BATCH_FIELDS:
        if name != "img_onehot":
            np.testing.assert_array_equal(getattr(batch, name),
                                          np.asarray(getattr(jbatch, name)),
                                          err_msg=name)
    assert batch.valid[:P].all()
    assert not batch.gang_id.any() and not batch.gang_min.any()


def test_cache_serves_a_gang_member_and_the_driver_writes_its_columns():
    """A gang member hits the class row of a plain pod of its spec; the
    gang columns written into the blobs afterwards equal the reference
    driver's (JAX blob_col writes on the reference's cache rows)."""
    db = StateDB(CAPS, device="cpu")
    jdb = JStateDB(JCAPS)
    for d in (mk_node("n0"), mk_node("n1")):
        db.upsert_node(obj.Node.from_dict(d))
        jdb.upsert_node(jobj.Node.from_dict(d))
    cache, jcache = EncodeCache(CAPS, db.table), JEncodeCache(JCAPS, jdb.table)
    fblob, iblob = pack_batch(empty_batch(CAPS), CAPS)
    jf, ji = j_pack_batch(j_empty_batch(JCAPS), JCAPS)
    dicts = ([mk_pod("plain", cpu="250m")]
             + [mk_pod(f"m{i}", cpu="250m", group="train", quorum=3) for i in range(3)])
    for i, d in enumerate(dicts):
        cache.encode_packed_into(fblob, iblob, i, obj.Pod.from_dict(d))
        jcache.encode_packed_into(jf, ji, i, jobj.Pod.from_dict(d))
    assert (cache.misses, cache.hits) == (1, 3)
    gang_id, gang_min = [0, 1, 1, 1], [0, 3, 3, 3]
    write_gang_columns(fblob, iblob, gang_id, gang_min, CAPS)
    j_blob_col(jf, ji, "gang_id", JCAPS)[:4] = gang_id
    j_blob_col(jf, ji, "gang_min", JCAPS)[:4] = gang_min
    np.testing.assert_array_equal(fblob.view(np.int32), np.asarray(jf).view(np.int32))
    np.testing.assert_array_equal(iblob, np.asarray(ji))
    assert blob_col(fblob, iblob, "gang_id", CAPS, 4).tolist() == gang_id
    assert j_unpack_batch(jf, ji, JCAPS).gang_min[:4].tolist() == gang_min


# ---- the driver ----

def _record_batches(monkeypatch):
    """Record every batch the driver solves: (batch, result)."""
    seen = []
    solve = driver.schedule_batch

    def recording(state, batch, rr, policy, flags, caps, **kw):
        result = solve(state, batch, rr, policy, flags, caps, **kw)
        seen.append((batch, flags, result))
        return result

    monkeypatch.setattr(driver, "schedule_batch", recording)
    return seen


def _groups(batch):
    """{group id: rows} of a solved batch."""
    gid = batch.gang_id.tolist()
    out = {}
    for i, g in enumerate(gid):
        if g:
            out.setdefault(g, []).append(i)
    return out


def test_driver_batches_groups_whole_and_moves_an_overflowing_group(monkeypatch):
    seen = _record_batches(monkeypatch)
    caps = Capacities(num_nodes=N_NODES, batch_pods=8)
    sched = Scheduler(caps, device="cpu")
    sched.add_nodes([obj.Node.from_dict(mk_node(f"n{i}")) for i in range(6)])
    # three groups of 3 at quorum 3, their members interleaved with solo pods
    dicts = []
    for g in range(3):
        dicts += [mk_pod(f"g{g}-{m}", cpu="100m", group=f"job{g}", quorum=3)
                  for m in range(3)]
        dicts.append(mk_pod(f"solo{g}", cpu="100m"))
    placed = sched.schedule([obj.Pod.from_dict(d) for d in dicts])
    assert all(placed.values()) and len(placed) == 12
    assert (sched.gang_placed, sched.gang_reverted, sched.gang_timeouts) == (3, 0, 0)
    sizes = [int(b.valid.sum()) for b, _f, _r in seen]
    # job0 + solo0 + job1 + solo1 = 8; job2 + solo2
    assert sizes == [8, 4]
    for batch, flags, _r in seen:
        assert flags.gang
        for rows in _groups(batch).values():
            assert len(rows) == 3 and rows == list(range(rows[0], rows[0] + 3))
    # a group that no longer fits closes the batch: solo rows keep their order
    dicts2 = [mk_pod(f"s{i}", cpu="100m") for i in range(6)] + [
        mk_pod(f"late{m}", cpu="100m", group="late", quorum=3) for m in range(3)]
    seen.clear()
    sched.schedule([obj.Pod.from_dict(d) for d in dicts2])
    assert [int(b.valid.sum()) for b, _f, _r in seen] == [6, 3]
    assert _groups(seen[1][0]) == {1: [0, 1, 2]} and not seen[0][1].gang


def test_driver_orders_a_group_at_its_quorum_member_sorted_by_key(monkeypatch):
    seen = _record_batches(monkeypatch)
    sched = Scheduler(CAPS, device="cpu")
    sched.add_nodes([obj.Node.from_dict(mk_node(f"n{i}")) for i in range(4)])
    dicts = [mk_pod("m9", cpu="100m", group="g", quorum=2), mk_pod("a", cpu="100m"),
             mk_pod("m10", cpu="100m", group="g", quorum=2), mk_pod("b", cpu="100m"),
             mk_pod("m0", cpu="100m", group="g", quorum=2)]
    rows = []
    schedule_chunk = sched._schedule_chunk

    def recording(pods, gang_id=None, gang_min=None):
        rows.extend(p.metadata.name for p in pods)
        return schedule_chunk(pods, gang_id, gang_min)

    monkeypatch.setattr(sched, "_schedule_chunk", recording)
    sched.schedule([obj.Pod.from_dict(d) for d in dicts])
    # the group at its second member's place, members in key order
    assert rows == ["a", "m0", "m10", "m9", "b"]
    batch = seen[0][0]
    assert batch.gang_id[:5].tolist() == [0, 1, 1, 1, 0]
    assert batch.gang_min[:5].tolist() == [0, 2, 2, 2, 0]
    assert sched.last_result.assignments[:5].ge(0).all()


def test_driver_releases_a_group_larger_than_a_batch(monkeypatch):
    seen = _record_batches(monkeypatch)
    caps = Capacities(num_nodes=N_NODES, batch_pods=4)
    sched = Scheduler(caps, device="cpu")
    sched.add_nodes([obj.Node.from_dict(mk_node(f"n{i}")) for i in range(4)])
    dicts = [mk_pod(f"w{i}", cpu="100m", group="wide", quorum=6) for i in range(6)]
    placed = sched.schedule([obj.Pod.from_dict(d) for d in dicts])
    assert all(placed.values())
    assert (sched.gang_placed, sched.gang_reverted, sched.gang_timeouts) == (0, 0, 0)
    assert [int(b.valid.sum()) for b, _f, _r in seen] == [4, 2]
    assert not any(f.gang for _b, f, _r in seen)


def test_driver_releases_a_group_below_quorum_individually(monkeypatch):
    seen = _record_batches(monkeypatch)
    sched = Scheduler(CAPS, device="cpu")
    sched.add_nodes([obj.Node.from_dict(mk_node(f"n{i}", cpu="2")) for i in range(2)])
    sched.add_pod_group(obj.PodGroup.from_dict(
        {"metadata": {"name": "half"}, "spec": {"minMember": 3}}))
    dicts = [mk_pod(f"h{i}", cpu="100m", group="half") for i in range(2)]
    placed = sched.schedule([obj.Pod.from_dict(d) for d in dicts])
    assert all(placed.values())
    assert (sched.gang_placed, sched.gang_timeouts) == (0, 1)
    assert not seen[0][1].gang


def test_driver_quorum_prefers_the_pod_group_then_the_largest_annotation():
    sched = Scheduler(CAPS, device="cpu")
    pods = [obj.Pod.from_dict(mk_pod(f"m{i}", group="g", quorum=q))
            for i, q in enumerate((2, 5, None))]
    assert sched._gang_quorum("default/g", pods) == 5
    assert sched._gang_quorum("default/g", pods[2:]) == 1
    group = obj.PodGroup.from_dict({"metadata": {"name": "g"},
                                    "spec": {"minMember": 3}})
    sched.add_pod_group(group)
    assert sched._gang_quorum("default/g", pods) == 3
    sched.remove_pod_group(group)
    assert sched._gang_quorum("default/g", pods) == 5
    assert [annotation_min(p) for p in pods] == [2, 5, None]
    assert pod_group_key(pods[0]) == "default/g"


class _JaxGangChain:
    """The reference package driven as this package's Scheduler drives a
    gang batch: encode cache, gang columns after encoding, StateDB flush,
    schedule_batch, commit of the placed rows."""

    def __init__(self, nodes):
        self.db = JStateDB(JCAPS)
        for d in nodes:
            self.db.upsert_node(jobj.Node.from_dict(d))
        self.cache = JEncodeCache(JCAPS, self.db.table)
        self.rr = 0

    def schedule(self, pod_dicts, gang_id, gang_min):
        pods = [jobj.Pod.from_dict(d) for d in pod_dicts]
        fblob, iblob = j_pack_batch(j_empty_batch(JCAPS), JCAPS)
        for i, pod in enumerate(pods):
            self.cache.encode_packed_into(fblob, iblob, i, pod)
        j_blob_col(fblob, iblob, "gang_id", JCAPS)[:len(pods)] = gang_id
        j_blob_col(fblob, iblob, "gang_min", JCAPS)[:len(pods)] = gang_min
        batch = j_unpack_batch(fblob, iblob, JCAPS)
        assert jsolver.batch_flags(batch, len(pods), self.db.table) == GANG_ONLY
        res = jax_solve(self.db.flush(), batch, self.rr)
        rows = np.asarray(res.assignments)
        names = [self.db.table.name_of[r] if r >= 0 else None
                 for r in rows[:len(pods)]]
        self.db.commit_batch(res, fblob, [(p, n, i) for i, (p, n)
                                          in enumerate(zip(pods, names)) if n])
        self.rr = rr_from_numpy(res.rr_end)
        return {p.key: n for p, n in zip(pods, names)}, res


def test_driver_commits_nothing_of_a_reverted_group(monkeypatch):
    seen = _record_batches(monkeypatch)
    nodes = [mk_node(f"n{i}", cpu="2") for i in range(3)]
    # train (3 x 1.5 cpu) places; big (3 x 1.5 cpu) cannot: 3 nodes, one
    # left; solo pods around them
    dicts = ([mk_pod(f"t{i}", cpu="1500m", group="train", quorum=3) for i in range(3)]
             + [mk_pod("solo0", cpu="250m")]
             + [mk_pod(f"b{i}", cpu="1500m", group="big", quorum=3) for i in range(3)]
             + [mk_pod("solo1", cpu="250m")])
    sched = Scheduler(CAPS, device="cpu")
    sched.add_nodes([obj.Node.from_dict(d) for d in nodes])
    placed = sched.schedule([obj.Pod.from_dict(d) for d in dicts])
    assert (sched.gang_placed, sched.gang_reverted) == (1, 1)
    assert [placed[f"default/b{i}"] for i in range(3)] == [None] * 3
    assert all(placed[f"default/t{i}"] for i in range(3))
    for i in range(3):
        assert not sched.statedb.is_accounted(f"default/b{i}")
        assert sched.statedb.is_accounted(f"default/t{i}")
    # the reference, fed the same rows and gang columns
    batch = seen[0][0]
    ref = _JaxGangChain(nodes)
    want, res = ref.schedule(dicts, batch.gang_id[:8].numpy(), batch.gang_min[:8].numpy())
    assert placed == want
    assert_same(sched.last_result, res)
    for name in ("requested", "nonzero_requested"):
        np.testing.assert_array_equal(getattr(sched.statedb.host, name),
                                      np.asarray(getattr(ref.db.host, name)), name)
        np.testing.assert_array_equal(getattr(sched.statedb.flush(), name).numpy(),
                                      np.asarray(getattr(ref.db.flush(), name)), name)
    assert all(ref.db.is_accounted(f"default/t{i}") for i in range(3))
    assert not any(ref.db.is_accounted(f"default/b{i}") for i in range(3))


@pytest.mark.parametrize("seed", range(2))
def test_driver_chains_gang_batches_like_the_reference(seed, monkeypatch):
    """Random groups and solo pods over chained batches: each batch's
    result and the StateDB ledgers equal the reference's on the rows and
    gang columns the driver built."""
    seen = _record_batches(monkeypatch)
    rng = np.random.RandomState(960 + seed)
    nodes = [mk_node(f"n{i}", cpu=str(rng.randint(1, 4)), pods=str(rng.randint(2, 5)))
             for i in range(16)]
    dicts, g = [], 0
    while len(dicts) < 3 * P - 8:
        size = int(rng.randint(1, 6))
        if rng.rand() < 0.6:
            dicts += [mk_pod(f"j{g}-{m}", cpu=rng.choice(["250m", "500m", "1"]),
                             group=f"job{g}", quorum=int(rng.randint(1, size + 1)))
                      for m in range(size)]
            g += 1
        else:
            dicts += [mk_pod(f"s{len(dicts)}-{m}", cpu="250m") for m in range(size)]
    sched = Scheduler(CAPS, device="cpu")
    sched.add_nodes([obj.Node.from_dict(d) for d in nodes])
    chunks = []
    schedule_chunk = sched._schedule_chunk

    def recording(pods, gang_id=None, gang_min=None):
        chunks.append([p.metadata.name for p in pods])
        return schedule_chunk(pods, gang_id, gang_min)

    monkeypatch.setattr(sched, "_schedule_chunk", recording)
    placed = sched.schedule([obj.Pod.from_dict(d) for d in dicts])
    assert len(chunks) == len(seen) >= 3
    by_name = {d["metadata"]["name"]: d for d in dicts}
    ref = _JaxGangChain(nodes)
    for names, (batch, _flags, result) in zip(chunks, seen):
        n = len(names)
        want, res = ref.schedule([by_name[m] for m in names],
                                 batch.gang_id[:n].numpy(), batch.gang_min[:n].numpy())
        assert {k: placed[k] for k in want} == want
        assert_same(result, res)
    for name in ("requested", "nonzero_requested"):
        np.testing.assert_array_equal(getattr(sched.statedb.host, name),
                                      np.asarray(getattr(ref.db.host, name)), name)
    assert sched.gang_reverted > 0 and sched.gang_placed > 0
    assert None in placed.values()


# ---- fixtures and the harness ----

def test_fixture_gang_pods_match_reference():
    mine = fixtures.make_pods(20, gang_size=8, gang_min=6)
    ref = jfixtures.make_pods(20, gang_size=8, gang_min=6)
    assert [p.metadata.annotations for p in mine] == [p.metadata.annotations for p in ref]
    assert pod_group_key(mine[9]) == "default/pod-gang-1"


def test_run_throughput_settles_every_group_or_fails():
    caps = Capacities(num_nodes=N_NODES, batch_pods=P)
    result = run_throughput(40, 48, caps=caps, pod_kwargs={"gang_size": 8},
                            device="cpu")
    assert (result.gang_groups, result.gang_placed, result.gang_reverted) == (6, 6, 0)
    assert result.scheduled == 48 and result.batches == 2
    # a trailing group of 4 at quorum 8 is released, not settled
    with pytest.raises(RuntimeError, match="5/6 groups settled"):
        run_throughput(40, 44, caps=caps, pod_kwargs={"gang_size": 8}, device="cpu")
