"""kubernetes_tpu_torch pod priority and the preemption pass against the
reference package on the CPU: the scenarios and the randomized oracle
parity of tests/test_preemption.py run through both packages (the port's
StateDB, encoder and build_victim_table against JAX encode_cluster and its
VictimTable), JAX `schedule_batch(..., victims=)` equal in assignments,
preempt_node and victim_count, the oracle's victim sets resolved from the
port's verdicts; priority batches without a table equal to JAX on every
build; a priority-free batch unchanged by a table; the host half (the
table from the StateDB, the encoder's priority column) against JAX's; the
Scheduler's verdicts, the caller's removals and the wave landing; the
preemption cell's traffic at a small size; and the normalization flag's
weight limit."""

import dataclasses
from types import SimpleNamespace

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
from kubernetes_tpu.ops import solver as jsolver  # noqa: E402
from kubernetes_tpu.preemption import build_victim_table as j_build_victim_table  # noqa: E402
from kubernetes_tpu.preemption import resolve_victims as j_resolve_victims  # noqa: E402
from kubernetes_tpu.state import Capacities as JCaps  # noqa: E402
from kubernetes_tpu.state import encode_cluster as j_encode_cluster  # noqa: E402
from kubernetes_tpu.state.statedb import StateDB as JStateDB  # noqa: E402
from tests.serial_reference import SerialScheduler  # noqa: E402
from tests.test_preemption import build_tables  # noqa: E402

from kubernetes_tpu_torch.api import objects as obj  # noqa: E402
from kubernetes_tpu_torch.ops import assign_scan as scan_ops  # noqa: E402
from kubernetes_tpu_torch.ops.preemption import (  # noqa: E402
    VictimTable,
    preemption_pass,
    preemption_pass_plain,
)
from kubernetes_tpu_torch.ops.solver import schedule_batch, schedule_batch_plain  # noqa: E402
from kubernetes_tpu_torch.perf import harness  # noqa: E402
from kubernetes_tpu_torch.preemption import build_victim_table, resolve_victims  # noqa: E402
from kubernetes_tpu_torch.scheduler import Scheduler  # noqa: E402
from kubernetes_tpu_torch.state import Capacities, encode_cluster  # noqa: E402
from kubernetes_tpu_torch.state.convert import (  # noqa: E402
    batch_from_numpy,
    rr_from_numpy,
    state_from_numpy,
    victims_from_numpy,
)
from kubernetes_tpu_torch.state.pod_batch import encode_pods  # noqa: E402
from kubernetes_tpu_torch.state.statedb import StateDB  # noqa: E402
from tests.test_torch_state import random_cluster  # noqa: E402

CAPS = Capacities(num_nodes=16, batch_pods=16, victim_slots=8)
JCAPS = JCaps(num_nodes=16, batch_pods=16, victim_slots=8)
_JAX_SOLVE = {}


def jax_solve(state, batch, rr, flags, victims=None):
    """JAX schedule_batch under DEFAULT_POLICY, jitted once per flags value
    and per table presence."""
    key = (flags, victims is None)
    fn = _JAX_SOLVE.get(key)
    if fn is None:
        fn = _JAX_SOLVE[key] = jax.jit(
            lambda s, b, r, v: jsolver.schedule_batch(s, b, r, flags=flags, victims=v))
    return fn(state, batch, np.uint32(rr), victims)


def node_d(name, cpu="4", mem="8Gi", pods="110"):
    return {"metadata": {"name": name},
            "status": {"allocatable": {"cpu": cpu, "memory": mem, "pods": pods},
                       "conditions": [{"type": "Ready", "status": "True"}]}}


def pod_d(name, cpu=None, mem=None, priority=0, node=None):
    c = {"name": "c"}
    req = {k: v for k, v in (("cpu", cpu), ("memory", mem)) if v}
    if req:
        c["resources"] = {"requests": req}
    spec = {"containers": [c], "priority": priority}
    if node:
        spec["nodeName"] = node
    return {"metadata": {"name": name}, "spec": spec}


def port_side(nodes, pods, filler, evictable=None, gang=None, caps=CAPS):
    """The port's StateDB with the filler bound, the pods encoded against
    it, its table, and schedule_batch with it: (result, plain result,
    name_of, slots, victims)."""
    db = StateDB(caps, device="cpu")
    for d in nodes:
        db.upsert_node(obj.Node.from_dict(d))
    for d in filler:
        assert db.add_pod(obj.Pod.from_dict(d))
    batch = encode_pods([obj.Pod.from_dict(d) for d in pods], caps, db.table)
    if gang:
        batch.gang_id[:len(pods)] = np.asarray(gang[0], np.int32)
        batch.gang_min[:len(pods)] = np.asarray(gang[1], np.int32)
    host, slots = build_victim_table(db, evictable=evictable)
    victims = None if host is None else victims_from_numpy(host, "cpu")
    state, dbatch = db.flush(), batch_from_numpy(batch, "cpu")
    got = schedule_batch(state, dbatch, 0, victims=victims)
    plain = schedule_batch_plain(state, dbatch, 0, victims=victims)
    return got, plain, db.table.name_of, slots, host


def jax_side(nodes, pods, filler, evictable=None, gang=None, caps=JCAPS):
    """JAX encode_cluster with the filler assigned, tests/test_preemption's
    table, and schedule_batch(victims=): (result, name_of, by_name, slots,
    victims)."""
    jn = [jobj.Node.from_dict(d) for d in nodes]
    jp = [jobj.Pod.from_dict(d) for d in pods]
    jf = [jobj.Pod.from_dict(d) for d in filler]
    state, batch, table = j_encode_cluster(jn, jp, caps, assigned_pods=jf)
    if gang:
        batch.gang_id[:len(pods)] = np.asarray(gang[0], np.int32)
        batch.gang_min[:len(pods)] = np.asarray(gang[1], np.int32)
    victims, by_name, slots = build_tables(jf, table, caps, evictable)
    flags = jsolver.batch_flags(batch, len(pods), table)
    return jax_solve(state, batch, 0, flags, victims), table.name_of, by_name, slots, victims


def oracle(nodes, pods, filler, by_name, gang=None):
    ser = SerialScheduler([jobj.Node.from_dict(d) for d in nodes],
                          assigned_pods=[jobj.Pod.from_dict(d) for d in filler])
    jp = [jobj.Pod.from_dict(d) for d in pods]
    results = ser.schedule_gang(jp, gang[0], gang[1]) if gang else ser.schedule(jp)
    return results, ser.preempt(jp, results, by_name,
                                gang_ids=gang[0] if gang else None)


def names(rows, name_of, n):
    return [name_of[int(r)] if r >= 0 else None for r in np.asarray(rows)[:n]]


def assert_equal_to_jax(got, plain, name_of, want, jname_of, n):
    for res in (got, plain):
        assert names(res.assignments, name_of, n) == names(want.assignments, jname_of, n)
        assert names(res.preempt_node, name_of, n) == names(want.preempt_node, jname_of, n)
        np.testing.assert_array_equal(res.victim_count.numpy()[:n],
                                      np.asarray(want.victim_count)[:n])


def assert_tables_equal(host, slots, name_of, victims, jslots, jname_of):
    """The port's table equals JAX's, row for row by node name."""
    rows = [r for r, name in enumerate(name_of) if name is not None]
    jrow = {name: r for r, name in enumerate(jname_of) if name is not None}
    for r in rows:
        j = jrow[name_of[r]]
        np.testing.assert_array_equal(host.prio[r], np.asarray(victims.prio)[j])
        np.testing.assert_array_equal(host.req[r], np.asarray(victims.req)[j])
        np.testing.assert_array_equal(host.ok[r], np.asarray(victims.ok)[j])
        assert slots.get(r, []) == jslots.get(j, [])


def run_both(nodes, pods, filler, evictable=None, gang=None):
    """Both packages on one case, their results and tables equal, and the
    port's verdicts resolved to the oracle's victim sets where the
    reference's are. Returns (port result, oracle verdicts)."""
    j_ev = None
    if evictable is not None:
        j_ev = lambda p: evictable(p)  # noqa: E731
    got, plain, name_of, slots, host = port_side(nodes, pods, filler, evictable, gang)
    want, jname_of, by_name, jslots, jvictims = jax_side(nodes, pods, filler, j_ev, gang)
    n = len(pods)
    assert_equal_to_jax(got, plain, name_of, want, jname_of, n)
    assert_tables_equal(host, slots, name_of, jvictims, jslots, jname_of)
    results, verdicts = oracle(nodes, pods, filler, by_name, gang)
    assert names(got.assignments, name_of, n) == results
    taken: set = set()
    for i, (want_node, want_victims) in enumerate(verdicts):
        node = names(got.preempt_node, name_of, n)[i]
        assert node == want_node, f"pod {i}: {node} != oracle {want_node}"
        k = int(got.victim_count[i])
        assert k == len(want_victims)
        if node is not None:
            assert tuple(resolve_victims(slots, int(got.preempt_node[i]), k,
                                         pods[i]["spec"]["priority"], taken)) == want_victims
    return got, verdicts


# ---- the seven scenarios of tests/test_preemption.py ----

def test_basic_preemption_picks_lowest_priority_victims():
    nodes = [node_d("n0"), node_d("n1")]
    filler = [pod_d("f0", "1800m", priority=1, node="n0"),
              pod_d("f1", "1800m", priority=2, node="n0"),
              pod_d("f2", "3600m", priority=5, node="n1")]
    _, verdicts = run_both(nodes, [pod_d("hi", "3500m", priority=100)], filler)
    assert verdicts[0][0] == "n0" and len(verdicts[0][1]) == 2


def test_equal_or_higher_priority_never_victim():
    nodes = [node_d("n0", cpu="2")]
    filler = [pod_d("f0", "1800m", priority=100, node="n0")]
    pods = [pod_d("same", "1500m", priority=100), pod_d("lower", "1500m", priority=50)]
    _, verdicts = run_both(nodes, pods, filler)
    assert verdicts == [(None, ()), (None, ())]


def test_pdb_protected_victims_never_evicted():
    nodes = [node_d("n0", cpu="2"), node_d("n1", cpu="2")]
    filler = [pod_d("f0", "1800m", priority=1, node="n0"),
              pod_d("f1", "1800m", priority=2, node="n1")]
    _, verdicts = run_both(nodes, [pod_d("hi", "1500m", priority=100)], filler,
                           evictable=lambda p: p.metadata.name != "f0")
    assert verdicts[0][0] == "n1" and verdicts[0][1] == ("default/f1",)


def test_no_feasible_victim_set_yields_no_verdict():
    nodes = [node_d("n0", cpu="2")]
    filler = [pod_d("f0", "500m", priority=1, node="n0"),
              pod_d("keep", "1400m", priority=200, node="n0")]
    got, verdicts = run_both(nodes, [pod_d("hi", "1800m", priority=100)], filler)
    assert verdicts == [(None, ())] and int(got.preempt_node[0]) == -1


def test_in_batch_preemptors_never_double_book_victims():
    nodes = [node_d("n0", cpu="2"), node_d("n1", cpu="2")]
    filler = [pod_d("f0", "1800m", priority=1, node="n0"),
              pod_d("f1", "1800m", priority=2, node="n1")]
    pods = [pod_d("hi-a", "1500m", priority=100), pod_d("hi-b", "1500m", priority=100)]
    _, verdicts = run_both(nodes, pods, filler)
    assert {v[0] for v in verdicts} == {"n0", "n1"}


def test_gang_preempts_whole_quorum_or_nothing():
    nodes = [node_d("n0", cpu="2"), node_d("n1", cpu="2")]
    filler = [pod_d("f0", "1800m", priority=1, node="n0"),
              pod_d("f1", "1800m", priority=1, node="n1")]
    pods = [pod_d(f"g{i}", "1500m", priority=100) for i in range(3)]
    _, verdicts = run_both(nodes, pods, filler, gang=([1, 1, 1], [3, 3, 3]))
    assert verdicts == [(None, ())] * 3


def test_gang_preempts_when_whole_quorum_has_victims():
    nodes = [node_d("n0", cpu="2"), node_d("n1", cpu="2")]
    filler = [pod_d("f0", "1800m", priority=1, node="n0"),
              pod_d("f1", "1800m", priority=1, node="n1")]
    pods = [pod_d(f"g{i}", "1500m", priority=100) for i in range(2)]
    _, verdicts = run_both(nodes, pods, filler, gang=([1, 1], [2, 2]))
    assert sorted(v[0] for v in verdicts) == ["n0", "n1"]


@pytest.mark.parametrize("seed", range(6))
def test_randomized_oracle_parity(seed):
    """tests/test_preemption.py's random priorities, requests, filler
    layouts and PDB bits, through both packages and the oracle."""
    rng = np.random.RandomState(1000 + seed)
    n_nodes = 6
    nodes = [node_d(f"n{i}", cpu=str(rng.randint(2, 5))) for i in range(n_nodes)]
    filler = [pod_d(f"f{i}", f"{int(rng.randint(2, 16)) * 100}m",
                    priority=int(rng.randint(0, 6)), node=f"n{rng.randint(n_nodes)}")
              for i in range(rng.randint(4, 14))]
    protected = frozenset(f["metadata"]["name"] for f in filler if rng.rand() < 0.25)
    pods = [pod_d(f"p{i}", f"{int(rng.randint(4, 24)) * 100}m",
                  priority=int(rng.randint(0, 12)))
            for i in range(rng.randint(2, 8))]
    _, verdicts = run_both(nodes, pods, filler,
                           evictable=lambda p: p.metadata.name not in protected)
    for _node, victims in verdicts:
        assert not any(k.split("/", 1)[1] in protected for k in victims)


@pytest.mark.parametrize("case", ["protected_first", "taken_first"])
def test_slot_ahead_of_a_candidate_hides_it_as_in_the_reference(case):
    """The reference's k counts slots, not candidates: a protected or taken
    slot ahead of a candidate frees nothing at its k, so the node reports
    no set where the serial oracle evicts the later candidate. The port
    equals the reference (and so differs from the oracle) there."""
    nodes = [node_d("n0")]
    if case == "protected_first":
        filler = [pod_d("fa", "1800m", priority=0, node="n0"),
                  pod_d("fb", "1800m", priority=1, node="n0")]
        pods = [pod_d("hi", "2000m", priority=100)]
        evictable = lambda p: p.metadata.name != "fa"  # noqa: E731
        want = ([-1], [0])
    else:
        filler = [pod_d("fa", "1900m", node="n0"), pod_d("fb", "1900m", node="n0")]
        pods = [pod_d("h1", "2000m", priority=100), pod_d("h2", "2000m", priority=100)]
        evictable = None
        want = ([0, -1], [1, 0])
    got, plain, name_of, _, _ = port_side(nodes, pods, filler, evictable)
    jres, jname_of, by_name, _, _ = jax_side(nodes, pods, filler, evictable)
    assert_equal_to_jax(got, plain, name_of, jres, jname_of, len(pods))
    assert (got.preempt_node[:len(pods)].tolist(), got.victim_count[:len(pods)].tolist()) == want
    _, verdicts = oracle(nodes, pods, filler, by_name)
    assert verdicts[-1][0] == "n0"


def test_fractional_mib_requests_equal_the_reference():
    """Memory requests that are not whole MiB (odd byte counts of ~1e9: each
    request already rounded to f32, their sums rounding again) through both
    packages: the port's left-to-right sums of the victims' requests give
    the reference's verdicts and ledgers, memory deciding some fits."""
    nodes = [node_d(f"n{i}", cpu="16", mem="4000000000") for i in range(4)]
    filler = [pod_d(f"f{i}", "1000m", mem=f"{999999937 + 7 * i}", priority=i % 3,
                    node=f"n{i % 4}") for i in range(12)]
    pods = [pod_d(f"p{i}", "1500m", mem=f"{1100000001 + 3 * i}", priority=5 + i)
            for i in range(6)]
    got, plain, name_of, slots, host = port_side(nodes, pods, filler)
    want, jname_of, _by_name, jslots, jvictims = jax_side(nodes, pods, filler)
    assert_equal_to_jax(got, plain, name_of, want, jname_of, 6)
    assert_tables_equal(host, slots, name_of, jvictims, jslots, jname_of)
    assert (host.req[:4, :3, 2] != np.round(host.req[:4, :3, 2])).all()
    assert (got.preempt_node[:6] >= 0).all() and (got.victim_count[:6] > 0).all()


# ---- neutrality ----

def _priority_cluster(kind, seed):
    """(port state, port batch, JAX state, JAX batch, JAX flags) of one
    build's batch with priorities written on both sides."""
    rng = np.random.RandomState(300 + seed)
    if kind == "spread":
        from tests import test_torch_spread as ts
        nodes, pods = ts.spread_cluster(rng, 16, 12)
        (s, b, _), (js, jb, jt) = ts.encode_both(nodes, pods)
    elif kind == "interpod":
        from tests import test_torch_interpod as ti
        nodes, pods, _ = ti.interpod_cluster(rng, 16, 12)
        (s, b, _), (js, jb, jt) = ti.encode_both(nodes, pods)
    else:
        nodes, pods = random_cluster(rng, 16, 12)
        s, b, _ = encode_cluster([obj.Node.from_dict(d) for d in nodes],
                                 [obj.Pod.from_dict(d) for d in pods], CAPS)
        js, jb, jt = j_encode_cluster([jobj.Node.from_dict(d) for d in nodes],
                                      [jobj.Pod.from_dict(d) for d in pods], JCAPS)
        if kind == "gang":
            for x in (b, jb):
                x.gang_id[:12] = np.repeat([1, 0, 2, 3], 3)
                x.gang_min[:12] = np.repeat([3, 0, 2, 3], 3)
    prio = rng.randint(-5, 50, size=12).astype(np.int32)
    b.priority[:12] = jb.priority[:12] = prio
    return s, b, js, jb, jsolver.batch_flags(jb, 12, jt)


@pytest.mark.parametrize("kind", ["main", "spread", "interpod", "gang"])
def test_priority_batch_without_victims_equals_reference(kind):
    s, b, js, jb, jflags = _priority_cluster(kind, 0)
    assert jflags.preempt and (jflags.gang == (kind == "gang"))
    got = schedule_batch(state_from_numpy(s, "cpu"), batch_from_numpy(b, "cpu"), 7)
    want = jax_solve(js, jb, 7, jflags)
    for name in ("assignments", "scores", "feasible_counts", "new_requested",
                 "new_nonzero", "preempt_node", "victim_count"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert int(got.rr_end) == rr_from_numpy(want.rr_end)
    assert (got.preempt_node == -1).all()


def test_priority_free_batch_unchanged_by_a_victim_table():
    nodes = [node_d(f"n{i}", cpu="2") for i in range(4)]
    filler = [pod_d("f0", "1800m", node="n0")]
    pods = [pod_d(f"p{i}", c) for i, c in enumerate(["500m", "1", "1500m", "250m", "2"])]
    db = StateDB(CAPS, device="cpu")
    for d in nodes:
        db.upsert_node(obj.Node.from_dict(d))
    db.add_pod(obj.Pod.from_dict(filler[0]))
    host, _ = build_victim_table(db)
    state = db.flush()
    batch = batch_from_numpy(encode_pods([obj.Pod.from_dict(d) for d in pods],
                                         CAPS, db.table), "cpu")
    with_table = schedule_batch(state, batch, 0, victims=victims_from_numpy(host, "cpu"))
    without = schedule_batch(state, batch, 0)
    for field in dataclasses.fields(with_table):
        a, b = getattr(with_table, field.name), getattr(without, field.name)
        assert (a is None and b is None) or torch.equal(a, b), field.name
    want, jname_of, *_ = jax_side(nodes, pods, filler)
    assert names(with_table.assignments, db.table.name_of, 5) == names(
        want.assignments, jname_of, 5)
    assert (with_table.preempt_node == -1).all()


# ---- the host half ----

@pytest.mark.parametrize("seed", range(3))
def test_victim_table_from_statedb_equals_reference(seed):
    """build_victim_table on the port's StateDB (pods bound through add_pod
    and through a committed batch, some removed) against JAX's on a JAX
    StateDB with the same pods."""
    rng = np.random.RandomState(70 + seed)
    nodes = [node_d(f"n{i}", cpu="8", pods="40") for i in range(10)]
    bound = [pod_d(f"b{i}", f"{rng.randint(1, 9) * 100}m", mem=f"{rng.randint(1, 5) * 128}Mi",
                   priority=int(rng.randint(-3, 4)), node=f"n{rng.randint(9)}")
             for i in range(60)]
    gone = {f"default/b{i}" for i in rng.choice(60, 6, replace=False)}
    protected = {f"b{i}" for i in rng.choice(60, 10, replace=False)}
    ev = lambda p: p.metadata.name not in protected  # noqa: E731
    db, jdb = StateDB(CAPS, device="cpu"), JStateDB(JCAPS)
    for d in nodes:
        db.upsert_node(obj.Node.from_dict(d))
        jdb.upsert_node(jobj.Node.from_dict(d))
    jpods = {}
    for d in bound:
        db.add_pod(obj.Pod.from_dict(d))
        jp = jobj.Pod.from_dict(d)
        jdb.add_pod(jp)
        jpods[jp.key] = jp
    for key in gone:
        db.remove_pod(key)
        jdb.remove_pod(key)
    host, slots = build_victim_table(db, evictable=ev)
    want, jslots = j_build_victim_table(jdb, jpods, evictable=ev)
    assert_tables_equal(host, slots, db.table.name_of, want, jslots, jdb.table.name_of)
    # a table with nothing evictable
    assert build_victim_table(db, evictable=lambda p: False)[0] is None


def test_encoder_priority_column_equals_reference():
    pods = [pod_d(f"p{i}", "100m", priority=p)
            for i, p in enumerate([0, 7, -3, 2_000_000_000, -2_000_000_000])]
    mine = encode_cluster([], [obj.Pod.from_dict(d) for d in pods], CAPS)[1]
    ref = j_encode_cluster([], [jobj.Pod.from_dict(d) for d in pods], JCAPS)[1]
    np.testing.assert_array_equal(mine.priority, ref.priority)
    assert mine.priority[:5].tolist() == [0, 7, -3, 2_000_000_000, -2_000_000_000]


def test_scheduler_verdicts_removals_and_the_wave_landing():
    """The preemption cell's shape at 12 nodes: two filler pods a node at
    priority 0, a wave at priority 1000 that fits only after an eviction.
    The Scheduler's verdicts equal JAX's on the same cluster, resolved with
    the reference's resolve_victims; the caller removes the victims, and
    the wave lands where JAX places it."""
    n_nodes, n_wave = 12, 9
    nodes = [node_d(f"node-{i}") for i in range(n_nodes)]
    filler = [pod_d(f"filler-{i}", "1900m", mem="256Mi", node=f"node-{i // 2}")
              for i in range(2 * n_nodes)]
    wave = [pod_d(f"crit-{i}", "2", mem="512Mi", priority=1000) for i in range(n_wave)]
    sched = Scheduler(CAPS, device="cpu")
    sched.add_nodes([obj.Node.from_dict(d) for d in nodes])
    for d in filler:
        assert sched.add_pod(obj.Pod.from_dict(d))
    wave_pods = [obj.Pod.from_dict(d) for d in wave]
    assert set(sched.schedule(wave_pods).values()) == {None}
    want, jname_of, _by_name, jslots, _ = jax_side(nodes, wave, filler)
    taken: set = set()
    expect = {}
    for i, d in enumerate(wave):
        row = int(want.preempt_node[i])
        keys = j_resolve_victims(jslots, row, int(want.victim_count[i]), 1000, taken)
        expect[f"default/{d['metadata']['name']}"] = (jname_of[row], keys)
    assert sched.preemptions == expect
    victims = [k for _node, keys in sched.preemptions.values() for k in keys]
    assert len(victims) == len(set(victims)) == n_wave   # k = 1 each, disjoint
    for key in victims:
        sched.remove_pod(key)
    placed = sched.schedule(wave_pods)
    assert None not in placed.values()
    assert sched.preemptions == {}
    # JAX on the cluster without the victims, from the first batch's rr
    left = [d for d in filler if f"default/{d['metadata']['name']}" not in set(victims)]
    jn = [jobj.Node.from_dict(d) for d in nodes]
    js, jb, jt = j_encode_cluster(jn, [jobj.Pod.from_dict(d) for d in wave], JCAPS,
                                  assigned_pods=[jobj.Pod.from_dict(d) for d in left])
    again = jax_solve(js, jb, rr_from_numpy(want.rr_end),
                      jsolver.batch_flags(jb, n_wave, jt))
    assert list(placed.values()) == names(again.assignments, jt.name_of, n_wave)


def test_scheduler_gang_groups_preempt_all_or_nothing():
    """A group of 3 at quorum 3, with two evictable victims in the cluster,
    gets no verdicts and names no victim; a group of 2 then gets both."""
    from kubernetes_tpu_torch.gang import GROUP_MIN_ANNOTATION, GROUP_NAME_ANNOTATION

    def member(name, group, quorum):
        d = pod_d(name, "1500m", priority=100)
        d["metadata"]["annotations"] = {GROUP_NAME_ANNOTATION: group,
                                        GROUP_MIN_ANNOTATION: str(quorum)}
        return obj.Pod.from_dict(d)

    sched = Scheduler(CAPS, device="cpu")
    sched.add_nodes([obj.Node.from_dict(node_d(f"n{i}", cpu="2")) for i in range(2)])
    for i in range(2):
        sched.add_pod(obj.Pod.from_dict(pod_d(f"f{i}", "1800m", priority=1, node=f"n{i}")))
    out = sched.schedule([member(f"g{i}", "big", 3) for i in range(3)])
    assert set(out.values()) == {None} and sched.preemptions == {}
    assert sched.gang_reverted == 1
    out = sched.schedule([member(f"s{i}", "small", 2) for i in range(2)])
    assert set(out.values()) == {None}
    assert sorted(node for node, _ in sched.preemptions.values()) == ["n0", "n1"]
    assert sorted(k for _, keys in sched.preemptions.values() for k in keys) == [
        "default/f0", "default/f1"]


def test_scheduler_claims_victims_once_across_chunks():
    """A wave of 20 on 12 full nodes in batches of 16: the first chunk's 12
    verdicts take one filler a node; the second chunk's table leaves those
    out, so its 4 pods name the other fillers of the first 4 nodes, and no
    victim is named twice in the call."""
    sched = Scheduler(CAPS, device="cpu")
    sched.add_nodes([obj.Node.from_dict(node_d(f"n{i:02d}")) for i in range(12)])
    for i in range(24):
        sched.add_pod(obj.Pod.from_dict(pod_d(f"f{i:02d}", "1900m", node=f"n{i // 2:02d}")))
    wave = [obj.Pod.from_dict(pod_d(f"w{i:02d}", "2", priority=10)) for i in range(20)]
    assert set(sched.schedule(wave).values()) == {None}
    victims = [k for _node, keys in sched.preemptions.values() for k in keys]
    assert len(sched.preemptions) == 16 and len(set(victims)) == 16
    second = sorted(sched.preemptions[f"default/w{i:02d}"] for i in range(16, 20))
    assert second == [(f"n{j:02d}", [f"default/f{2 * j + 1:02d}"]) for j in range(4)]


def test_scheduler_without_preemption_places_priority_pods():
    sched = Scheduler(CAPS, device="cpu", enable_preemption=False)
    sched.add_nodes([obj.Node.from_dict(node_d("n0", cpu="2"))])
    sched.add_pod(obj.Pod.from_dict(pod_d("f0", "1800m", node="n0")))
    out = sched.schedule([obj.Pod.from_dict(pod_d("a", "100m", priority=5)),
                          obj.Pod.from_dict(pod_d("b", "1500m", priority=5))])
    assert out == {"default/a": "n0", "default/b": None}
    assert sched.preemptions == {}


# ---- the pass on its own ----

def _post_scan_inputs(rng, n, p, s, gang=False):
    """Random post-scan operands: ledgers near full, static rows with holes,
    victims with priorities, holes in `ok`, requests in milli-cores and
    MiB, and (gang) runs of groups with gaps."""
    r = 6
    alloc = np.zeros((n, r), np.float32)
    alloc[:, 0] = rng.randint(3, 12, n)
    alloc[:, 1] = rng.choice([2000, 4000], n)
    alloc[:, 2] = rng.choice([4096, 8192], n)
    alloc[:, 5] = rng.choice([0, 100], n)
    alloc[:, 4] = 200
    base = alloc * rng.uniform(0.6, 1.0, (n, r)).astype(np.float32)
    base = np.floor(base)
    masked = np.where(rng.rand(p, n) < 0.8, 0.0, -np.inf).astype(np.float32)
    req = np.zeros((p, r), np.float32)
    req[:, 0] = 1
    req[:, 1] = rng.choice([0, 500, 1000, 2000], p)
    req[:, 2] = rng.choice([0, 256, 1024], p)
    req[:, 4] = rng.choice([0, 0, 50], p)
    prio = rng.randint(0, 8, p).astype(np.int32)
    part = rng.rand(p) < 0.8
    gid = np.zeros(p, np.int32)
    if gang:
        gid = np.repeat(np.arange(1, p // 4 + 2), 4)[:p].astype(np.int32)
        gid[rng.rand(p) < 0.2] = 0
    v_prio = np.sort(rng.randint(0, 8, (n, s)), 1).astype(np.int32)
    v_prio[rng.rand(n, s) < 0.2] = np.iinfo(np.int32).max
    v_prio = np.sort(v_prio, 1)
    v_req = np.zeros((n, s, r), np.float32)
    v_req[:, :, 0] = 1
    v_req[:, :, 1] = rng.choice([100, 500, 900], (n, s))
    v_req[:, :, 2] = rng.choice([128, 512], (n, s))
    v_ok = (rng.rand(n, s) < 0.85) & (v_prio < np.iinfo(np.int32).max)
    t = torch.from_numpy
    return (t(alloc), t(base), t(masked), t(req), t(prio), t(part), t(gid),
            VictimTable(prio=t(v_prio), req=t(v_req), ok=t(v_ok)))


@pytest.mark.parametrize("gang", [False, True], ids=["plain", "gang"])
def test_wrapper_on_cpu_is_the_plain_pass_and_matches_reference(gang):
    """The wrapper on CPU tensors is the plain pass (no launch counted), and
    the plain pass equals JAX _preemption_pass on the same post-scan
    operands (through schedule_batch's internals: a batch built so the scan
    places nobody is not needed; the pass is called directly)."""
    from kubernetes_tpu.ops.solver import VictimTable as JVictimTable
    from kubernetes_tpu.ops.solver import _preemption_pass

    rng = np.random.RandomState(11 + gang)
    n, p, s = 40, 24, 8
    args = _post_scan_inputs(rng, n, p, s, gang)
    alloc, base, masked, req, prio, part, gid, victims = args
    launches = preemption_pass.launches
    got = preemption_pass(*args, gang)
    assert preemption_pass.launches == launches
    plain = preemption_pass_plain(*args, gang)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)

    def jax_pass(a, valid, rq, pr, g, ms, b, vp, vr, vo):
        state = SimpleNamespace(allocatable=a)
        batch = SimpleNamespace(valid=valid, requests=rq, priority=pr, gang_id=g)
        return _preemption_pass(state, batch, ms, jax.numpy.full((p,), -1), b,
                                JVictimTable(prio=vp, req=vr, ok=vo), gang)

    want = jax.jit(jax_pass)(*(x.numpy() for x in (
        alloc, part, req, prio, gid, masked, base, victims.prio, victims.req,
        victims.ok)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert (got[0] >= 0).any() and (got[0] < 0).any()


def test_plain_pass_tally_counts_fit_checks():
    rng = np.random.RandomState(3)
    args = _post_scan_inputs(rng, 20, 10, 4)
    tally = {}
    preemption_pass_plain(*args, False, tally=tally)
    s_ok = (args[2] > float("-inf"))[args[5]].sum()
    assert s_ok <= tally["fits"] <= s_ok * 5


# ---- the preemption cell at a small size ----

def test_preemption_cell_traffic_at_a_small_size():
    """perf/harness.py's preemption drill: fillers, the wave's verdicts,
    the caller's removals, the wave landing; and the mixed and gang
    variants' tables and batches the card holds kernel 3 on."""
    r = harness.run_preemption(24, device="cpu")
    assert r.wave == 6 and r.verdicts == 6 and r.bound_wave == 6
    assert r.victims == 6 and set(r.victim_counts) <= {1, 2}
    for variant, n_nodes in (("mixed", 24), ("gang", 64)):
        inputs = harness.preemption_pass_inputs(
            *harness.preemption_cluster(n_nodes, variant, device="cpu"))
        node, count = preemption_pass_plain(*inputs.args(), inputs.use_gang)
        assert (node >= 0).any()
        if variant == "gang":
            assert (node < 0).any() and inputs.use_gang


@pytest.mark.parametrize("variant", ["uniform", "mixed", "gang"])
def test_harness_pass_inputs_are_the_operands_the_driver_passes(variant, monkeypatch):
    """perf/harness.py `preemption_pass_inputs` (which the card holds
    kernel 3 on) gives exactly the operands `Scheduler.schedule` hands the
    pass for the same wave, taken from the driver's own `prepare_chunk`."""
    from kubernetes_tpu_torch.ops import solver as solver_mod

    inputs = harness.preemption_pass_inputs(
        *harness.preemption_cluster(64, variant, device="cpu"))
    seen = []
    plain = solver_mod.preemption_pass

    def recording(*args):
        seen.append(args)
        return plain(*args)

    monkeypatch.setattr(solver_mod, "preemption_pass", recording)
    sched, wave = harness.preemption_cluster(64, variant, device="cpu")
    sched.schedule(wave)
    got = seen[0]
    want = (*inputs.args(), inputs.use_gang)
    assert len(got) == len(want) and got[-1] == want[-1]
    for a, b in zip(got[:-2] + tuple(dataclasses.astuple(got[-2])),
                    want[:-2] + tuple(dataclasses.astuple(want[-2]))):
        assert torch.equal(a, b)


# ---- the normalization flag's weight limit ----

@pytest.mark.parametrize("weight, ok", [(65535.0, True), (65536.0, False),
                                        (1.5, False), (0.0, True)])
def test_norm_inputs_refuses_weights_the_kernel_traps_on(weight, ok):
    p, tp, ur = 3, 4, 8
    pref_onehot = torch.zeros((p, tp, ur))
    pref_onehot[:, 0, 1] = 1.0
    pref_weight = torch.zeros((p, tp))
    pref_weight[1, 0] = weight
    call = lambda: scan_ops.norm_inputs(  # noqa: E731
        1.0, 1.0, torch.zeros((5, 4)), torch.zeros((5, ur)), torch.zeros((p, 4)),
        pref_onehot, pref_weight)
    if ok:
        assert call().pod_weights[1, 0] == weight
    else:
        with pytest.raises(ValueError, match=f"weight {weight}"):
            call()
