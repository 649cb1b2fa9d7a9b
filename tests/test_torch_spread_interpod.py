"""kubernetes_tpu_torch with SelectorSpread and inter-pod (anti-)affinity in
one batch, against the reference package on the CPU: the plain scan adds a
placed pod's match row to the pod-selector ledger once, `schedule_batch`
with both the spread and the ipa gate equals JAX `schedule_batch` (the
spread+interpod build's plain version), and a `Scheduler` whose cluster
already holds a pod with a required anti-affinity term schedules
Service-selected pods batch after batch as JAX does, its StateDB's ledgers
equal to JAX's. Every comparison is exact: counts, scores and ledgers are
integer-valued f32."""

from dataclasses import fields, replace

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
from kubernetes_tpu.state import Capacities as JCaps  # noqa: E402
from kubernetes_tpu.state import encode_cluster as j_encode_cluster  # noqa: E402
from kubernetes_tpu.state.context import EncodeContext as JContext  # noqa: E402
from kubernetes_tpu.state.encode_cache import EncodeCache as JEncodeCache  # noqa: E402
from kubernetes_tpu.state.pod_batch import empty_batch as j_empty_batch  # noqa: E402
from kubernetes_tpu.state.pod_batch import pack_batch as j_pack_batch  # noqa: E402
from kubernetes_tpu.state.pod_batch import unpack_batch as j_unpack_batch  # noqa: E402
from kubernetes_tpu.state.statedb import StateDB as JStateDB  # noqa: E402

from kubernetes_tpu_torch.api import objects as obj  # noqa: E402
from kubernetes_tpu_torch.models.policy import DEFAULT_POLICY  # noqa: E402
from kubernetes_tpu_torch.ops import solver  # noqa: E402
from kubernetes_tpu_torch.ops.assign_scan import (  # noqa: E402
    InterpodInputs,
    SpreadInputs,
    assign_scan_spread_interpod,
    assign_scan_spread_interpod_plain,
)
from kubernetes_tpu_torch.ops.solver import (  # noqa: E402
    schedule_batch,
    schedule_batch_plain,
)
from kubernetes_tpu_torch.perf import harness  # noqa: E402
from kubernetes_tpu_torch.scheduler import Scheduler  # noqa: E402
from kubernetes_tpu_torch.state import Capacities, encode_cluster  # noqa: E402
from kubernetes_tpu_torch.state.context import EncodeContext  # noqa: E402
from kubernetes_tpu_torch.state.convert import (  # noqa: E402
    batch_from_numpy,
    rr_from_numpy,
    state_from_numpy,
)
from kubernetes_tpu_torch.state.layout import TKEY_INVALID, TOPO_SPREAD_ZONE  # noqa: E402
from tests.test_torch_interpod import HOST, REGION, ZONE, interpod_cluster  # noqa: E402
from tests.test_torch_state import BATCH, random_cluster  # noqa: E402
from tests.test_torch_state import encode_both as encode_main  # noqa: E402

N_NODES, P = 128, 64
# random affinity pods intern many terms (as in test_torch_interpod)
CAPS = Capacities(num_nodes=N_NODES, batch_pods=P, term_universe=64)
JCAPS = JCaps(num_nodes=N_NODES, batch_pods=P, term_universe=64)
FIELDS = ("assignments", "scores", "feasible_counts", "new_requested",
          "new_nonzero", "new_podsel", "new_term")
LEDGERS = ("requested", "nonzero_requested", "podsel_count", "term_count",
           "topology", "term_q", "term_tkey", "term_weight", "term_kind",
           "term_poison")
# Services over two of interpod_cluster's three app groups: pods of the
# third (and of namespace "other") have no spread entry
SERVICES = [{"metadata": {"name": f"svc-{app}"}, "spec": {"selector": {"app": app}}}
            for app in ("web", "db")]
# the reference's flags for every batch of this file: the spread and ipa
# gates (svcanti rides spread; no policy here registers it). A gate the
# batch does not need is neutral, so one jit serves every batch
SPREAD_IPA = jsolver.BatchFlags(*(f in ("ipa", "spread", "svcanti") for f in (
    "ipa", "spread", "svcanti", "vol", "attach", "tt", "na", "ports", "gpu",
    "storage", "gang", "preempt")))
_JAX_SOLVE = jax.jit(lambda s, b, r: jsolver.schedule_batch(
    s, b, r, J_POLICY, flags=SPREAD_IPA))


def jax_solve(state, batch, rr, flags):
    """JAX schedule_batch with the batch's own gates, run as SPREAD_IPA."""
    assert all(getattr(SPREAD_IPA, f.name) for f in fields(flags)
               if getattr(flags, f.name))
    return _JAX_SOLVE(state, batch, np.uint32(rr))


def assert_same(got, want, msg=""):
    for name in FIELDS:
        np.testing.assert_array_equal(
            getattr(got, name).cpu().numpy(), np.asarray(getattr(want, name)),
            err_msg=f"{msg} {name}")
    assert int(got.rr_end) == rr_from_numpy(want.rr_end), msg


def _context(module, context_cls, services=SERVICES):
    svcs = [module.Service.from_dict(d) for d in services]
    return context_cls(
        get_services=lambda ns: [s for s in svcs if s.metadata.namespace == ns],
        get_rcs=lambda ns: [], get_rss=lambda ns: [], get_sss=lambda ns: [],
        list_pods=lambda ns: [])


# ---- (a) the plain scan adds a placed pod's rows once ----

def _one_node_inputs(n_pods):
    """n_pods pods that fit only node 2 of 4, each matching selectors 0 and
    2 and carrying term 1; spread entry 0; one zone."""
    n, uq, ue = 4, 3, 2
    t = torch.tensor
    ms = torch.full((n_pods, n), float("-inf"))
    ms[:, 2] = 0.0
    reqs = torch.zeros((n_pods, 6))
    reqs[:, 0], reqs[:, 1], reqs[:, 2] = 1.0, 100.0, 128.0
    nz_reqs = reqs[:, 1:3].clone()
    alloc = torch.zeros((n, 6))
    alloc[:, 0], alloc[:, 1], alloc[:, 2] = 110.0, 4000.0, 8192.0
    args = (ms, reqs, nz_reqs, alloc, torch.zeros((n, 6)), torch.zeros((n, 2)),
            0, 1.0, 1.0)
    podsel = torch.zeros((n, uq))
    podsel[1, 0] = 2.0
    topo = torch.full((n, 8), -1, dtype=torch.int32)
    topo[:, 0] = torch.arange(n, dtype=torch.int32)
    topo[:, TOPO_SPREAD_ZONE] = 0
    match = t([[1.0, 0.0, 1.0]]).repeat(n_pods, 1)
    carry = t([[0.0, 1.0]]).repeat(n_pods, 1)
    none = torch.full((n_pods, 1), -1, dtype=torch.int32)
    ip = InterpodInputs(
        use_ipa=True, w_ip=1.0, hard_w=1.0, pod_matches_q=match,
        pod_carries_e=carry, paff_q=none, paff_tkey=torch.zeros_like(none),
        panti_q=none, panti_tkey=torch.zeros_like(none), ppref_q=none,
        ppref_tkey=torch.zeros_like(none), ppref_w=torch.zeros((n_pods, 1)),
        ipaff_fail=torch.zeros(n_pods, dtype=torch.bool), podsel_count=podsel,
        term_count=torch.zeros((n, ue)), topology=topo,
        term_q=t([0, 2], dtype=torch.int32), term_tkey=t([0, 1], dtype=torch.int32),
        term_kind=t([2, 2], dtype=torch.int32), term_weight=t([3.0, 5.0]),
        term_poison=torch.zeros(ue, dtype=torch.bool), domain_universe=4)
    sp = SpreadInputs(w_ss=1.0, spread_q=torch.zeros(n_pods, dtype=torch.int32),
                      pod_matches_q=match, podsel_count=podsel, topology=topo,
                      domain_universe=4, zones=1)
    return args, sp, ip


@pytest.mark.parametrize("n_pods", [1, 3])
def test_plain_scan_adds_a_placed_pods_match_row_once(n_pods):
    args, sp, ip = _one_node_inputs(n_pods)
    got = assign_scan_spread_interpod_plain(*args, sp, ip)
    assert got.assignments.tolist() == [2] * n_pods
    want_podsel = sp.podsel_count.clone()
    want_podsel[2] += n_pods * sp.pod_matches_q[0]
    torch.testing.assert_close(got.new_podsel, want_podsel, rtol=0, atol=0)
    want_term = ip.term_count.clone()
    want_term[2] += n_pods * ip.pod_carries_e[0]
    torch.testing.assert_close(got.new_term, want_term, rtol=0, atol=0)
    # the inputs are not modified, and the wrapper on CPU tensors is the
    # plain version
    assert float(sp.podsel_count.sum()) == 2.0
    wrapped = assign_scan_spread_interpod(*args, sp, ip)
    for name in FIELDS[:-2] + ("new_podsel", "new_term"):
        assert torch.equal(getattr(wrapped, name), getattr(got, name)), name


def test_wrapper_refuses_two_ledgers():
    args, sp, ip = _one_node_inputs(2)
    for change in ({"podsel_count": sp.podsel_count + 1.0},
                   {"domain_universe": 8}):
        with pytest.raises(ValueError, match="different"):
            assign_scan_spread_interpod(*args, replace(sp, **change), ip)


# ---- (b) schedule_batch with both gates ----

def _random_ledgers(rng, state, jstate, table):
    """The same batch-start pod-selector and carried-term counts on both
    sides; carriers only of terms that do not reject every node (poisoned
    or unkeyed required anti terms)."""
    podsel = rng.randint(0, 3, state.podsel_count.shape).astype(np.float32)
    podsel[rng.rand(N_NODES) < 0.5] = 0.0
    term = rng.randint(0, 2, state.term_count.shape).astype(np.float32)
    term[rng.rand(*term.shape) < 0.85] = 0.0
    live = ~state.term_poison & (state.term_tkey != TKEY_INVALID)
    term[:, ~live] = 0.0
    term[:, len(table.terms):] = 0.0
    state.podsel_count[...] = podsel
    state.term_count[...] = term
    return jstate.replace(podsel_count=podsel.copy(), term_count=term.copy())


def three_zones(nodes):
    """interpod_cluster's nodes in one region: a node with a zone label is
    in region r0, one without has neither, so GetZoneKey has 3 zones."""
    for d in nodes:
        labels = d["metadata"]["labels"]
        labels.pop(REGION, None)
        if ZONE in labels:
            labels[REGION] = "r0"
    return nodes


@pytest.mark.parametrize("seed", range(3))
def test_schedule_batch_with_spread_and_ipa_matches_reference(seed):
    rng = np.random.RandomState(2100 + seed)
    nodes, pods, _ = interpod_cluster(rng, 96, P - seed, p_none=0.4)
    three_zones(nodes)
    state, batch, table = encode_cluster(
        [obj.Node.from_dict(d) for d in nodes], [obj.Pod.from_dict(d) for d in pods],
        CAPS, ctx=_context(obj, EncodeContext))
    jstate, jbatch, jtable = j_encode_cluster(
        [jobj.Node.from_dict(d) for d in nodes], [jobj.Pod.from_dict(d) for d in pods],
        JCAPS, ctx=_context(jobj, JContext))
    jstate = _random_ledgers(rng, state, jstate, table)
    flags = jsolver.batch_flags(jbatch, len(pods), jtable)
    assert flags.spread and flags.ipa
    n = len(pods)
    own_terms = ((batch.paff_q[:n] >= 0).any(1) | (batch.panti_q[:n] >= 0).any(1)
                 | (batch.ppref_q[:n] >= 0).any(1))
    entry = batch.spread_q[:n] >= 0
    # pods of each kind: both gates, spread alone, own terms alone, neither
    for kind in (entry & own_terms, entry & ~own_terms, ~entry & own_terms,
                 ~entry & ~own_terms):
        assert kind.any()
    assert len(set(state.topology[:, TOPO_SPREAD_ZONE].tolist()) - {-1}) == 3
    rr = [0, 9, 2**32 - 4][seed]
    want = jax_solve(jstate, jbatch, rr, flags)
    dstate, dbatch = state_from_numpy(state, "cpu"), batch_from_numpy(batch, "cpu")
    got = schedule_batch(dstate, dbatch, rr, caps=CAPS)
    assert_same(got, want)
    assert_same(schedule_batch_plain(dstate, dbatch, rr, caps=CAPS), want, "plain")
    placed = np.asarray(want.assignments)[:n]
    assert (placed >= 0).sum() > n // 3
    assert not np.array_equal(np.asarray(want.new_podsel), state.podsel_count)
    assert not np.array_equal(np.asarray(want.new_term), state.term_count)


def test_the_formerly_refused_batch_matches_reference():
    """The batch the solver refused while it built SelectorSpread and
    inter-pod affinity apart: random_cluster's batch with pod 0 given a
    spread entry and pod 1 a required affinity term."""
    rng = np.random.RandomState(5)
    nodes, pods = random_cluster(rng, 24, BATCH)
    (state, batch, _), (jstate, jbatch, jtable) = encode_main(nodes, pods)
    for b in (batch, jbatch):
        b.spread_q[0] = 0
        b.paff_q[1, 0] = 0
    flags = jsolver.batch_flags(jbatch, len(pods), jtable)
    assert flags.spread and flags.ipa
    want = jax_solve(jstate, jbatch, 3, flags)
    dstate, dbatch = state_from_numpy(state, "cpu"), batch_from_numpy(batch, "cpu")
    got = schedule_batch(dstate, dbatch, 3)
    assert_same(got, want)
    assert int(want.assignments[1]) >= 0 or int(want.feasible_counts[1]) == 0


def test_gang_with_both_names_every_gate():
    """The batch the solver once refused, naming the spread, ipa and gang
    gates, since the gang carry in the spread+interpod build: it equals
    JAX's with those gates."""
    rng = np.random.RandomState(5)
    nodes, pods = random_cluster(rng, 24, BATCH)
    (state, batch, _), (jstate, jbatch, jtable) = encode_main(nodes, pods)
    for b in (batch, jbatch):
        b.spread_q[0] = 0
        b.paff_q[1, 0] = 0
        b.gang_id[:2], b.gang_min[:2] = 1, 2
    flags = jsolver.batch_flags(jbatch, len(pods), jtable)
    assert flags.spread and flags.ipa and flags.gang
    want = jax.jit(lambda s, b, r: jsolver.schedule_batch(
        s, b, r, J_POLICY, flags=flags))(jstate, jbatch, np.uint32(0))
    got = schedule_batch(state_from_numpy(state, "cpu"), batch_from_numpy(batch, "cpu"), 0)
    assert_same(got, want)


# ---- (c) the driver: a carried anti term, then Service-selected pods ----

class _JaxChain:
    """The reference package driven as this package's Scheduler drives its
    own: Services in the encode context, encode cache, re-encode on an
    epoch move, StateDB flush, schedule_batch, commit."""

    def __init__(self, nodes):
        self.bound: list = []
        svcs = [jobj.Service.from_dict(d) for d in SERVICES]
        ctx = JContext(
            get_services=lambda ns: [s for s in svcs if s.metadata.namespace == ns],
            get_rcs=lambda ns: [], get_rss=lambda ns: [], get_sss=lambda ns: [],
            list_pods=lambda ns: [p for p in self.bound
                                  if p.metadata.namespace == ns])
        self.db = JStateDB(JCAPS, volume_ctx=ctx)
        for d in nodes:
            self.db.upsert_node(jobj.Node.from_dict(d))
        self.cache = JEncodeCache(JCAPS, self.db.table, volume_ctx=ctx)
        self.rr = 0

    def add_pod(self, d, node):
        pod = jobj.Pod.from_dict(d)
        ok = self.db.add_pod(pod, node)
        if ok:
            self.bound.append(pod)
        return ok

    def schedule(self, pod_dicts):
        pods = [jobj.Pod.from_dict(d) for d in pod_dicts]
        fblob, iblob = j_pack_batch(j_empty_batch(JCAPS), JCAPS)
        epoch = self.db.table.pod_row_epoch
        for i, pod in enumerate(pods):
            self.cache.encode_packed_into(fblob, iblob, i, pod)
        if self.db.table.pod_row_epoch != epoch:
            for i, pod in enumerate(pods):
                self.cache.encode_packed_into(fblob, iblob, i, pod)
        batch = j_unpack_batch(fblob, iblob, JCAPS)
        flags = jsolver.batch_flags(batch, len(pods), self.db.table)
        res = jax_solve(self.db.flush(), batch, self.rr, flags)
        rows = np.asarray(res.assignments)
        names = [self.db.table.name_of[r] if r >= 0 else None
                 for r in rows[:len(pods)]]
        self.db.commit_batch(res, fblob, [(p, n, i) for i, (p, n)
                                          in enumerate(zip(pods, names)) if n])
        self.rr = rr_from_numpy(res.rr_end)
        return {p.key: n for p, n in zip(pods, names)}, res, flags


def assert_ledgers(db, jdb, msg=""):
    for name in LEDGERS:
        np.testing.assert_array_equal(getattr(db.host, name),
                                      np.asarray(getattr(jdb.host, name)),
                                      err_msg=f"{msg} host {name}")
    dev, jdev = db.flush(), jdb.flush()
    for name in LEDGERS:
        np.testing.assert_array_equal(getattr(dev, name).numpy(),
                                      np.asarray(getattr(jdev, name)),
                                      err_msg=f"{msg} device {name}")


# a bound pod with required hostname anti-affinity against app=web
GUARD = {"metadata": {"name": "guard", "namespace": "default",
                      "labels": {"app": "guard"}},
         "spec": {"containers": [{"name": "c", "resources": {"requests": {
             "cpu": "100m", "memory": "128Mi"}}}],
                  "affinity": {"podAntiAffinity": {
                      "requiredDuringSchedulingIgnoredDuringExecution": [{
                          "labelSelector": {"matchLabels": {"app": "web"}},
                          "topologyKey": HOST}]}}}}


@pytest.mark.parametrize("seed", range(2))
def test_scheduler_with_a_carried_term_chains_service_pods_like_the_reference(seed):
    rng = np.random.RandomState(2200 + seed)
    nodes = three_zones(interpod_cluster(rng, 48, 0)[0])
    # Service-selected pods, most without terms of their own (p_none 0.8)
    pods = interpod_cluster(rng, 1, 3 * P, p_none=0.8)[1]
    sched = Scheduler(CAPS, device="cpu")
    sched.add_nodes([obj.Node.from_dict(d) for d in nodes])
    for d in SERVICES:
        sched.add_service(obj.Service.from_dict(d))
    ref = _JaxChain(nodes)
    guard_node = nodes[int(rng.randint(len(nodes)))]["metadata"]["name"]
    assert sched.add_pod(obj.Pod.from_dict(GUARD), guard_node)
    assert ref.add_pod(GUARD, guard_node)
    assert sched.statedb.table.terms and sched.statedb.host.term_count.any()
    assert_ledgers(sched.statedb, ref.db, "bound")
    for k in range(3):
        chunk = pods[k * P:(k + 1) * P]
        got = sched.schedule([obj.Pod.from_dict(d) for d in chunk])
        want, res, flags = ref.schedule(chunk)
        assert flags.spread and flags.ipa, f"batch {k}"
        assert got == want, f"batch {k}"
        assert_same(sched.last_result, res, f"batch {k}")
        assert_ledgers(sched.statedb, ref.db, f"batch {k}")
        # no web pod shares the guard's node
        web = {f"{d['metadata']['namespace']}/{d['metadata']['name']}"
               for d in chunk if d["metadata"]["labels"]["app"] == "web"
               and d["metadata"]["namespace"] == "default"}
        assert guard_node not in {got[key] for key in web}
    assert sched.statedb.host.podsel_count.any()
    assert sched.encode_cache.hits > 0


def test_harness_warms_and_runs_the_spread_interpod_traffic(monkeypatch):
    """warm() with Services and a pod mix with terms goes through the
    spread+interpod build before any clock starts, and the traffic runs
    through it batch after batch, every pod placed."""
    calls = []
    build = solver.assign_scan_spread_interpod

    def counting(*args):
        calls.append(args[0].shape)
        return build(*args)

    monkeypatch.setattr(solver, "assign_scan_spread_interpod", counting)
    caps = Capacities(num_nodes=64, batch_pods=64)
    harness.warm(caps, DEFAULT_POLICY, torch.device("cpu"), n_services=16,
                 pod_kwargs=harness.SPREAD_INTERPOD_PODS)
    assert len(calls) == 1
    res = harness.run_throughput(40, 192, caps=caps, node_kwargs={"zones": 3},
                                 pod_kwargs=harness.SPREAD_INTERPOD_PODS,
                                 device="cpu", n_services=16)
    assert res.scheduled == 192 and res.batches == 3
    assert len(calls) == 2 + res.batches   # run_throughput warms once more


# ---- (d) the CUDA build's combined exchange, modelled ----
#
# (The exchange as it stood before the build's redesign for Hopper; the
# redesigned build sends the same chunks, and tests/test_torch_si_redesign.py
# models them with the normalization flag's maxima too.)
#
# The spread+interpod build (csrc/assign_scan.cu) sends one cluster
# message a pod when the pod needs the SelectorSpread partial (spread_q >=
# 0: 1 + Z words in ceil((1 + Z) / 4) 16-byte chunks), the interpod (min,
# max) (one chunk), or both: warp 0's lane l sends chunks l // 16,
# l // 16 + 2, ... to block l % 16, and the receiving block's mbarrier is
# armed, before its wait, for 16 blocks' chunks of that pod. The model
# holds that every block receives each of its chunks exactly once, so the
# phase completes with the bytes it was armed for.

CLUSTER = 16


@pytest.mark.parametrize("zones", [0, 1, 3, 4, 31, 63, 64])
@pytest.mark.parametrize("need", ["spread", "interpod", "both"])
def test_combined_exchange_sends_each_chunk_once(zones, need):
    sp_chunks = (1 + zones + 3) // 4 if need != "interpod" else 0
    chunks = sp_chunks + (need != "spread")
    sent = {}
    for lane in range(32):
        for k in range(lane // CLUSTER, chunks, 32 // CLUSTER):
            key = (lane % CLUSTER, k)
            sent[key] = sent.get(key, 0) + 1
    assert sent == {(b, k): 1 for b in range(CLUSTER) for k in range(chunks)}
    armed = CLUSTER * 16 * chunks
    assert sum(16 * c for c in sent.values()) == armed
    # the interpod chunk lands in its own slot, after the spread chunks
    if need != "spread":
        assert (0, chunks - 1) in sent and chunks - 1 == sp_chunks
