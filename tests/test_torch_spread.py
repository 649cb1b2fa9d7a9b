"""kubernetes_tpu_torch's spread gate against the reference package on the
CPU: `selector_spread` (edge cases included), `schedule_batch` with the
spread gate (the spread build's plain version), the encoder's spreading
columns with Services and controllers, the encode cache's namespace and
labels fields and its generation, the driver's in-batch re-encode, the
StateDB's pod-selector ledger, and three chained `Scheduler` batches. Every
comparison is exact: scores and ledgers are integer-valued f32."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
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
from kubernetes_tpu.ops import interpod as jinterpod  # noqa: E402
from kubernetes_tpu.ops import solver as jsolver  # noqa: E402
from kubernetes_tpu.ops import spread as jspread  # noqa: E402
from kubernetes_tpu.state import Capacities as JCaps  # noqa: E402
from kubernetes_tpu.state import encode_cluster as j_encode_cluster  # noqa: E402
from kubernetes_tpu.state.context import EncodeContext as JContext  # noqa: E402
from kubernetes_tpu.state.encode_cache import EncodeCache as JEncodeCache  # noqa: E402
from kubernetes_tpu.state.pod_batch import empty_batch as j_empty_batch  # noqa: E402
from kubernetes_tpu.state.pod_batch import pack_batch as j_pack_batch  # noqa: E402
from kubernetes_tpu.state.pod_batch import unpack_batch as j_unpack_batch  # noqa: E402
from kubernetes_tpu.state.statedb import StateDB as JStateDB  # noqa: E402

from kubernetes_tpu_torch.api import objects as obj  # noqa: E402
from kubernetes_tpu_torch.ops.interpod import AffinityLedger  # noqa: E402
from kubernetes_tpu_torch.ops.solver import schedule_batch  # noqa: E402
from kubernetes_tpu_torch.ops.spread import selector_spread  # noqa: E402
from kubernetes_tpu_torch.scheduler import Scheduler, driver  # noqa: E402
from kubernetes_tpu_torch.state import Capacities, encode_cluster  # noqa: E402
from kubernetes_tpu_torch.state.context import EncodeContext  # noqa: E402
from kubernetes_tpu_torch.state.convert import (  # noqa: E402
    batch_from_numpy,
    rr_from_numpy,
    state_from_numpy,
)
from kubernetes_tpu_torch.state.encode_cache import EncodeCache  # noqa: E402
from kubernetes_tpu_torch.state.layout import TOPO_SPREAD_ZONE  # noqa: E402
from kubernetes_tpu_torch.state.pod_batch import (  # noqa: E402
    _layout,
    batch_flags,
    blob_col,
    empty_batch,
    encode_pods,
    pack_batch,
)
from tests.test_torch_state import random_cluster  # noqa: E402

N_NODES, P = 128, 64
CAPS = Capacities(num_nodes=N_NODES, batch_pods=P)
JCAPS = JCaps(num_nodes=N_NODES, batch_pods=P)
D = CAPS.domain_universe

# the workload objects: Services (a map selector, an empty map that
# selects every pod of its namespace, a nil selector that selects none), an
# RC, ReplicaSets (matchLabels, a matchExpressions parse error, no
# selector) and a StatefulSet; a pod labelled tier=web and app=a0 matches
# two of them (their union)
WORKLOADS = {
    "Service": [
        {"metadata": {"name": "svc-a0"}, "spec": {"selector": {"app": "a0"}}},
        {"metadata": {"name": "svc-a1"}, "spec": {"selector": {"app": "a1"}}},
        {"metadata": {"name": "svc-all", "namespace": "other"},
         "spec": {"selector": {}}},
        {"metadata": {"name": "svc-nil"}, "spec": {}},
    ],
    "ReplicationController": [
        {"metadata": {"name": "rc-a2"}, "spec": {"selector": {"app": "a2"}}},
    ],
    "ReplicaSet": [
        {"metadata": {"name": "rs-web"},
         "spec": {"selector": {"matchLabels": {"tier": "web"}}}},
        {"metadata": {"name": "rs-bad"}, "spec": {"selector": {"matchExpressions": [
            {"key": "app", "operator": "Like", "values": ["a3"]}]}}},
        {"metadata": {"name": "rs-none"}, "spec": {}},
    ],
    "StatefulSet": [
        {"metadata": {"name": "ss-a3"}, "spec": {"selector": {"matchExpressions": [
            {"key": "app", "operator": "In", "values": ["a3"]}]}}},
    ],
}


def _objects(module, kinds=WORKLOADS):
    """{kind: [object]} of one package."""
    return {kind: [getattr(module, kind).from_dict(d) for d in ds]
            for kind, ds in kinds.items()}


def _context(module, context_cls, bound=(), kinds=WORKLOADS):
    """An EncodeContext of one package over the workload objects and the
    bound pods `bound` (dicts)."""
    objs = _objects(module, kinds)
    pods = [module.Pod.from_dict(d) for d in bound]

    def by_ns(kind):
        return lambda ns: [o for o in objs.get(kind, ())
                           if o.metadata.namespace == ns]

    return context_cls(
        get_services=by_ns("Service"), get_rcs=by_ns("ReplicationController"),
        get_rss=by_ns("ReplicaSet"), get_sss=by_ns("StatefulSet"),
        list_pods=lambda ns: [p for p in pods if p.metadata.namespace == ns])


def spread_cluster(rng, n_nodes, n_pods, name="p"):
    """random_cluster's nodes (80% zoned, taints, conditions, tight
    capacities) and pods labelled app=a0..a3 (some tier=web, some
    label-less, some in namespace "other")."""
    nodes, pods = random_cluster(rng, n_nodes, n_pods)
    for i, d in enumerate(pods):
        meta = d["metadata"]
        meta["name"] = f"{name}{i}"
        u = rng.rand()
        if u < 0.1:
            meta["labels"] = {}
        else:
            meta["labels"] = {"app": f"a{rng.randint(4)}"}
            if rng.rand() < 0.3:
                meta["labels"]["tier"] = "web"
        if rng.rand() < 0.15:
            meta["namespace"] = "other"
    return nodes, pods


def encode_both(nodes, pods, bound=()):
    mine = encode_cluster([obj.Node.from_dict(d) for d in nodes],
                          [obj.Pod.from_dict(d) for d in pods], CAPS,
                          ctx=_context(obj, EncodeContext, bound))
    ref = j_encode_cluster([jobj.Node.from_dict(d) for d in nodes],
                           [jobj.Pod.from_dict(d) for d in pods], JCAPS,
                           ctx=_context(jobj, JContext, bound))
    return mine, ref


_JAX_SOLVE = {}


def jax_solve(state, batch, rr, flags):
    """JAX schedule_batch under DEFAULT_POLICY with `flags`, jitted once
    per flags value (the XLA static mask)."""
    fn = _JAX_SOLVE.get(flags)
    if fn is None:
        fn = _JAX_SOLVE[flags] = jax.jit(
            lambda s, b, r: jsolver.schedule_batch(s, b, r, J_POLICY,
                                                   flags=flags))
    return fn(state, batch, np.uint32(rr))


FIELDS = ("assignments", "scores", "feasible_counts", "new_requested",
          "new_nonzero", "new_podsel")


def assert_same(got, want, msg=""):
    for name in FIELDS:
        np.testing.assert_array_equal(
            getattr(got, name).cpu().numpy(), np.asarray(getattr(want, name)),
            err_msg=f"{msg} {name}")
    assert int(got.rr_end) == rr_from_numpy(want.rr_end), msg


# ---- (a) selector_spread ----

def _spread_inputs(rng, case):
    n = 96
    topo = np.full((n, CAPS.topology_slots), -1, np.int32)
    zone = rng.randint(0, 3, n)
    zone[rng.rand(n) < 0.2] = -1                  # nodes without a zone
    topo[:, TOPO_SPREAD_ZONE] = zone
    counts = rng.randint(0, 5, (n, CAPS.podsel_universe)).astype(np.float32)
    feasible = rng.rand(n) < 0.6
    q = 3
    if case == "no_feasible":
        feasible[:] = False
    elif case == "unzoned_feasible":   # have_zones False: node scores only
        feasible &= zone < 0
    elif case == "zero_zone_max":      # zoned feasible nodes all count 0
        counts[zone >= 0, q] = 0.0
    elif case == "zero_max":           # max_node == 0
        counts[:, q] = 0.0
    elif case == "no_entry":
        q = -1
    elif case == "one_zone":
        topo[:, TOPO_SPREAD_ZONE] = np.where(zone >= 0, 0, -1)
    return topo, counts, feasible, q


@pytest.mark.parametrize("case", ["random", "no_feasible", "unzoned_feasible",
                                  "zero_zone_max", "zero_max", "no_entry",
                                  "one_zone"])
@pytest.mark.parametrize("seed", range(2))
def test_selector_spread_matches_reference(case, seed):
    rng = np.random.RandomState(10 + seed)
    topo, counts, feasible, q = _spread_inputs(rng, case)
    want = jspread.selector_spread(
        SimpleNamespace(topology=jnp.asarray(topo)), jnp.int32(q),
        jinterpod.AffinityLedger(podsel_count=jnp.asarray(counts),
                                 total_q=jnp.asarray(counts.sum(0))),
        jnp.asarray(feasible), D)
    t = torch.from_numpy
    got = selector_spread(t(topo), torch.tensor(q, dtype=torch.int32),
                          AffinityLedger(t(counts), t(counts.sum(0))),
                          t(feasible), D)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.float32


# ---- (b) schedule_batch with the spread gate ----

@pytest.mark.parametrize("seed", range(3))
def test_schedule_batch_with_spread_matches_reference(seed, monkeypatch):
    monkeypatch.delenv("KTPU_PALLAS", raising=False)
    rng = np.random.RandomState(400 + seed)
    nodes, pods = spread_cluster(rng, 96, P - 3)
    (state, batch, table), (jstate, jbatch, jtable) = encode_both(nodes, pods)
    # a ledger some pods already count in, the same on both sides
    podsel = rng.randint(0, 3, state.podsel_count.shape).astype(np.float32)
    podsel[rng.rand(N_NODES) < 0.5] = 0.0
    state.podsel_count[...] = podsel
    jstate = jstate.replace(podsel_count=podsel.copy())
    flags = jsolver.batch_flags(jbatch, len(pods), jtable)
    assert flags.spread and flags.svcanti
    assert flags == jsolver.BatchFlags(*(f in ("spread", "svcanti")
                                         for f in ("ipa", "spread", "svcanti",
                                                   "vol", "attach", "tt", "na",
                                                   "ports", "gpu", "storage",
                                                   "gang", "preempt")))
    rr = [0, 7, 2**32 - 2][seed]
    want = jax_solve(jstate, jbatch, rr, flags)
    dstate, dbatch = state_from_numpy(state, "cpu"), batch_from_numpy(batch, "cpu")
    assert batch_flags(dstate, dbatch).spread
    got = schedule_batch(dstate, dbatch, rr, caps=CAPS)
    assert_same(got, want)
    assert (np.asarray(want.assignments) >= 0).sum() > P // 3
    assert not np.array_equal(np.asarray(want.new_podsel), podsel)


# ---- (c) the encoder ----

def _read_cols(caps=CAPS):
    """f32-blob column mask without img_onehot, which this package leaves
    unencoded (ImageLocality is not carried)."""
    layout, f_width, _ = _layout(caps)
    _blob, off, width, _t, _d = layout["img_onehot"]
    keep = np.ones(f_width, bool)
    keep[off:off + width] = False
    return keep


BOUND = [{"metadata": {"name": f"b{k}", "namespace": ns, "labels": labels},
          "spec": {"nodeName": node, "containers": [{"name": "c"}]}}
         for k, (ns, labels, node) in enumerate([
             ("default", {"app": "a0"}, "n1"), ("default", {"app": "a0"}, ""),
             ("other", {}, "n2"), ("default", {"app": "a1", "tier": "web"}, "n3")])]


@pytest.mark.parametrize("seed", range(3))
def test_encoder_matches_reference_with_workloads(seed):
    rng = np.random.RandomState(500 + seed)
    nodes, pods = spread_cluster(rng, 40, P)
    (_s, batch, table), (_js, jbatch, jtable) = encode_both(nodes, pods, BOUND)
    mine = pack_batch(batch, CAPS)
    ref = j_pack_batch(jbatch, JCAPS)
    keep = _read_cols()
    np.testing.assert_array_equal(mine[0][:, keep].view(np.int32),
                                  ref[0][:, keep].view(np.int32))
    np.testing.assert_array_equal(mine[1], ref[1])
    assert table.podsels == jtable.podsels
    # every case the fixture promises is present
    assert (batch.spread_q[:len(pods)] >= 0).any()
    assert (batch.spread_q[:len(pods)] < 0).any()
    assert (batch.svcanti_total[:len(pods)] > 0).any()
    assert any(len(canon) == 2 and len(canon[1]) == 2
               for _ns, canon in table.podsels)   # a two-selector union

    # the same pods through both packages' caches, one row at a time
    cache = EncodeCache(CAPS, encode_cluster(
        [obj.Node.from_dict(d) for d in nodes], [], CAPS)[2],
        _context(obj, EncodeContext, BOUND))
    jcache = JEncodeCache(JCAPS, j_encode_cluster(
        [jobj.Node.from_dict(d) for d in nodes], [], JCAPS)[2],
        volume_ctx=_context(jobj, JContext, BOUND))
    fblob, iblob = pack_batch(empty_batch(CAPS), CAPS)
    jf, ji = j_pack_batch(j_empty_batch(JCAPS), JCAPS)
    for i, d in enumerate(pods):
        cache.encode_packed_into(fblob, iblob, i, obj.Pod.from_dict(d))
        jcache.encode_packed_into(jf, ji, i, jobj.Pod.from_dict(d))
    np.testing.assert_array_equal(fblob[:, keep].view(np.int32),
                                  jf[:, keep].view(np.int32))
    np.testing.assert_array_equal(iblob, ji)
    assert (cache.hits, cache.misses) == (jcache.hits, jcache.misses)


# ---- (d) the encode cache ----

SVC_A0 = WORKLOADS["Service"][0]


def _pod(name, ns="default", labels=None):
    return {"metadata": {"name": name, "namespace": ns,
                         "labels": labels or {"app": "a0"}},
            "spec": {"containers": [{"name": "c", "resources": {
                "requests": {"cpu": "100m", "memory": "128Mi"}}}]}}


@pytest.mark.parametrize("meta", [{"ns": "other"}, {"labels": {"app": "a1"}}],
                         ids=["namespace", "labels"])
def test_fingerprint_separates_namespace_and_labels(meta):
    node = random_cluster(np.random.RandomState(1), 1, 0)[0]
    ctx = _context(obj, EncodeContext)
    cache = EncodeCache(CAPS, encode_cluster(
        [obj.Node.from_dict(d) for d in node], [], CAPS)[2], ctx)
    fblob, iblob = pack_batch(empty_batch(CAPS), CAPS)
    pods = [obj.Pod.from_dict(_pod("base")),
            obj.Pod.from_dict(_pod("variant", meta.get("ns", "default"),
                                   meta.get("labels")))]
    # the base class's first encode interns its entries (the epoch moves):
    # encode it until it hits, so only the fingerprint can tell the variant
    for i in range(3):
        cache.encode_packed_into(fblob, iblob, i, pods[0])
    assert (cache.misses, cache.hits) == (2, 1)
    cache.encode_packed_into(fblob, iblob, 3, pods[1])
    assert cache.misses == 3
    q = blob_col(fblob, iblob, "spread_q", CAPS)
    assert q[2] >= 0 and q[3] != q[2]
    fresh = encode_pods(pods, CAPS, encode_cluster(
        [obj.Node.from_dict(d) for d in node], [], CAPS)[2], ctx=ctx)
    np.testing.assert_array_equal(
        blob_col(fblob, iblob, "pod_matches_q", CAPS)[[2, 3]],
        fresh.pod_matches_q[:2])
    np.testing.assert_array_equal(q[[2, 3]], fresh.spread_q[:2])


def _last_blob_col(sched, name, n):
    fblob, iblob = sched._host_blobs
    return blob_col(fblob, iblob, name, sched.caps, n)


def test_workload_events_bump_the_generation():
    nodes = random_cluster(np.random.RandomState(2), 8, 0)[0]
    sched = Scheduler(CAPS, device="cpu")
    sched.add_nodes([obj.Node.from_dict(d) for d in nodes])
    sched.schedule([obj.Pod.from_dict(_pod("first"))])
    assert _last_blob_col(sched, "spread_q", 1)[0] == -1
    svc = obj.Service.from_dict(SVC_A0)
    gen = sched.encode_cache.generation
    sched.add_service(svc)
    assert sched.encode_cache.generation == gen + 1
    # the same spec again: its cached row (no Service then) is not served
    sched.schedule([obj.Pod.from_dict(_pod("second"))])
    assert _last_blob_col(sched, "spread_q", 1)[0] >= 0
    assert sched.last_result.new_podsel is not None
    rc = obj.ReplicationController.from_dict(WORKLOADS["ReplicationController"][0])
    sched.add_controller(rc)
    sched.remove_controller(rc)
    sched.remove_service(svc)
    assert sched.encode_cache.generation == gen + 4
    sched.schedule([obj.Pod.from_dict(_pod("third"))])
    assert _last_blob_col(sched, "spread_q", 1)[0] == -1
    with pytest.raises(TypeError):
        sched.add_controller(obj.Pod.from_dict(_pod("x")))


# ---- (e) the in-batch re-encode ----

def test_a_later_pod_interning_an_entry_reencodes_the_chunk():
    # pod 0 (app=a0, tier=web) is encoded first and interns the union of
    # svc-a0 and rs-web; pod 5 (tier=web only) interns rs-web's union alone,
    # which selects pod 0 too
    nodes = random_cluster(np.random.RandomState(3), 12, 0)[0]
    specs = [_pod("p0", labels={"app": "a0", "tier": "web"})] + [
        _pod(f"p{k}") for k in range(1, 5)] + [
        _pod("p5", labels={"tier": "web"})]
    sched = _port_scheduler(nodes)
    pods = [obj.Pod.from_dict(d) for d in specs]
    epoch = sched.statedb.table.pod_row_epoch
    placed = sched.schedule(pods)
    table = sched.statedb.table
    assert table.pod_row_epoch > epoch
    web = table.podsels[(frozenset(["default"]),
                         ("<union>", ((("tier", "In", ("web",)),),)))]
    assert web > table.podsels[(frozenset(["default"]), (
        "<union>", tuple(sorted([(("app", "In", ("a0",)),),
                                 (("tier", "In", ("web",)),)], key=repr))))]
    matches = _last_blob_col(sched, "pod_matches_q", len(pods))
    assert matches[0, web] == 1.0
    # every row equals the fresh encoding against the final universe
    fresh = encode_pods(pods, CAPS, table, ctx=sched.encode_cache.ctx)
    fblob, iblob = sched._host_blobs
    want = pack_batch(fresh, CAPS)
    np.testing.assert_array_equal(fblob[:len(pods)].view(np.int32),
                                  want[0][:len(pods)].view(np.int32))
    np.testing.assert_array_equal(iblob[:len(pods)], want[1][:len(pods)])
    # and the ledger counts pod 0 under that entry on its node
    row = table.row_of[placed["default/p0"]]
    assert sched.statedb.host.podsel_count[row, web] >= 1.0


# ---- (f) the StateDB's pod-selector ledger, (g) chained batches ----

class _JaxChain:
    """The reference package driven as its driver does: workload context,
    encode cache, re-encode on an epoch move, StateDB flush, schedule_batch,
    commit."""

    def __init__(self, nodes):
        self.bound: list = []
        self.objs = _objects(jobj)
        ctx = JContext(
            **{f"get_{k}": self._lister(kind) for k, kind in (
                ("services", "Service"), ("rcs", "ReplicationController"),
                ("rss", "ReplicaSet"), ("sss", "StatefulSet"))},
            list_pods=lambda ns: [p for p in self.bound
                                  if p.metadata.namespace == ns])
        self.db = JStateDB(JCAPS, volume_ctx=ctx)
        for d in nodes:
            self.db.upsert_node(jobj.Node.from_dict(d))
        self.cache = JEncodeCache(JCAPS, self.db.table, volume_ctx=ctx)
        self.rr = 0

    def _lister(self, kind):
        return lambda ns: [o for o in self.objs[kind]
                           if o.metadata.namespace == ns]

    def remove_workloads(self):
        self.objs = {kind: [] for kind in self.objs}
        self.cache.generation += 1

    def add_pod(self, d, node):
        pod = jobj.Pod.from_dict(d)
        ok = self.db.add_pod(pod, node)
        if ok:
            self.bound.append(pod)
        return ok

    def remove_pod(self, key):
        self.db.remove_pod(key)
        self.bound = [p for p in self.bound if p.key != key]

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
        state = self.db.flush()
        res = jax_solve(state, batch, self.rr, flags)
        rows = np.asarray(res.assignments)
        names = [self.db.table.name_of[r] if r >= 0 else None
                 for r in rows[:len(pods)]]
        self.db.commit_batch(res, fblob, [(p, n, i) for i, (p, n)
                                          in enumerate(zip(pods, names)) if n])
        self.rr = rr_from_numpy(res.rr_end)
        return {p.key: n for p, n in zip(pods, names)}, res


def _port_scheduler(nodes):
    sched = Scheduler(CAPS, device="cpu")
    sched.add_nodes([obj.Node.from_dict(d) for d in nodes])
    for kind, ds in WORKLOADS.items():
        for d in ds:
            o = getattr(obj, kind).from_dict(d)
            (sched.add_service if kind == "Service" else sched.add_controller)(o)
    return sched


def test_statedb_podsel_ledger_matches_the_reference(monkeypatch):
    monkeypatch.delenv("KTPU_PALLAS", raising=False)
    rng = np.random.RandomState(600)
    nodes, pods = spread_cluster(rng, 96, 3 * P, name="q")
    bound, batch1, batch2 = pods[:P], pods[P:2 * P], pods[2 * P:]
    sched = _port_scheduler(nodes)
    ref = _JaxChain(nodes)
    # bound pods, accounted before any selector entry exists
    for d in bound:
        node = f"n{rng.randint(100)}"
        d["spec"]["nodeName"] = node
        assert sched.add_pod(obj.Pod.from_dict(d), node) == ref.add_pod(d, node)
    assert not sched.statedb.host.podsel_count.any()
    got1 = sched.schedule([obj.Pod.from_dict(d) for d in batch1])
    want1, res1 = ref.schedule(batch1)
    assert got1 == want1
    assert_same(sched.last_result, res1, "batch 1")
    # the bound pods were counted into the entries batch 1 interned
    host = sched.statedb.host.podsel_count
    np.testing.assert_array_equal(host, np.asarray(ref.db.host.podsel_count))
    bound_rows = {sched.statedb.table.row_of[d["spec"]["nodeName"]] for d in bound
                  if d["spec"]["nodeName"] in sched.statedb.table.row_of}
    assert host[sorted(bound_rows)].any()
    # deletions of bound and placed pods, then a batch on that state
    gone = [f"{d['metadata'].get('namespace', 'default')}/{d['metadata']['name']}"
            for d in bound[::2] + batch1[::3]]
    for key in gone:
        sched.remove_pod(key)
        ref.remove_pod(key)
    np.testing.assert_array_equal(sched.statedb.host.podsel_count,
                                  np.asarray(ref.db.host.podsel_count))
    got2 = sched.schedule([obj.Pod.from_dict(d) for d in batch2])
    want2, res2 = ref.schedule(batch2)
    assert got2 == want2
    assert_same(sched.last_result, res2, "batch 2")
    np.testing.assert_array_equal(sched.statedb.host.podsel_count,
                                  np.asarray(ref.db.host.podsel_count))
    np.testing.assert_array_equal(sched.statedb.flush().podsel_count.numpy(),
                                  sched.statedb.host.podsel_count)


@pytest.mark.parametrize("seed", range(2))
def test_scheduler_chains_spread_batches_like_the_reference(seed, monkeypatch):
    monkeypatch.delenv("KTPU_PALLAS", raising=False)
    rng = np.random.RandomState(700 + seed)
    nodes, pods = spread_cluster(rng, 96, 3 * P)
    sched = _port_scheduler(nodes)
    ref = _JaxChain(nodes)
    for k in range(3):
        chunk = pods[k * P:(k + 1) * P]
        got = sched.schedule([obj.Pod.from_dict(d) for d in chunk])
        want, res = ref.schedule(chunk)
        assert got == want, f"batch {k}"
        assert_same(sched.last_result, res, f"batch {k}")
    assert None in got.values()
    np.testing.assert_array_equal(sched.statedb.host.podsel_count,
                                  np.asarray(ref.db.host.podsel_count))
    np.testing.assert_array_equal(sched.statedb.host.requested,
                                  np.asarray(ref.db.host.requested))
    assert sched.encode_cache.hits > 0


def test_a_batch_without_spread_keeps_the_device_ledger_in_step(monkeypatch):
    """Once the workload objects are gone, pods still match the entries
    interned for them, but no batch raises the spread gate: the main scan
    passes the device's pod-selector ledger through, and the placed pods'
    rows are copied at the next flush."""
    monkeypatch.delenv("KTPU_PALLAS", raising=False)
    rng = np.random.RandomState(800)
    nodes, pods = spread_cluster(rng, 96, 2 * P)
    sched = _port_scheduler(nodes)
    ref = _JaxChain(nodes)
    assert sched.schedule([obj.Pod.from_dict(d) for d in pods[:P]]) == \
        ref.schedule(pods[:P])[0]
    for kind, ds in WORKLOADS.items():
        for d in ds:
            o = getattr(obj, kind).from_dict(d)
            (sched.remove_service if kind == "Service" else sched.remove_controller)(o)
    ref.remove_workloads()
    got = sched.schedule([obj.Pod.from_dict(d) for d in pods[P:]])
    want, _res = ref.schedule(pods[P:])
    assert got == want
    assert sched.last_result.new_podsel is None
    assert _last_blob_col(sched, "pod_matches_q", P).any()
    assert sched.statedb.ledger_dirty
    host = sched.statedb.host.podsel_count
    np.testing.assert_array_equal(host, np.asarray(ref.db.host.podsel_count))
    np.testing.assert_array_equal(sched.statedb.flush().podsel_count.numpy(), host)


# ---- (h) the spread build's reduction, and the zones in use ----
#
# The CUDA spread build (csrc/assign_scan.cu) sums the feasible counts of
# each zone in integers: one sum per zone in use in each warp, the warps'
# sums in each block, the 16 blocks' partials in every warp, over the Z
# zones the host has interned only; a node reads its zone's sum from the
# lane that holds it (zone d on lane d % 32, the upper 32 zones in a second
# register). It divides by the pod's max count and max zone sum as a
# product with their reciprocals in double. The model below is that
# arithmetic in numpy, held against JAX `selector_spread`.

CLUSTER, WARP = 16, 32


def _kernel_model(zone, counts, feasible, zones, run, threads, rng):
    """f32[N] SelectorSpread of one pod as the spread build computes it:
    zone i32[N] (the GetZoneKey ids), counts f32[N] (the pod's count
    column), feasible bool[N], `zones` in use (ids at or past it are not
    summed), `run` nodes a thread and `threads` a block."""
    n = zone.shape[0]
    nb = threads * run
    assert n <= CLUSTER * nb
    c = counts.astype(np.int64)
    assert np.array_equal(c, counts), "counts are integers"
    pad = CLUSTER * nb - n
    zone_p = np.r_[zone, np.full(pad, -1)].astype(np.int64)
    c_p = np.r_[c, np.zeros(pad, np.int64)]
    fe_p = np.r_[feasible, np.zeros(pad, bool)]
    # node g: block g // nb, warp (g % nb) // (WARP * run)
    warp_of = (np.arange(CLUSTER * nb) % nb) // (WARP * run)
    block_of = np.arange(CLUSTER * nb) // nb
    summed = fe_p & (zone_p >= 0) & (zone_p < zones)
    block_parts = []
    for b in range(CLUSTER):
        part = np.zeros(2 + zones, np.int64)       # max, zoned, zone sums
        for w in range(threads // WARP):
            mine = (block_of == b) & (warp_of == w)
            f = mine & fe_p
            wsum = np.zeros(zones, np.int64)
            # one sum per zone in use among the warp's nodes (any order)
            for d in rng.permutation(np.unique(zone_p[mine & (zone_p >= 0)
                                                      & (zone_p < zones)])):
                wsum[d] = c_p[mine & summed & (zone_p == d)].sum()
            part[0] = max(part[0], c_p[f].max(initial=0))
            part[1] |= bool((f & (zone_p >= 0)).any())
            part[2:] += wsum
        block_parts.append(part)
    # every warp sums the 16 partials, in any order
    lo = np.zeros(WARP, np.int64)
    hi = np.zeros(WARP, np.int64)
    max_c, any_z = 0, 0
    for b in rng.permutation(CLUSTER):
        part = block_parts[b]
        max_c, any_z = max(max_c, part[0]), any_z | part[1]
        sums = np.r_[part[2:], np.zeros(2 * WARP - zones, np.int64)]
        lo += sums[:WARP]
        hi += sums[WARP:]
    f32 = np.float32
    max_node = f32(max_c)
    max_zone = f32(max(lo.max(), hi.max()))

    def part_of(m, x):        # spread_part: MAX_PRIORITY * (m - x) / max(m, 1)
        if not m > 0:
            return f32(10.0)
        num = f32(10.0) * (m - x)
        return f32(np.float64(num) * (1.0 / np.float64(max(m, f32(1.0)))))

    out = np.zeros(n, np.float32)
    for g in range(n):
        d = int(zone[g])
        zc = (hi if d >= WARP else lo)[d & (WARP - 1)] if 0 <= d < zones else 0
        node_s = part_of(max_node, f32(counts[g]))
        zone_s = part_of(max_zone, f32(zc))
        blended = (node_s * f32(1.0 - 2.0 / 3.0) + f32(2.0 / 3.0) * zone_s
                   if any_z and d >= 0 else node_s)
        out[g] = np.trunc(blended + f32(1e-6))
    return out


def _reduction_inputs(rng, n, zones, past):
    """Zone ids (a fifth -1, the rest below `zones`, a share past `past`
    when given), counts up to 110, and a feasible mask."""
    zone = rng.randint(0, zones, n) if zones else np.full(n, -1)
    zone[rng.rand(n) < 0.2] = -1
    if past is not None:
        beyond = rng.rand(n) < 0.1
        zone[beyond] = rng.randint(past, past + 8, int(beyond.sum()))
    counts = rng.randint(0, 111, n).astype(np.float32)
    counts[rng.rand(n) < 0.3] = 0.0
    return zone.astype(np.int32), counts, rng.rand(n) < 0.7


@pytest.mark.parametrize("zones", [1, 2, 3, 31, 32, 33, 64])
@pytest.mark.parametrize("run", [1, 8])
def test_kernel_zone_reduction_model_matches_reference(zones, run):
    """Integer warp, block and cluster partials over the zones in use, in
    permuted orders, equal JAX's one-hot matmul over the whole universe
    (ids past it, and -1, sum into no zone), for counts up to 110; and
    against a universe of just the zones in use, ids from there up are
    left out alike."""
    rng = np.random.RandomState(900 + zones + run)
    n = 300
    for universe, past in ((D, D), (zones, zones)):
        zone, counts, feasible = _reduction_inputs(rng, n, zones, past)
        topo = np.full((n, CAPS.topology_slots), -1, np.int32)
        topo[:, TOPO_SPREAD_ZONE] = zone
        want = np.asarray(jspread.selector_spread(
            SimpleNamespace(topology=jnp.asarray(topo)), jnp.int32(0),
            jinterpod.AffinityLedger(podsel_count=jnp.asarray(counts[:, None]),
                                     total_q=jnp.asarray(counts.sum()[None])),
            jnp.asarray(feasible), universe))
        got = _kernel_model(zone, counts, feasible, zones, run, 64, rng)
        np.testing.assert_array_equal(got, want, err_msg=f"universe {universe}")


def _zoned_nodes(names, zone_of):
    return [{"metadata": {"name": name, "labels": {
                 "kubernetes.io/hostname": name,
                 **({"failure-domain.beta.kubernetes.io/zone": zone_of[name],
                     "failure-domain.beta.kubernetes.io/region": "r1"}
                    if zone_of.get(name) else {})}},
             "spec": {},
             "status": {"allocatable": {"cpu": "4", "memory": "8Gi", "pods": "110"},
                        "conditions": [{"type": "Ready", "status": "True"}]}}
            for name in names]


def test_spread_zones_is_the_interned_zone_count(monkeypatch):
    """NodeTable.spread_zones counts the GetZoneKey ids interned, as JAX's
    table does, across add_nodes and remove_node: ids are never released,
    every live node's id is below it, and the driver hands it to the
    solver."""
    monkeypatch.delenv("KTPU_PALLAS", raising=False)
    zone_of = {f"n{i}": f"z{i % 3}" for i in range(12) if i % 4}
    sched = Scheduler(CAPS, device="cpu")
    ref = JStateDB(JCAPS)
    table = sched.statedb.table

    def check():
        assert table.spread_zones == len(ref.table.domains[TOPO_SPREAD_ZONE])
        ids = sched.statedb.host.topology[:, TOPO_SPREAD_ZONE]
        live = [table.row_of[name] for name in table.row_of]
        assert (ids[live] < table.spread_zones).all()
        np.testing.assert_array_equal(ids, np.asarray(ref.host.topology)[:, TOPO_SPREAD_ZONE])

    assert table.spread_zones == 0
    first = _zoned_nodes([f"n{i}" for i in range(8)], zone_of)
    sched.add_nodes([obj.Node.from_dict(d) for d in first])
    for d in first:
        ref.upsert_node(jobj.Node.from_dict(d))
    check()
    assert table.spread_zones == 3
    for name in ("n1", "n2", "n5"):
        sched.remove_node(name)
        ref.remove_node(name)
    check()
    assert table.spread_zones == 3          # ids are never released
    later = _zoned_nodes(["n9", "n10", "x0"], {**zone_of, "x0": "z9"})
    sched.add_nodes([obj.Node.from_dict(d) for d in later])
    for d in later:
        ref.upsert_node(jobj.Node.from_dict(d))
    check()
    assert table.spread_zones == 4
    seen = []
    solve = driver.schedule_batch

    def recording(state, batch, rr, policy, flags, caps, **kw):
        seen.append(kw.get("spread_zones"))
        return solve(state, batch, rr, policy, flags, caps, **kw)

    monkeypatch.setattr(driver, "schedule_batch", recording)
    pod = {"metadata": {"name": "p0", "labels": {"app": "a0"}},
           "spec": {"containers": [{"name": "c"}]}}
    assert sched.schedule([obj.Pod.from_dict(pod)])["default/p0"] is not None
    assert seen == [4]


def test_double_reciprocal_division_equals_f32_division():
    """The spread build's division: (float)((double)n * (1 / (double)y))
    equals the correctly rounded f32 n / y for n = 10 (y - x), 0 <= x <= y,
    every y up to 2,048 and samples of y up to 2^24 - 1 (the counts' range)."""
    rng = np.random.RandomState(950)
    ys = np.r_[np.arange(1, 2049), rng.randint(2049, 2**24, 4000)]
    for y in ys:
        xs = (np.arange(y + 1) if y <= 2048
              else np.r_[0, y, rng.randint(0, y + 1, 2000)])
        yf = np.float32(y)
        num = np.float32(10.0) * (yf - xs.astype(np.float32))
        want = num / yf                                  # f32, rounded once
        got = (num.astype(np.float64) * (1.0 / np.float64(yf))).astype(np.float32)
        np.testing.assert_array_equal(got, want, err_msg=f"y={y}")
