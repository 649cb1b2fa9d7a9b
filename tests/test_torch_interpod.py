"""kubernetes_tpu_torch's inter-pod (anti-)affinity against the reference
package on the CPU: term parsing and the NodeTable's topology keys and
carried terms, the encoder's blobs for affinity pods, the encode cache's
rows of affinity classes, `interpod_feasible` / `interpod_counts` /
`interpod_score` on their edge cases, `schedule_batch` with the ipa gate
(the interpod build's plain version), the StateDB's term accounting, and
three chained `Scheduler` batches of bench[interpod]'s pod mix. Every
comparison is exact: counts, scores and ledgers are integer-valued f32."""

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
from kubernetes_tpu.models.policy import Policy as JPolicy  # noqa: E402
from kubernetes_tpu.ops import interpod as jinterpod  # noqa: E402
from kubernetes_tpu.ops import solver as jsolver  # noqa: E402
from kubernetes_tpu.perf import fixtures as jfixtures  # noqa: E402
from kubernetes_tpu.state import Capacities as JCaps  # noqa: E402
from kubernetes_tpu.state import encode_cluster as j_encode_cluster  # noqa: E402
from kubernetes_tpu.state.cluster_state import NodeTable as JNodeTable  # noqa: E402
from kubernetes_tpu.state.cluster_state import (  # noqa: E402
    apply_pending_refreshes as j_apply_pending_refreshes,
)
from kubernetes_tpu.state.cluster_state import empty_state as j_empty_state  # noqa: E402
from kubernetes_tpu.state.encode_cache import EncodeCache as JEncodeCache  # noqa: E402
from kubernetes_tpu.state.pod_batch import empty_batch as j_empty_batch  # noqa: E402
from kubernetes_tpu.state.pod_batch import encode_pods as j_encode_pods  # noqa: E402
from kubernetes_tpu.state.pod_batch import pack_batch as j_pack_batch  # noqa: E402
from kubernetes_tpu.state.pod_batch import unpack_batch as j_unpack_batch  # noqa: E402
from kubernetes_tpu.state.podaffinity import (  # noqa: E402
    parse_pod_affinity as j_parse_pod_affinity,
)
from kubernetes_tpu.state.statedb import StateDB as JStateDB  # noqa: E402

from kubernetes_tpu_torch.api import objects as obj  # noqa: E402
from kubernetes_tpu_torch.models.policy import DEFAULT_POLICY, Policy  # noqa: E402
from kubernetes_tpu_torch.ops import interpod  # noqa: E402
from kubernetes_tpu_torch.ops.solver import (  # noqa: E402
    schedule_batch,
    schedule_batch_plain,
)
from kubernetes_tpu_torch.perf import fixtures  # noqa: E402
from kubernetes_tpu_torch.perf.harness import INTERPOD_PODS  # noqa: E402
from kubernetes_tpu_torch.scheduler import Scheduler  # noqa: E402
from kubernetes_tpu_torch.state import Capacities, encode_cluster  # noqa: E402
from kubernetes_tpu_torch.state.cluster_state import (  # noqa: E402
    NodeTable,
    apply_pending_refreshes,
    empty_state,
)
from kubernetes_tpu_torch.state.convert import (  # noqa: E402
    batch_from_numpy,
    rr_from_numpy,
    state_from_numpy,
)
from kubernetes_tpu_torch.state.encode_cache import EncodeCache  # noqa: E402
from kubernetes_tpu_torch.state.layout import (  # noqa: E402
    TKEY_DEFAULT_UNION,
    TKEY_INVALID,
    TermKind,
)
from kubernetes_tpu_torch.state.pod_batch import (  # noqa: E402
    _layout,
    empty_batch,
    encode_pod_into,
    encode_pods,
    pack_batch,
)
from kubernetes_tpu_torch.state.podaffinity import parse_pod_affinity  # noqa: E402
from kubernetes_tpu_torch.state.statedb import StateDB  # noqa: E402

N_NODES, P = 64, 32
# 64 carried terms: the random pods carry up to two terms each
CAPS = Capacities(num_nodes=N_NODES, batch_pods=P, term_universe=64)
JCAPS = JCaps(num_nodes=N_NODES, batch_pods=P, term_universe=64)
HOST = "kubernetes.io/hostname"
ZONE = "failure-domain.beta.kubernetes.io/zone"
REGION = "failure-domain.beta.kubernetes.io/region"
APPS = ("web", "db", "cache")
# the fields every solve is compared on
FIELDS = ("assignments", "scores", "feasible_counts", "new_requested",
          "new_nonzero", "new_podsel", "new_term")
LEDGERS = ("requested", "nonzero_requested", "podsel_count", "term_count",
           "topology", "term_q", "term_tkey", "term_weight", "term_kind",
           "term_poison")


def _bits(a):
    return np.asarray(a).view(np.int32)


def _read_cols(caps=CAPS):
    """f32-blob column mask without img_onehot, which this package leaves
    unencoded (ImageLocality is not carried)."""
    layout, f_width, _ = _layout(caps)
    _blob, off, width, _t, _d = layout["img_onehot"]
    keep = np.ones(f_width, bool)
    keep[off:off + width] = False
    return keep


# ---- fixtures: v1 dicts from a numpy seed, parsed by both packages ----

def _term(rng, tkeys, parse_errors):
    if parse_errors and rng.rand() < 0.08:
        sel = {"matchExpressions": [{"key": "app", "operator": "Like",
                                     "values": ["web"]}]}
    elif rng.rand() < 0.2:
        sel = {"matchExpressions": [{"key": "app", "operator": "In",
                                     "values": list(rng.choice(APPS, 2, False))}]}
    else:
        sel = {"matchLabels": {"app": str(rng.choice(APPS))}}
    term = {"labelSelector": sel, "topologyKey": str(rng.choice(tkeys))}
    if rng.rand() < 0.1:
        term["namespaces"] = ["other"]
    return term


def random_affinity(rng, bound=False, p_none=0.4):
    """An Affinity dict with up to two pod-(anti-)affinity terms: required
    affinity, required anti-affinity, preferred (weights 5, 40, 100) and
    preferred anti-affinity, on hostname, zone, region, a custom key or an
    empty key (rarely). Required anti terms of bound pods never carry a
    parse error (one would reject every later pod)."""
    if rng.rand() < p_none:
        return None
    out: dict = {}
    for _ in range(rng.randint(1, 3)):
        kind = rng.choice(["req", "anti", "pref", "antipref"])
        keys = [HOST, ZONE, ZONE, REGION, "rack"]
        if rng.rand() < 0.06:
            keys = [""]
        t = _term(rng, keys, parse_errors=not (bound and kind == "anti"))
        side = "podAntiAffinity" if kind in ("anti", "antipref") else "podAffinity"
        if kind in ("req", "anti"):
            out.setdefault(side, {}).setdefault(
                "requiredDuringSchedulingIgnoredDuringExecution", []).append(t)
        else:
            out.setdefault(side, {}).setdefault(
                "preferredDuringSchedulingIgnoredDuringExecution", []).append(
                {"weight": int(rng.choice([5, 40, 100])), "podAffinityTerm": t})
    return out


def interpod_cluster(rng, n_nodes, n_pods, n_bound=0, name="p", p_none=0.4):
    """(node dicts, pending pod dicts, bound pod dicts): nodes with zone
    and region (some with one or neither), a custom `rack` key on half of
    them and tight capacities; pods labelled app=web/db/cache (some in
    namespace `other`) with random pod affinity (none with probability
    p_none); bound pods carry a nodeName."""
    nodes = []
    for i in range(n_nodes):
        labels = {HOST: f"n{i}"}
        u = rng.rand()
        if u < 0.75 or u >= 0.95:
            if u < 0.75 or rng.rand() < 0.5:
                labels[ZONE] = f"z{rng.randint(3)}"
            if u < 0.75 or "z" not in str(labels.get(ZONE, "")):
                labels[REGION] = f"r{rng.randint(2)}"
        if rng.rand() < 0.5:
            labels["rack"] = f"rack-{rng.randint(4)}"
        nodes.append({"metadata": {"name": f"n{i}", "labels": labels},
                      "spec": {},
                      "status": {"allocatable": {
                          "cpu": str(rng.randint(2, 5)),
                          "memory": f"{rng.randint(4, 9)}Gi",
                          "pods": str(rng.randint(3, 9))},
                          "conditions": [{"type": "Ready", "status": "True"}]}})

    def pod(i, prefix, bound):
        meta = {"name": f"{prefix}{i}", "namespace": "default",
                "labels": {"app": str(rng.choice(APPS))}}
        if rng.rand() < 0.1:
            meta["namespace"] = "other"
        spec = {"containers": [{"name": "c", "image": "k8s.gcr.io/pause:3.0",
                                "resources": {"requests": {
                                    "cpu": f"{[250, 500, 1000][rng.randint(3)]}m",
                                    "memory": f"{[256, 512][rng.randint(2)]}Mi"}}}]}
        aff = random_affinity(rng, bound, p_none)
        if aff:
            spec["affinity"] = aff
        if bound:
            spec["nodeName"] = f"n{rng.randint(n_nodes)}"
        return {"metadata": meta, "spec": spec}

    pods = [pod(i, name, False) for i in range(n_pods)]
    bound = [pod(i, "b", True) for i in range(n_bound)]
    return nodes, pods, bound


# ---- (a) parsing and the NodeTable ----

@pytest.mark.parametrize("seed", range(3))
def test_parse_pod_affinity_matches_reference(seed):
    rng = np.random.RandomState(900 + seed)
    for _ in range(20):
        aff = random_affinity(rng)
        ns = str(rng.choice(["default", "other"]))
        got = parse_pod_affinity(aff, ns)
        want = j_parse_pod_affinity(aff, ns)
        for lst in ("aff_req", "anti_req", "aff_pref", "anti_pref"):
            assert [(t.selector, t.namespaces, t.topology_key, t.weight)
                    for t in getattr(got, lst)] == \
                [(t.selector, t.namespaces, t.topology_key, t.weight)
                 for t in getattr(want, lst)], lst


def test_node_table_keys_codes_and_terms_match_reference():
    caps = Capacities(num_nodes=8, topology_slots=7, term_universe=4)
    jcaps = JCaps(num_nodes=8, topology_slots=7, term_universe=4)
    table, jtable = NodeTable(caps), JNodeTable(jcaps)
    state, jstate = empty_state(caps), j_empty_state(jcaps)
    nodes = [{"metadata": {"name": f"n{i}", "labels": {
        HOST: f"n{i}", ZONE: f"z{i % 2}", "rack": f"r{i % 3}"}},
        "status": {"allocatable": {"cpu": "1", "pods": "3"},
                   "conditions": [{"type": "Ready", "status": "True"}]}}
        for i in range(5)]
    from kubernetes_tpu.state.cluster_state import _fill_node_row
    from kubernetes_tpu_torch.state.cluster_state import fill_node_row
    for d in nodes:
        fill_node_row(state, table, table.assign_row(d["metadata"]["name"]),
                      obj.Node.from_dict(d))
        _fill_node_row(jstate, jtable, jtable.assign_row(d["metadata"]["name"]),
                       jobj.Node.from_dict(d))
    for key, required in [("", True), ("", False), (ZONE, True), ("rack", True),
                          ("power", False), ("rack", False), ("extra", False)]:
        assert table.tkey_code(key, required=required) == \
            jtable.tkey_code(key, required=required), (key, required)
    assert table.topo_key_of == jtable.topo_key_of
    # the slots are exhausted: a required key raises, a preferred one is
    # TKEY_INVALID
    assert table.tkey_code("more", required=False) == TKEY_INVALID
    with pytest.raises(ValueError):
        table.tkey_code("more", required=True)
    for args in [(0, 1, 0.0, TermKind.ANTI_REQ, False),
                 (1, TKEY_DEFAULT_UNION, 5.0, TermKind.AFF_PREF, False),
                 (0, 1, 0.0, TermKind.ANTI_REQ, False),
                 (2, 5, -3.0, TermKind.ANTI_PREF, False),
                 (3, 0, 0.0, TermKind.ANTI_REQ, True)]:
        assert table.intern_term(*args) == jtable.intern_term(*args)
    assert table.terms == jtable.terms and table.term_attrs == jtable.term_attrs
    with pytest.raises(ValueError):
        table.intern_term(4, 0, 0.0, TermKind.AFF_REQ, False)
    # the custom keys' columns are refilled for the nodes encoded before
    rows = apply_pending_refreshes(state, table)
    j_apply_pending_refreshes(jstate, jtable)
    assert rows == [table.row_of[d["metadata"]["name"]] for d in nodes]
    for name in ("topology", "term_q", "term_tkey", "term_weight", "term_kind",
                 "term_poison"):
        np.testing.assert_array_equal(getattr(state, name),
                                      np.asarray(getattr(jstate, name)), name)
    assert (state.topology[:5, table.topo_key_of["rack"]] >= 0).all()
    assert not table.dirty_term_attrs and not table.pending_topo_refresh


# ---- (b) the encoder and the cache ----

def encode_both(nodes, pods):
    mine = encode_cluster([obj.Node.from_dict(d) for d in nodes],
                          [obj.Pod.from_dict(d) for d in pods], CAPS)
    ref = j_encode_cluster([jobj.Node.from_dict(d) for d in nodes],
                           [jobj.Pod.from_dict(d) for d in pods], JCAPS)
    return mine, ref


@pytest.mark.parametrize("seed", range(3))
def test_encoder_blobs_match_reference(seed):
    rng = np.random.RandomState(1000 + seed)
    nodes, pods, _ = interpod_cluster(rng, 40, P - seed)
    (state, batch, table), (jstate, jbatch, jtable) = encode_both(nodes, pods)
    mine, ref = pack_batch(batch, CAPS), j_pack_batch(jbatch, JCAPS)
    keep = _read_cols()
    np.testing.assert_array_equal(_bits(mine[0][:, keep]), _bits(ref[0][:, keep]))
    np.testing.assert_array_equal(mine[1], ref[1])
    assert table.podsels == jtable.podsels and table.terms == jtable.terms
    for name in ("topology", "term_q", "term_tkey", "term_weight", "term_kind",
                 "term_poison"):
        np.testing.assert_array_equal(getattr(state, name),
                                      np.asarray(getattr(jstate, name)), name)
    # every case the fixture promises is present
    n = len(pods)
    assert (batch.paff_q[:n] >= 0).any() and (batch.panti_q[:n] >= 0).any()
    assert (batch.ppref_w[:n] < 0).any() and (batch.ppref_w[:n] > 0).any()
    assert batch.pod_carries_e[:n].any()


def test_cache_hit_for_an_affinity_class_equals_a_fresh_encode():
    """An affinity class encoded first, then pods interning new selectors,
    terms and a custom topology key, then the class again: the hit (served
    once the epoch settles) equals the fresh encoding against the final
    universes, and the reference cache's row."""
    nodes = interpod_cluster(np.random.RandomState(5), 12, 0)[0]
    cls = {"metadata": {"name": "c0", "labels": {"app": "web"}},
           "spec": {"containers": [{"name": "c"}], "affinity": {
               "podAntiAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [{
                   "labelSelector": {"matchLabels": {"app": "web"}},
                   "topologyKey": HOST}]},
               "podAffinity": {"preferredDuringSchedulingIgnoredDuringExecution": [{
                   "weight": 7, "podAffinityTerm": {
                       "labelSelector": {"matchLabels": {"app": "db"}},
                       "topologyKey": ZONE}}]}}}}
    others = [{"metadata": {"name": f"o{k}", "labels": {"app": app}},
               "spec": {"containers": [{"name": "c"}], "affinity": {
                   "podAffinity": {"preferredDuringSchedulingIgnoredDuringExecution": [{
                       "weight": 3, "podAffinityTerm": {
                           "labelSelector": sel, "topologyKey": key}}]}}}}
              for k, (app, sel, key) in enumerate([
                  ("db", {"matchExpressions": [{"key": "app", "operator": "Exists"}]},
                   "rack"),
                  ("cache", {"matchLabels": {"tier": "x"}}, "")])]
    again = {**cls, "metadata": {**cls["metadata"], "name": "c1"}}
    specs = [cls] + others + [again, again]
    caches = []
    for pkg, cache_cls, caps, kw in ((obj, EncodeCache, CAPS, {}),
                                     (jobj, JEncodeCache, JCAPS, {})):
        db = (StateDB(CAPS, device="cpu") if pkg is obj else JStateDB(JCAPS))
        for d in nodes:
            db.upsert_node(pkg.Node.from_dict(d))
        cache = cache_cls(caps, db.table, **kw)
        blobs = (pack_batch(empty_batch(CAPS), CAPS) if pkg is obj
                 else j_pack_batch(j_empty_batch(JCAPS), JCAPS))
        for i, d in enumerate(specs):
            cache.encode_packed_into(*blobs, i, pkg.Pod.from_dict(d))
        caches.append((db, cache, blobs))
    (db, cache, (fblob, iblob)), (_jdb, _jcache, (jf, ji)) = caches
    # the first re-encode of the class misses (the epoch moved), the second hits
    assert cache.hits == 1
    fresh = pack_batch(encode_pods([obj.Pod.from_dict(d) for d in specs], CAPS,
                                   db.table), CAPS)
    keep = _read_cols()
    last = len(specs) - 1
    np.testing.assert_array_equal(_bits(fblob[last, keep]), _bits(fresh[0][last, keep]))
    np.testing.assert_array_equal(iblob[last], fresh[1][last])
    np.testing.assert_array_equal(_bits(fblob[:len(specs), keep]),
                                  _bits(jf[:len(specs), keep]))
    np.testing.assert_array_equal(iblob[:len(specs)], ji[:len(specs)])
    # the class's match row gained the columns interned after its first encode
    q = db.table.podsels[(frozenset(["default"]), (("app", "Exists", ()),))]
    matches = fblob[last, _layout(CAPS)[0]["pod_matches_q"][1] + q]
    assert matches == 1.0


def test_scratch_row_resets_after_affinity_pods():
    """One reused packed row (the cache's miss path): a pod without pod
    affinity encoded after one with terms, and after one whose encode
    stopped at a capacity error, equals its fresh encoding."""
    from kubernetes_tpu_torch.state.layout import CapacityError
    from kubernetes_tpu_torch.state.pod_batch import PackedRow, pack_row

    table = encode_cluster([], [], CAPS)[2]
    rng = np.random.RandomState(7)
    with_terms = [d for d in interpod_cluster(rng, 1, 20, p_none=0.0)[1]][:3]
    plain = {"metadata": {"name": "plain", "labels": {"app": "web"}},
             "spec": {"containers": [{"name": "c"}]}}
    # its required term is written before its preferred terms overflow
    term = {"labelSelector": {"matchLabels": {"app": "db"}}, "topologyKey": HOST}
    too_many = {"metadata": {"name": "many"}, "spec": {
        "containers": [{"name": "c"}], "affinity": {"podAntiAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [term],
            "preferredDuringSchedulingIgnoredDuringExecution": [
                {"weight": 1, "podAffinityTerm": term}]
            * (CAPS.interpod_pref_slots + 1)}}}}
    row = PackedRow(CAPS)
    for d in with_terms:
        encode_pod_into(row.batch, 0, obj.Pod.from_dict(d), CAPS, table)
    with pytest.raises(CapacityError):
        encode_pod_into(row.batch, 0, obj.Pod.from_dict(too_many), CAPS, table)
    pod = obj.Pod.from_dict(plain)
    encode_pod_into(row.batch, 0, pod, CAPS, table)
    frow, irow = row.pack()
    want_f, want_i = pack_row(encode_pods([pod], CAPS, table), 0, CAPS)
    np.testing.assert_array_equal(_bits(frow), _bits(want_f))
    np.testing.assert_array_equal(irow, want_i)


# ---- (c) interpod_feasible, interpod_counts, interpod_score ----

K, D, UQ, UE, IA = 8, 8, 8, 8, 4
CASES = ("random", "first_pod_escape", "poisoned", "tkey_invalid",
         "default_union", "negative_weights", "no_feasible", "custom_key")


def _ops_inputs(rng, case, n=48):
    """Seeded ledgers, topology, carried-term attributes and one pod's rows
    for one edge case."""
    topo = np.full((n, K), -1, np.int32)
    topo[:, 0] = np.arange(n)
    zone = rng.randint(-1, 3, n)
    region = rng.randint(-1, 2, n)
    if case == "default_union":   # many nodes lack a zone, a region or both
        zone[rng.rand(n) < 0.4] = -1
        region[rng.rand(n) < 0.4] = -1
    topo[:, 1], topo[:, 2] = zone, region
    both = (zone >= 0) & (region >= 0)
    topo[:, 3] = np.where(both, zone * 2 + region, -1)
    topo[:, 4] = np.where((zone >= 0) | (region >= 0), (region + 1) * 4 + zone + 1, -1)
    topo[:, 5] = rng.randint(-1, 4, n)
    podsel = rng.randint(0, 3, (n, UQ)).astype(np.float32)
    podsel[rng.rand(n, UQ) < 0.6] = 0.0
    term = rng.randint(0, 3, (n, UE)).astype(np.float32)
    term[rng.rand(n, UE) < 0.6] = 0.0
    slot_keys = [0, 1, 2, 5] if case != "custom_key" else [5]
    term_q = rng.randint(0, UQ, UE).astype(np.int32)
    term_q[UE - 1] = -1                        # an unused entry
    kind = rng.randint(0, 4, UE).astype(np.int32)
    tkey = rng.choice(slot_keys, UE).astype(np.int32)
    pref = kind >= TermKind.AFF_PREF
    tkey[pref & (rng.rand(UE) < 0.3)] = TKEY_DEFAULT_UNION
    weight = np.where(kind == TermKind.AFF_PREF, rng.randint(1, 100, UE),
                      np.where(kind == TermKind.ANTI_PREF,
                               -rng.randint(1, 100, UE), 0)).astype(np.float32)
    poison = np.zeros(UE, bool)
    matches = (rng.rand(UQ) < 0.4).astype(np.float32)
    pod = dict(
        pod_matches_q=matches,
        paff_q=np.full(IA, -1, np.int32), paff_tkey=np.zeros(IA, np.int32),
        panti_q=np.full(IA, -1, np.int32), panti_tkey=np.zeros(IA, np.int32),
        ppref_q=np.full(IA, -1, np.int32), ppref_tkey=np.zeros(IA, np.int32),
        ppref_w=np.zeros(IA, np.float32), ipaff_fail=np.bool_(False))
    pod["paff_q"][1] = rng.randint(UQ)
    pod["paff_tkey"][1] = rng.choice(slot_keys)
    pod["panti_q"][0] = rng.randint(UQ)
    pod["panti_tkey"][0] = rng.choice(slot_keys)
    pod["ppref_q"][:3] = rng.randint(0, UQ, 3)
    pod["ppref_tkey"][:3] = rng.choice(slot_keys + [TKEY_DEFAULT_UNION], 3)
    pod["ppref_w"][:3] = rng.randint(1, 100, 3)
    feasible = rng.rand(n) < 0.7
    if case == "first_pod_escape":   # no pod matches anywhere; the pod does
        q = pod["paff_q"][1]
        podsel[:, q] = 0.0
        matches[q] = 1.0
    elif case == "poisoned":
        kind[0], poison[0], term[3, 0] = TermKind.ANTI_REQ, True, 1.0
    elif case == "tkey_invalid":
        kind[0], tkey[0], term[3, 0] = TermKind.ANTI_REQ, TKEY_INVALID, 1.0
        matches[term_q[0]] = 1.0
    elif case == "default_union":
        pod["ppref_tkey"][:3] = TKEY_DEFAULT_UNION
        tkey[pref] = TKEY_DEFAULT_UNION
    elif case == "negative_weights":
        pod["ppref_w"][:3] *= -1
        weight = -np.abs(weight)
    elif case == "no_feasible":
        feasible[:] = False
    elif case == "custom_key":
        pod["ppref_tkey"][:3] = 5
    weight[kind < TermKind.AFF_PREF] = 0.0
    state = dict(topology=topo, term_q=term_q, term_tkey=tkey,
                 term_kind=kind, term_weight=weight, term_poison=poison)
    return state, pod, podsel, term, feasible


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("seed", range(2))
def test_interpod_ops_match_reference(case, seed):
    rng = np.random.RandomState(1100 + seed)
    state, pod, podsel, term, feasible = _ops_inputs(rng, case)
    # the reference
    js = SimpleNamespace(**{k: jnp.asarray(v) for k, v in state.items()})
    jp = SimpleNamespace(**{k: jnp.asarray(v) for k, v in pod.items()})
    jtopo = jnp.asarray(state["topology"])
    jled = jinterpod.AffinityLedger(
        podsel_count=jnp.asarray(podsel), total_q=jnp.asarray(podsel.sum(0)),
        term_count=jnp.asarray(term),
        dom_podsel=jinterpod.domain_aggregates(jtopo, jnp.asarray(podsel), D),
        dom_term=jinterpod.domain_aggregates(jtopo, jnp.asarray(term), D),
        total_e=jnp.asarray(term.sum(0)))
    onehot = jinterpod.topology_onehot(jtopo, D)
    want_ok = np.asarray(jinterpod.interpod_feasible(js, jp, jled, onehot))
    want_c = np.asarray(jinterpod.interpod_counts(js, jp, jled, 1.0, onehot))
    feas = feasible & want_ok
    want_s = np.asarray(jinterpod.interpod_score(jnp.asarray(want_c),
                                                 jnp.asarray(feas)))
    # this package
    t = torch.from_numpy
    ts = SimpleNamespace(**{k: t(np.ascontiguousarray(v)) for k, v in state.items()})
    tp = SimpleNamespace(**{k: torch.as_tensor(v) for k, v in pod.items()})
    led = interpod.make_ledger(t(podsel), t(term), ts.topology, D)
    tonehot = interpod.topology_onehot(ts.topology, D)
    got_ok = interpod.interpod_feasible(ts, tp, led, tonehot)
    got_c = interpod.interpod_counts(ts, tp, led, 1.0, tonehot)
    got_s = interpod.interpod_score(got_c, t(feas))
    np.testing.assert_array_equal(got_ok.numpy(), want_ok)
    np.testing.assert_array_equal(_bits(got_c.numpy()), _bits(want_c))
    np.testing.assert_array_equal(_bits(got_s.numpy()), _bits(want_s))
    if case in ("poisoned", "tkey_invalid"):
        assert not want_ok.any()
    if case == "first_pod_escape":
        assert want_ok.any()
    if case == "no_feasible":
        assert not want_s.any()
    assert len(np.unique(want_c)) > 1


# ---- (c2) the interpod build's per-pod order and its (min, max) exchange,
# as numpy models of csrc/assign_scan.cu, against the reference ----

ROLE_SCORE, ROLE_CARRIED_ANTI, ROLE_ANTI, ROLE_AFF = range(4)
F32 = np.float32


def _kernel_list(state, pod, totals, hard_w=1.0):
    """The interpod build's count list for one pod (ip_build_list): entries
    (column, topology code, role, weight), reject every node, a weighted
    entry exists, the match or carried-term row is not zero. Reads the pod
    row, the term attributes and the totals, not the placed node."""
    entries, reject, counting = [], False, False
    for e in range(UE):
        q, tk = int(state["term_q"][e]), int(state["term_tkey"][e])
        kind = int(state["term_kind"][e])
        m = pod["pod_matches_q"][q] if q >= 0 else F32(0)
        carried = totals[UQ + e] > 0
        if kind == TermKind.ANTI_REQ:
            if state["term_poison"][e] and carried:
                reject = True
            if m > 0:
                if tk == TKEY_INVALID:
                    reject = reject or carried
                else:
                    entries.append((UQ + e, tk, ROLE_CARRIED_ANTI, F32(0)))
        eff = F32(state["term_weight"][e]) + F32(hard_w) * F32(kind == TermKind.AFF_REQ)
        wgt = F32(m) * eff
        if wgt != 0 and tk != TKEY_INVALID:
            entries.append((UQ + e, tk, ROLE_SCORE, wgt))
            counting = True
    for t in range(IA):
        q = int(pod["paff_q"][t])
        if q >= 0 and not (not totals[q] > 0 and pod["pod_matches_q"][q] > 0):
            entries.append((q, int(pod["paff_tkey"][t]), ROLE_AFF, F32(0)))
        q = int(pod["panti_q"][t])
        if q >= 0:
            entries.append((q, int(pod["panti_tkey"][t]), ROLE_ANTI, F32(0)))
        q, tk, w = int(pod["ppref_q"][t]), int(pod["ppref_tkey"][t]), F32(pod["ppref_w"][t])
        if q >= 0 and w != 0 and tk != TKEY_INVALID:
            entries.append((q, tk, ROLE_SCORE, w))
            counting = True
    reject = reject or bool(pod["ipaff_fail"])
    row_nz = bool(pod["pod_matches_q"].any() or pod["pod_carries_e"].any())
    return entries, reject, counting, row_nz


def _kernel_count(node, replica, topo, u, tk, g):
    """ip_count: column u at topology code tk for node g, from the
    node-level counts and the block's replica of the domain aggregates."""
    def at(k, d):
        return replica[k, d, u] if 0 <= d < D else F32(0)
    if tk == 0:
        return node[g, u]
    if 0 < tk < K:
        return at(tk, topo[g, tk])
    if tk == TKEY_DEFAULT_UNION:
        z, r = topo[g, 1], topo[g, 2]
        host = node[g, u] if z < 0 and r < 0 else F32(0)
        return host + at(1, z) + at(2, r) - at(3, topo[g, 3])
    return F32(0)


def _sequence_pods(rng, n_pods, state, podsel, term):
    """Pods for the sequence: random rows and terms, a first pod whose own
    zone affinity selects what no node holds yet while it matches itself
    (the first-pod escape), a second one like it, which escapes only while
    the first is unplaced, a pod with zero rows, and a late pod that first
    carries a poisoned anti term (every pod after it is rejected)."""
    free = int(np.flatnonzero(podsel.sum(0) == 0)[0]) if (podsel.sum(0) == 0).any() else 0
    podsel[:, free] = 0.0
    pods = []
    for i in range(n_pods):
        pod = dict(
            pod_matches_q=(rng.rand(UQ) < 0.4).astype(np.float32),
            pod_carries_e=(rng.rand(UE) < 0.3).astype(np.float32),
            paff_q=np.full(IA, -1, np.int32), paff_tkey=np.zeros(IA, np.int32),
            panti_q=np.full(IA, -1, np.int32), panti_tkey=np.zeros(IA, np.int32),
            ppref_q=np.full(IA, -1, np.int32), ppref_tkey=np.zeros(IA, np.int32),
            ppref_w=np.zeros(IA, np.float32), ipaff_fail=np.bool_(False))
        if rng.rand() < 0.3:
            pod["paff_q"][0], pod["paff_tkey"][0] = rng.randint(UQ), rng.choice([0, 1, 5])
        if rng.rand() < 0.3:
            pod["panti_q"][1], pod["panti_tkey"][1] = rng.randint(UQ), rng.choice([0, 1, 2])
        used = rng.rand(IA) < 0.5
        pod["ppref_q"][used] = rng.randint(0, UQ, int(used.sum()))
        pod["ppref_tkey"][used] = rng.choice([0, 1, 2, 5, TKEY_DEFAULT_UNION], int(used.sum()))
        pod["ppref_w"][used] = rng.randint(-50, 50, int(used.sum()))
        pods.append(pod)
    for pod in pods:
        pod["pod_matches_q"][free] = 0.0
    for pod in pods[:2]:
        pod["paff_q"][0], pod["paff_tkey"][0] = free, 1
        pod["pod_matches_q"][free] = 1.0
    poison = UE - 2
    state["term_kind"][poison], state["term_poison"][poison] = TermKind.ANTI_REQ, True
    term[:, poison] = 0.0
    pods[n_pods - 3]["pod_carries_e"][poison] = 1.0
    zero = pods[n_pods // 2]
    zero["pod_matches_q"][:] = 0.0
    zero["pod_carries_e"][:] = 0.0
    return pods


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("seed", range(2))
def test_kernel_pod_order_model_matches_reference(case, seed):
    """The interpod build's per-pod order: the totals updated and the pod's
    count list built from the previous pod's rows and placed flag alone,
    before the placed node is known; then the replica updated at the
    domain ids of the node the previous pod's message names; then the
    counts. At every pod the model's predicate, counts and score equal JAX
    `interpod_feasible`, `interpod_counts` and `interpod_score` on the
    ledger JAX `ledger_add` carries, and the model's ledgers equal JAX's
    at the end."""
    rng = np.random.RandomState(1700 + seed)
    state, _pod, podsel, term, feasible = _ops_inputs(rng, case)
    topo = state["topology"]
    n = topo.shape[0]
    pods = _sequence_pods(rng, 10, state, podsel, term)
    js = SimpleNamespace(**{k: jnp.asarray(v) for k, v in state.items()})
    jtopo = jnp.asarray(topo)
    jled = jinterpod.AffinityLedger(
        podsel_count=jnp.asarray(podsel), total_q=jnp.asarray(podsel.sum(0)),
        term_count=jnp.asarray(term),
        dom_podsel=jinterpod.domain_aggregates(jtopo, jnp.asarray(podsel), D),
        dom_term=jinterpod.domain_aggregates(jtopo, jnp.asarray(term), D),
        total_e=jnp.asarray(term.sum(0)))
    onehot = jinterpod.topology_onehot(jtopo, D)
    # the kernel's state: node-level counts, one block's replica, totals
    node = np.concatenate([podsel, term], 1)
    replica = np.concatenate([np.asarray(jled.dom_podsel), np.asarray(jled.dom_term)], 2)
    totals = node.sum(0)
    message = None   # the previous pod's (rows, domain ids), when broadcast
    placed_rows = None
    escapes = zero_rows = 0
    for i, pod in enumerate(pods):
        # warp 0: the totals, then the list, before the node is known
        if placed_rows is not None:
            totals = totals + placed_rows
        entries, reject, counting, row_nz = _kernel_list(state, pod, totals)
        # the other warps: the replica, at the placed node's domain ids
        if message is not None:
            rows, ids = message
            for k in range(1, K):
                if 0 <= ids[k] < D:
                    replica[k, ids[k]] += rows
        ok = np.zeros(n, bool)
        counts = np.zeros(n, np.float32)
        for g in range(n):
            c, viol, good = F32(0), F32(0), not reject
            for u, tk, role, w in entries:
                v = _kernel_count(node, replica, topo, u, tk, g)
                if role == ROLE_SCORE:
                    c = F32(c + F32(w * v))
                elif role == ROLE_CARRIED_ANTI:
                    viol = F32(viol + v)
                elif role == ROLE_ANTI:
                    good = good and v == 0
                else:
                    good = good and v > 0
            ok[g] = good and viol == 0
            counts[g] = c
        jp = SimpleNamespace(**{k: jnp.asarray(v) for k, v in pod.items()})
        want_ok = np.asarray(jinterpod.interpod_feasible(js, jp, jled, onehot))
        want_c = np.asarray(jinterpod.interpod_counts(js, jp, jled, 1.0, onehot))
        np.testing.assert_array_equal(ok, want_ok, err_msg=f"pod {i}")
        np.testing.assert_array_equal(_bits(counts), _bits(want_c), err_msg=f"pod {i}")
        feas = feasible & ok
        want_s = np.asarray(jinterpod.interpod_score(jnp.asarray(want_c),
                                                     jnp.asarray(feas)))
        if counting:
            lo = min(0, int(counts[feas].min())) if feas.any() else 0
            hi = max(0, int(counts[feas].max())) if feas.any() else 0
            got_s = _kernel_score(counts, F32(lo), F32(hi))
        else:   # no weighted entry: every count is 0, and so is the score
            assert not counts.any()
            got_s = np.zeros(n, np.float32)
        np.testing.assert_array_equal(_bits(np.where(feas, got_s, 0)),
                                      _bits(np.where(feas, want_s, 0)), err_msg=f"pod {i}")
        # the first pod's own zone affinity took the escape: no entry
        escapes += int(i == 0 and not any(e[2] == ROLE_AFF for e in entries))
        zero_rows += int(not row_nz)
        # the choice, then the owner's reductions and the message
        choice = np.flatnonzero(feas)
        placed = choice.size > 0
        g = int(rng.choice(choice)) if placed else 0
        rows = np.concatenate([pod["pod_matches_q"], pod["pod_carries_e"]])
        jp.pod_carries_e = jnp.asarray(pod["pod_carries_e"])
        jled = jinterpod.ledger_add(jled, js, jp, g, jnp.float32(placed))
        placed_rows = rows if placed and row_nz else None
        message = (rows, topo[g]) if placed and row_nz else None
        if message is not None:
            node[g] += rows
    assert escapes == 1 and zero_rows >= 1
    # the replica the next pod would read, and the ledgers, equal JAX's
    if message is not None:
        rows, ids = message
        for k in range(1, K):
            if 0 <= ids[k] < D:
                replica[k, ids[k]] += rows
        totals = totals + placed_rows
    np.testing.assert_array_equal(node[:, :UQ], np.asarray(jled.podsel_count))
    np.testing.assert_array_equal(node[:, UQ:], np.asarray(jled.term_count))
    np.testing.assert_array_equal(replica[..., :UQ], np.asarray(jled.dom_podsel))
    np.testing.assert_array_equal(replica[..., UQ:], np.asarray(jled.dom_term))
    np.testing.assert_array_equal(totals[:UQ], np.asarray(jled.total_q))
    np.testing.assert_array_equal(totals[UQ:], np.asarray(jled.total_e))


def _kernel_score(counts, min_c, max_c):
    """InterPodAffinityPriority from the reduced (min, max), in the
    kernel's f32 order."""
    spread = F32(max_c - min_c)
    if not spread > 0:
        return np.zeros_like(counts)
    return np.trunc((F32(10) * (counts - min_c)) / max(spread, F32(1)) + F32(1e-6))


CLUSTER_BLOCKS, BLOCK_WARPS, THREADS = 16, 16, 512


@pytest.mark.parametrize("n, run", [(48, 1), (3000, 1), (12000, 2), (30000, 4),
                                    (65536, 8)])
@pytest.mark.parametrize("case", ["mixed", "negative", "no_feasible", "one_node"])
def test_kernel_warp_pair_minmax_matches_reference(n, run, case):
    """The interpod build's (min, max): each of the 256 warps of the
    cluster reduces its nodes' feasible counts, clamped through 0, and the
    256 pairs are reduced further (the kernel: warp 0 a block's 16, then
    every warp the 16 blocks'), in whatever order they land. In a
    permuted order the score equals JAX `interpod_score` over the
    feasible nodes."""
    rng = np.random.RandomState(1900 + n + run)
    counts = rng.randint(-60, 90, n).astype(np.float32)
    feasible = rng.rand(n) < 0.6
    if case == "negative":
        counts = -np.abs(counts) - 1
    elif case == "no_feasible":
        feasible[:] = False
    elif case == "one_node":
        feasible[:] = False
        feasible[rng.randint(n)] = True
    nodes = CLUSTER_BLOCKS * THREADS * run
    padded = np.zeros(nodes, np.int64)
    live = np.zeros(nodes, bool)
    padded[:n], live[:n] = counts, feasible
    # node g = (block, thread, j): warp w of block b holds 32 * run
    # consecutive nodes
    per_warp = padded.reshape(CLUSTER_BLOCKS * BLOCK_WARPS, 32 * run)
    live_w = live.reshape(CLUSTER_BLOCKS * BLOCK_WARPS, 32 * run)
    lo = np.minimum(0, np.where(live_w, per_warp, 0).min(1))
    hi = np.maximum(0, np.where(live_w, per_warp, 0).max(1))
    order = rng.permutation(lo.size)
    min_c, max_c = F32(lo[order].min()), F32(hi[order].max())
    want = np.asarray(jinterpod.interpod_score(jnp.asarray(counts), jnp.asarray(feasible)))
    got = _kernel_score(counts, min_c, max_c)
    np.testing.assert_array_equal(_bits(np.where(feasible, got, 0)),
                                  _bits(np.where(feasible, want, 0)))
    if case == "no_feasible":
        assert not want.any()


# ---- (d) schedule_batch with the ipa gate ----

_JAX_SOLVE = {}


def jax_solve(state, batch, rr, flags, policy=J_POLICY):
    """JAX schedule_batch with `flags` and `policy`, jitted once per pair."""
    fn = _JAX_SOLVE.get((flags, policy))
    if fn is None:
        fn = _JAX_SOLVE[(flags, policy)] = jax.jit(
            lambda s, b, r: jsolver.schedule_batch(s, b, r, policy, flags=flags))
    return fn(state, batch, np.uint32(rr))


def assert_same(got, want, msg=""):
    for name in FIELDS:
        np.testing.assert_array_equal(
            getattr(got, name).cpu().numpy(), np.asarray(getattr(want, name)),
            err_msg=f"{msg} {name}")
    assert int(got.rr_end) == rr_from_numpy(want.rr_end), msg


def _dbs(nodes, bound):
    """This package's and the reference's StateDB over the same nodes and
    bound pods."""
    db, jdb = StateDB(CAPS, device="cpu"), JStateDB(JCAPS)
    for d in nodes:
        db.upsert_node(obj.Node.from_dict(d))
        jdb.upsert_node(jobj.Node.from_dict(d))
    for d in bound:
        assert db.add_pod(obj.Pod.from_dict(d)) == jdb.add_pod(jobj.Pod.from_dict(d))
    return db, jdb


IPA_ONLY = jsolver.BatchFlags(*(f == "ipa" for f in (
    "ipa", "spread", "svcanti", "vol", "attach", "tt", "na", "ports", "gpu",
    "storage", "gang", "preempt")))


@pytest.mark.parametrize("seed", range(3))
def test_schedule_batch_with_ipa_matches_reference(seed):
    rng = np.random.RandomState(1200 + seed)
    nodes, pods, bound = interpod_cluster(rng, 48, P - 2, n_bound=24)
    db, jdb = _dbs(nodes, bound)
    batch = encode_pods([obj.Pod.from_dict(d) for d in pods], CAPS, db.table)
    jbatch = j_encode_pods([jobj.Pod.from_dict(d) for d in pods], JCAPS, jdb.table)
    state, jstate = db.flush(), jdb.flush()
    flags = jsolver.batch_flags(jbatch, len(pods), jdb.table)
    assert flags == IPA_ONLY
    rr = [0, 11, 2**32 - 3][seed]
    want = jax_solve(jstate, jbatch, rr, flags)
    dbatch = batch_from_numpy(batch, "cpu")
    got = schedule_batch(state, dbatch, rr, caps=CAPS)
    assert_same(got, want)
    assert_same(schedule_batch_plain(state, dbatch, rr, caps=CAPS), want, "plain")
    # the reference's own encoding carried across
    assert_same(schedule_batch(state_from_numpy(jstate, "cpu"),
                               batch_from_numpy(jbatch, "cpu"), rr, caps=CAPS),
                want, "carried")
    placed = np.asarray(want.assignments)[:len(pods)]
    assert (placed >= 0).sum() > len(pods) // 3 and (placed < 0).any()
    assert not np.array_equal(np.asarray(want.new_term), db.host.term_count)


@pytest.mark.parametrize("variant", ["predicate_only", "priority_only", "hard_weight"])
def test_schedule_batch_with_ipa_under_other_policies(variant):
    preds = tuple(p for p in DEFAULT_POLICY.predicates
                  if variant != "priority_only" or p != "MatchInterPodAffinity")
    prios = tuple((n, w) for n, w in DEFAULT_POLICY.priorities
                  if variant != "predicate_only" or n != "InterPodAffinityPriority")
    hard = 5 if variant == "hard_weight" else 1
    policy = Policy(predicates=preds, priorities=prios, hard_pod_affinity_weight=hard)
    jpolicy = JPolicy(predicates=preds, priorities=prios, hard_pod_affinity_weight=hard)
    rng = np.random.RandomState(1300)
    nodes, pods, bound = interpod_cluster(rng, 48, P, n_bound=24)
    db, jdb = _dbs(nodes, bound)
    batch = encode_pods([obj.Pod.from_dict(d) for d in pods], CAPS, db.table)
    jbatch = j_encode_pods([jobj.Pod.from_dict(d) for d in pods], JCAPS, jdb.table)
    want = jax_solve(jdb.flush(), jbatch, 3, IPA_ONLY, jpolicy)
    got = schedule_batch(db.flush(), batch_from_numpy(batch, "cpu"), 3, policy,
                         caps=CAPS)
    assert_same(got, want, variant)


def test_default_policy_hard_pod_affinity_weight_matches_reference():
    assert DEFAULT_POLICY.hard_pod_affinity_weight == J_POLICY.hard_pod_affinity_weight == 1


# ---- (e) the StateDB's term accounting, (f) chained batches ----

class _JaxChain:
    """The reference package driven as this package's Scheduler drives its
    own: encode cache, re-encode on an epoch move, StateDB flush,
    schedule_batch, commit."""

    def __init__(self, nodes, caps=JCAPS):
        self.caps = caps
        self.db = JStateDB(caps)
        for d in nodes:
            self.db.upsert_node(jobj.Node.from_dict(d))
        self.cache = JEncodeCache(caps, self.db.table)
        self.rr = 0

    def schedule(self, pod_dicts):
        pods = [jobj.Pod.from_dict(d) for d in pod_dicts]
        fblob, iblob = j_pack_batch(j_empty_batch(self.caps), self.caps)
        epoch = self.db.table.pod_row_epoch
        for i, pod in enumerate(pods):
            self.cache.encode_packed_into(fblob, iblob, i, pod)
        if self.db.table.pod_row_epoch != epoch:
            for i, pod in enumerate(pods):
                self.cache.encode_packed_into(fblob, iblob, i, pod)
        batch = j_unpack_batch(fblob, iblob, self.caps)
        flags = jsolver.batch_flags(batch, len(pods), self.db.table)
        res = jax_solve(self.db.flush(), batch, self.rr, flags)
        rows = np.asarray(res.assignments)
        names = [self.db.table.name_of[r] if r >= 0 else None
                 for r in rows[:len(pods)]]
        self.db.commit_batch(res, fblob, [(p, n, i) for i, (p, n)
                                          in enumerate(zip(pods, names)) if n])
        self.rr = rr_from_numpy(res.rr_end)
        return {p.key: n for p, n in zip(pods, names)}, res


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


def test_statedb_term_accounting_matches_reference():
    rng = np.random.RandomState(1400)
    nodes, pods, bound = interpod_cluster(rng, 48, 2 * P, n_bound=32, p_none=0.7)
    sched = Scheduler(CAPS, device="cpu")
    sched.add_nodes([obj.Node.from_dict(d) for d in nodes])
    ref = _JaxChain(nodes)
    for d in bound:
        assert sched.add_pod(obj.Pod.from_dict(d)) == \
            ref.db.add_pod(jobj.Pod.from_dict(d))
    assert sched.statedb.host.term_count.any()
    assert_ledgers(sched.statedb, ref.db, "bound")
    got1 = sched.schedule([obj.Pod.from_dict(d) for d in pods[:P]])
    want1, res1 = ref.schedule(pods[:P])
    assert got1 == want1
    assert_same(sched.last_result, res1, "batch 1")
    assert_ledgers(sched.statedb, ref.db, "batch 1")
    # deletions of bound and placed pods take their terms back
    keys = [f"{d['metadata']['namespace']}/{d['metadata']['name']}"
            for d in bound[::2] + pods[:P:3]]
    for key in keys:
        sched.remove_pod(key)
        ref.db.remove_pod(key)
    assert_ledgers(sched.statedb, ref.db, "removed")
    got2 = sched.schedule([obj.Pod.from_dict(d) for d in pods[P:]])
    want2, res2 = ref.schedule(pods[P:])
    assert got2 == want2
    assert_same(sched.last_result, res2, "batch 2")
    assert_ledgers(sched.statedb, ref.db, "batch 2")


@pytest.mark.parametrize("seed", range(2))
def test_scheduler_chains_interpod_batches_like_the_reference(seed):
    """bench[interpod]'s pod mix (8 app groups, hostname anti-affinity every
    16th pod, zone affinity every 2nd), scaled down, and then random
    affinity pods, over three chained batches."""
    rng = np.random.RandomState(1500 + seed)
    nodes = [d for d in interpod_cluster(rng, 40, 0)[0]]
    bench = [{"metadata": {"name": p.metadata.name, "namespace": "default",
                           "labels": dict(p.metadata.labels)},
              "spec": {"containers": [{"name": "app", "resources": {"requests": {
                  "cpu": "500m", "memory": "512Mi"}}}],
                  "affinity": p.spec.affinity}}
             for p in fixtures.make_pods(2 * P, **INTERPOD_PODS)]
    for d in bench:
        if d["spec"]["affinity"] is None:
            del d["spec"]["affinity"]
    mixed = interpod_cluster(rng, 1, P, name="m", p_none=0.6)[1]
    pods = bench + mixed
    sched = Scheduler(CAPS, device="cpu")
    sched.add_nodes([obj.Node.from_dict(d) for d in nodes])
    ref = _JaxChain(nodes)
    for k in range(3):
        chunk = pods[k * P:(k + 1) * P]
        got = sched.schedule([obj.Pod.from_dict(d) for d in chunk])
        want, res = ref.schedule(chunk)
        assert got == want, f"batch {k}"
        assert_same(sched.last_result, res, f"batch {k}")
    assert None in got.values()
    assert_ledgers(sched.statedb, ref.db)
    assert sched.encode_cache.hits > 0


def test_fixture_pod_mix_matches_reference():
    mine = fixtures.make_pods(40, **INTERPOD_PODS)
    ref = jfixtures.make_pods(40, **INTERPOD_PODS)
    assert [p.spec.affinity for p in mine] == [p.spec.affinity for p in ref]
    assert sum(bool(p.spec.affinity) for p in mine) == 20
