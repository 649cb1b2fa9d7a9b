"""TaintToleration and NodeAffinity (the tt and na gates) in
kubernetes_tpu_torch against the reference package on the CPU: the plain
counts and both normalizations equal JAX's functions (a zero maximum and a
feasible set without the largest count included); the word form of both
counts, the plain int64 emulation of kernel 2's arithmetic under the
normalization flag, equals the matmul form (duplicate requirements in a
term, weight-0 slots and bit 63 included); `schedule_batch` with tt, na and
both, on the main build and with the spread, interpod, spread+interpod and
gang builds, equals JAX `schedule_batch`; and `Scheduler` on a tainted
cluster equals the reference's StateDB and ledger batch after batch.
Every comparison is exact: counts and scores are integer-valued f32. The
reference is jitted once per gate set (seven in all), at 64 nodes."""

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
from kubernetes_tpu.ops import predicates as jpreds  # noqa: E402
from kubernetes_tpu.ops import priorities as jprios  # noqa: E402
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
from kubernetes_tpu_torch.ops import predicates as preds  # noqa: E402
from kubernetes_tpu_torch.ops import priorities as prios  # noqa: E402
from kubernetes_tpu_torch.ops.assign_scan import (  # noqa: E402
    NORM_SLOTS,
    norm_counts,
    norm_inputs,
    pack_words,
    popcount64,
)
from kubernetes_tpu_torch.ops.solver import (  # noqa: E402
    BatchFlags,
    schedule_batch,
    schedule_batch_plain,
)
from kubernetes_tpu_torch.scheduler import Scheduler  # noqa: E402
from kubernetes_tpu_torch.state import Capacities, encode_cluster  # noqa: E402
from kubernetes_tpu_torch.state.context import EncodeContext  # noqa: E402
from kubernetes_tpu_torch.state.convert import (  # noqa: E402
    batch_from_numpy,
    rr_from_numpy,
    state_from_numpy,
)
from tests.test_torch_interpod import REGION, ZONE, interpod_cluster  # noqa: E402
from tests.test_torch_spread_interpod import SERVICES, _context  # noqa: E402
from tests.test_torch_state import random_cluster  # noqa: E402

N_NODES, P = 64, 16
# random affinity pods intern many terms (as in test_torch_interpod)
CAPS = Capacities(num_nodes=N_NODES, batch_pods=P, term_universe=64)
JCAPS = JCaps(num_nodes=N_NODES, batch_pods=P, term_universe=64)
GATES = ("ipa", "spread", "svcanti", "vol", "attach", "tt", "na", "ports",
         "gpu", "storage", "gang", "preempt")
FIELDS = ("assignments", "scores", "feasible_counts", "new_requested",
          "new_nonzero")
NO_CONTEXT = dict(get_services=lambda ns: [], get_rcs=lambda ns: [],
                  get_rss=lambda ns: [], get_sss=lambda ns: [],
                  list_pods=lambda ns: [])


def jflags(names):
    return jsolver.BatchFlags(*(g in names for g in GATES))


def pflags(names):
    return BatchFlags(*(g in names for g in GATES))


_JAX_SOLVE = {}


def jax_solve(state, batch, rr, flags):
    """JAX schedule_batch under DEFAULT_POLICY with `flags`, jitted once per
    flags value (the XLA static mask)."""
    fn = _JAX_SOLVE.get(flags)
    if fn is None:
        fn = _JAX_SOLVE[flags] = jax.jit(
            lambda s, b, r: jsolver.schedule_batch(s, b, r, J_POLICY, caps=JCAPS,
                                                   flags=flags))
    return fn(state, batch, np.uint32(rr))


def assert_same(got, want, fields=FIELDS, msg=""):
    for name in fields:
        np.testing.assert_array_equal(
            getattr(got, name).cpu().numpy(), np.asarray(getattr(want, name)),
            err_msg=f"{msg} {name}")
    assert int(got.rr_end) == rr_from_numpy(want.rr_end), msg


# preferred-term expressions over both fixtures' node labels; the first is
# written twice in one term (one requirement id)
EXPRS = ([{"key": ZONE, "operator": "In", "values": ["z0"]}] * 2,
         [{"key": ZONE, "operator": "In", "values": ["z1", "z2"]}],
         [{"key": "rack", "operator": "Exists"}],
         [{"key": ZONE, "operator": "NotIn", "values": ["z2"]},
          {"key": REGION, "operator": "Exists"}],
         [{"key": "disk", "operator": "In", "values": ["ssd"]}])
SOFT = ({"key": "soft", "value": "x", "effect": "PreferNoSchedule"},
        {"key": "batch", "value": "y", "effect": "PreferNoSchedule"})


def add_tt_na(rng, nodes, pods, p_terms=0.7):
    """PreferNoSchedule taints (two kinds) on some nodes, their tolerations
    on some pods, and up to four preferred node-affinity terms on a share
    `p_terms` of the pods (weights 1 to 100)."""
    for d in nodes:
        taints = d["spec"].setdefault("taints", [])
        for taint, share in zip(SOFT, (0.3, 0.2)):
            if rng.rand() < share:
                taints.append(dict(taint))
    for d in pods:
        spec = d["spec"]
        u = rng.rand()
        if u < 0.25:
            spec.setdefault("tolerations", []).append(
                {"key": "soft", "operator": "Equal", "value": "x",
                 "effect": "PreferNoSchedule"})
        elif u < 0.4:
            spec.setdefault("tolerations", []).append(
                {"key": "batch", "operator": "Exists"})
        if rng.rand() < p_terms:
            terms = [{"weight": int(rng.choice([1, 5, 10, 100])),
                      "preference": {"matchExpressions": list(
                          EXPRS[rng.randint(len(EXPRS))])}}
                     for _ in range(rng.randint(1, NORM_SLOTS + 1))]
            spec.setdefault("affinity", {}).setdefault("nodeAffinity", {})[
                "preferredDuringSchedulingIgnoredDuringExecution"] = terms
    return nodes, pods


def encode_both(nodes, pods, services=()):
    mine = encode_cluster([obj.Node.from_dict(d) for d in nodes],
                          [obj.Pod.from_dict(d) for d in pods], CAPS,
                          ctx=_context(obj, EncodeContext, list(services)))
    ref = j_encode_cluster([jobj.Node.from_dict(d) for d in nodes],
                           [jobj.Pod.from_dict(d) for d in pods], JCAPS,
                           ctx=_context(jobj, JContext, list(services)))
    return mine, ref


def tt_na_cluster(seed, p_terms=0.7):
    rng = np.random.RandomState(seed)
    nodes, pods = random_cluster(rng, 48, P)
    return add_tt_na(rng, nodes, pods, p_terms)


# ---- (a) the plain counts and normalizations ----

@pytest.mark.parametrize("case", ["random", "zero_max", "max_infeasible",
                                  "none_feasible"])
def test_normalizations_match_reference(case):
    rng = np.random.RandomState(["random", "zero_max", "max_infeasible",
                                 "none_feasible"].index(case))
    n = 40
    counts = rng.randint(0, 6, n).astype(np.float32)
    feasible = rng.rand(n) < 0.6
    if case == "zero_max":            # counts only where infeasible
        counts[feasible] = 0.0
        counts[~feasible] = 7.0
    elif case == "max_infeasible":    # the largest count on an infeasible node
        counts[np.flatnonzero(~feasible)[0]] = 50.0
    elif case == "none_feasible":
        feasible[:] = False
    for mine, ref in ((prios.taint_toleration_from_counts,
                       jprios.taint_toleration_from_counts),
                      (prios.normalized_from_counts, jprios.normalized_from_counts)):
        got = mine(torch.from_numpy(counts), torch.from_numpy(feasible))
        want = np.asarray(ref(counts, feasible))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=mine.__name__)
    if case == "zero_max":   # the maxCount == 0 paths
        assert (np.asarray(jprios.taint_toleration_from_counts(counts, feasible))
                == 10).all()
        assert not np.asarray(jprios.normalized_from_counts(counts, feasible)).any()


@pytest.mark.parametrize("seed", range(2))
def test_plain_counts_and_word_counts_match_reference(seed):
    (state, batch, _), (jstate, jbatch, _) = encode_both(*tt_na_cluster(10 + seed))
    st, b = state_from_numpy(state, "cpu"), batch_from_numpy(batch, "cpu")
    tt = preds.count_untolerated_prefer_taints(st, b)
    na = prios.node_affinity_counts(st, b)
    want_tt = np.stack([np.asarray(jpreds.count_untolerated_prefer_taints(
        jstate, jax.tree.map(lambda a: a[i], jbatch))) for i in range(P)])
    want_na = np.stack([np.asarray(jprios.node_affinity_counts(
        jstate, jax.tree.map(lambda a: a[i], jbatch))) for i in range(P)])
    np.testing.assert_array_equal(tt.numpy(), want_tt)
    np.testing.assert_array_equal(na.numpy(), want_na)
    assert want_tt.any() and want_na.any()
    # the kernel's word form of the same counts
    norm = norm_inputs(1.0, 1.0, st.taint_prefer_member, st.req_member,
                       preds.untolerated(st, b), b.pref_onehot, b.pref_weight)
    for p in range(P):
        wt, wn = norm_counts(norm, p)
        np.testing.assert_array_equal(wt.numpy(), want_tt[p], err_msg=f"tt {p}")
        np.testing.assert_array_equal(wn.numpy(), want_na[p], err_msg=f"na {p}")


def test_word_counts_on_full_words_equal_the_matmul_form():
    """64 taints and 64 requirements (bit 63, the sign bit, in use), terms
    with slots of weight 0 that hold requirements, and random weights."""
    rng = np.random.RandomState(3)
    n, p, u = 80, 12, 64
    prefer = (rng.rand(n, u) < 0.3).astype(np.float32)
    prefer[:, 63] = rng.rand(n) < 0.5
    req = (rng.rand(n, u) < 0.6).astype(np.float32)
    req[:, 63] = 1.0
    untol = (rng.rand(p, u) < 0.5).astype(np.float32)
    onehot = (rng.rand(p, 3, u) < 0.04).astype(np.float32)
    onehot[:, 0, 63] = 1.0
    weight = rng.choice([0.0, 1.0, 7.0, 100.0], (p, 3)).astype(np.float32)
    weight[0, :] = 0.0                   # a pod whose every slot is dead
    onehot[1, 1] = 0.0                   # a weighted slot with no requirement
    weight[1, 1] = 3.0
    pref_count = onehot.sum(-1)
    t = torch.from_numpy
    norm = norm_inputs(1.0, 1.0, t(prefer), t(req), t(untol), t(onehot), t(weight))
    assert norm.pod_terms.shape == (p, NORM_SLOTS)
    assert bool((norm.node_req < 0).all())   # bit 63 packed as the sign bit
    for i in range(p):
        wt, wn = norm_counts(norm, i)
        np.testing.assert_array_equal(wt.numpy(), prefer @ untol[i])
        sat = onehot[i] @ req.T
        want = np.where((sat >= pref_count[i][:, None]) & (weight[i][:, None] > 0),
                        weight[i][:, None], 0.0).sum(0)
        np.testing.assert_array_equal(wn.numpy(), want.astype(np.float32))
    words = torch.tensor([0, -1, 1 << 62, -(1 << 63), 0x5555], dtype=torch.int64)
    assert popcount64(words).tolist() == [0, 64, 1, 1, 8]
    assert pack_words(torch.eye(64)[63:]).tolist() == [-(1 << 63)]
    with pytest.raises(ValueError, match="taints"):
        norm_inputs(1.0, 1.0, t(np.zeros((n, 65), np.float32)), t(req),
                    t(np.zeros((p, 65), np.float32)), t(onehot), t(weight))


# ---- (b) schedule_batch with the gates ----

@pytest.mark.parametrize("gates", ["tt", "na", "tt+na"])
def test_schedule_batch_matches_reference(gates):
    names = gates.split("+")
    (state, batch, _), (jstate, jbatch, jtable) = encode_both(*tt_na_cluster(20))
    assert jsolver.batch_flags(jbatch, P, jtable) == jflags(("tt", "na"))
    rr = {"tt": 0, "na": 5, "tt+na": 2**32 - 2}[gates]
    want = jax_solve(jstate, jbatch, rr, jflags(names))
    dstate, dbatch = state_from_numpy(state, "cpu"), batch_from_numpy(batch, "cpu")
    assert_same(schedule_batch(dstate, dbatch, rr, flags=pflags(names)), want)
    assert_same(schedule_batch_plain(dstate, dbatch, rr, flags=pflags(names)),
                want, msg="plain")
    # the reference's own encoding carried across (taint_prefer_member,
    # req_member and the pref_* columns included)
    assert_same(schedule_batch(state_from_numpy(jstate, "cpu"),
                               batch_from_numpy(jbatch, "cpu"), rr,
                               flags=pflags(names)), want, msg="carried")
    assert (np.asarray(want.assignments) >= 0).sum() > P // 2


def _gang_rows(batch):
    """Groups of 4 (quorum 4), 3 (quorum 2) and 4 (quorum 4) in rows 0-3,
    5-7 and 9-12."""
    for gid, rows, quorum in ((1, range(0, 4), 4), (2, range(5, 8), 2),
                              (3, range(9, 13), 4)):
        batch.gang_id[list(rows)] = gid
        batch.gang_min[list(rows)] = quorum


@pytest.mark.parametrize("build", ["spread", "ipa", "spread+ipa", "gang"])
def test_schedule_batch_with_another_build_matches_reference(build):
    fields = FIELDS
    if build == "gang":
        (state, batch, _), (jstate, jbatch, _) = encode_both(*tt_na_cluster(30))
        _gang_rows(batch)
        _gang_rows(jbatch)
        names = ("tt", "na", "gang")
    else:
        rng = np.random.RandomState(40 + len(build))
        nodes, pods, _ = interpod_cluster(rng, 48, P,
                                          p_none=1.0 if build == "spread" else 0.4)
        add_tt_na(rng, nodes, pods)
        spread = "spread" in build
        (state, batch, _), (jstate, jbatch, jtable) = encode_both(
            nodes, pods, SERVICES if spread else ())
        names = ("tt", "na") + (("spread", "svcanti") if spread else ()) + (
            ("ipa",) if "ipa" in build else ())
        assert jsolver.batch_flags(jbatch, P, jtable) == jflags(names)
        fields = FIELDS + ("new_podsel",) + (("new_term",) if "ipa" in build else ())
    want = jax_solve(jstate, jbatch, 7, jflags(names))
    dstate, dbatch = state_from_numpy(state, "cpu"), batch_from_numpy(batch, "cpu")
    assert_same(schedule_batch(dstate, dbatch, 7, flags=pflags(names), caps=CAPS),
                want, fields)
    assert (np.asarray(want.assignments) >= 0).any()


def test_a_taint_universe_past_the_words_raises():
    """The flag's words hold 64 taints and 64 requirements: a wider
    universe raises ValueError naming them."""
    caps = Capacities(num_nodes=N_NODES, batch_pods=P, taint_universe=72)
    nodes, pods = tt_na_cluster(50)
    state, batch, _ = encode_cluster([obj.Node.from_dict(d) for d in nodes],
                                     [obj.Pod.from_dict(d) for d in pods], caps)
    with pytest.raises(ValueError, match="72 taints"):
        schedule_batch(state_from_numpy(state, "cpu"),
                       batch_from_numpy(batch, "cpu"), 0,
                       flags=pflags(("tt", "na")), caps=caps)


# ---- (c) Scheduler against the reference's driver flow ----

class _JaxChain:
    """The reference package's StateDB, encode cache, schedule_batch and
    commit, as its driver runs them."""

    def __init__(self, nodes):
        ctx = JContext(**NO_CONTEXT)
        self.db = JStateDB(JCAPS, volume_ctx=ctx)
        for d in nodes:
            self.db.upsert_node(jobj.Node.from_dict(d))
        self.cache = JEncodeCache(JCAPS, self.db.table, volume_ctx=ctx)
        self.rr = 0

    def schedule(self, pod_dicts):
        pods = [jobj.Pod.from_dict(d) for d in pod_dicts]
        fblob, iblob = j_pack_batch(j_empty_batch(JCAPS), JCAPS)
        for i, pod in enumerate(pods):
            self.cache.encode_packed_into(fblob, iblob, i, pod)
        batch = j_unpack_batch(fblob, iblob, JCAPS)
        flags = jsolver.batch_flags(batch, len(pods), self.db.table)
        assert flags == jflags(("tt", "na"))
        res = jax_solve(self.db.flush(), batch, self.rr, flags)
        rows = np.asarray(res.assignments)
        names = [self.db.table.name_of[r] if r >= 0 else None
                 for r in rows[:len(pods)]]
        self.db.commit_batch(res, fblob, [(p, n, i) for i, (p, n)
                                          in enumerate(zip(pods, names)) if n])
        self.rr = rr_from_numpy(res.rr_end)
        return {p.key: n for p, n in zip(pods, names)}, res


def test_scheduler_chains_tainted_batches_like_the_reference():
    rng = np.random.RandomState(60)
    nodes, pods = random_cluster(rng, 40, 3 * P)
    add_tt_na(rng, nodes, pods, p_terms=1.0)
    for i, d in enumerate(pods):
        d["metadata"]["name"] = f"t{i}"
    sched = Scheduler(CAPS, device="cpu")
    sched.add_nodes([obj.Node.from_dict(d) for d in nodes])
    ref = _JaxChain(nodes)
    for k in range(3):
        chunk = pods[k * P:(k + 1) * P]
        got = sched.schedule([obj.Pod.from_dict(d) for d in chunk])
        want, res = ref.schedule(chunk)
        assert got == want, f"batch {k}"
        assert_same(sched.last_result, res, msg=f"batch {k}")
        np.testing.assert_array_equal(sched.statedb.host.requested,
                                      np.asarray(ref.db.host.requested))
        np.testing.assert_array_equal(sched.statedb.host.nonzero_requested,
                                      np.asarray(ref.db.host.nonzero_requested))
    assert None in got.values()
    assert int(sched.rr) == ref.rr


def test_reciprocal_division_equals_f32_division():
    """Kernel 2 divides the flag's counts by the feasible maxima as
    (float)((double)n * r), r the double reciprocal of the maximum: for
    every TaintToleration quotient c / M (c <= M <= 64) and NodeAffinity's
    10 c / M over weight sums up to 4 * 65,535, that is the f32 quotient."""
    rng = np.random.RandomState(7)
    m = np.arange(1, 65, dtype=np.float64)[:, None]
    c = np.arange(0, 65, dtype=np.float64)[None, :].repeat(64, 0)
    c = np.minimum(c, m)
    m_na = np.concatenate([np.arange(1, 2000), rng.randint(1, 4 * 65535 + 1, 20000)])
    c_na = np.floor(rng.rand(m_na.size) * (m_na + 1))
    c_na[:m_na.size // 4] = m_na[:m_na.size // 4]   # c = M: the quotient 10
    for n, y in ((c, np.broadcast_to(m, c.shape)), (10 * c_na, m_na)):
        got = (n * (1.0 / y)).astype(np.float32)
        want = n.astype(np.float32) / y.astype(np.float32)
        np.testing.assert_array_equal(got, want)
