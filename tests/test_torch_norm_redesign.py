"""Numpy models of the main and gang builds' chain under the normalization
flag in csrc/assign_scan.cu (TaintToleration and NodeAffinity), held
against the reference package on the CPU:

- the speculate-check-redo scan: each pod scored with the maxima a table
  keyed by its row of words guesses, the block's true maxima packed into
  the triple's free word, every block's check of the cluster's maxima
  against the guess, and on a miss the pod scored again with the true
  maxima and selected on that round; through the port's solver in place of
  the scan, against JAX `schedule_batch` with the tt and na gates, on the
  main build and on the gang build with a revert;
- traffics that force misses: the only nodes holding the maximum fill up,
  the maxima drop to 0, two rows share a table key, and more classes
  alternate than the table holds;
- the packed word at its extremes (64 taints; 4 weights of 65,535);
- the count cache (counts taken again only when a pod's words differ from
  the previous pod's) against `norm_counts` and JAX's counts, with the
  feasible set changing between pods.

Every comparison is exact."""

import jax
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import predicates as jpreds
from kubernetes_tpu.ops import priorities as jprios
from kubernetes_tpu_torch.models.policy import DEFAULT_POLICY
from kubernetes_tpu_torch.ops import solver
from kubernetes_tpu_torch.ops.assign_scan import (
    NORM_SLOTS,
    NORM_TABLE,
    NormMaximaTable,
    ScanResult,
    assign_scan_interpod_plain,
    assign_scan_spread_interpod_plain,
    assign_scan_spread_plain,
    norm_counts,
    norm_exchanges,
    norm_inputs,
    norm_key_weight,
    norm_pack,
    norm_pod_rows,
    norm_row_key,
    norm_table_misses,
    norm_true_maxima,
)
from kubernetes_tpu_torch.ops.predicates import fits_resources_dyn, untolerated
from kubernetes_tpu_torch.ops.priorities import balanced_allocation, least_requested
from kubernetes_tpu_torch.state.convert import batch_from_numpy, state_from_numpy
from tests.test_torch_tt_na import (
    CAPS,
    P,
    _gang_rows,
    assert_same,
    encode_both,
    jax_solve,
    jflags,
    pflags,
    tt_na_cluster,
)

F32, F64 = np.float32, np.float64
CLUSTER = 16
EPS = F32(1e-6)
TEN = F32(10.0)
U32 = 0xFFFFFFFF


# ---- the kernel's arithmetic of the flag

CT, CN_SHIFT = 0xFF, 8      # norm_raw_counts' packing (norm_counts')


def _norm_score(norm, c, word):
    """f32[N]: norm_score of packed counts `c` against the packed maxima
    `word` with the score's weights, f32 operation by operation, dividing
    by multiplying with the double reciprocal of max(M, 1)."""
    m_tt, m_na = F32(word & 0xFF), F32(word >> 8)
    ct = (c & CT).astype(F32)
    cn = (c >> CN_SHIFT).astype(F32)
    r_tt = F64(1.0) / F64(max(m_tt, F32(1.0)))
    r_na = F64(1.0) / F64(max(m_na, F32(1.0)))
    if m_tt > 0:
        tt = np.trunc(((F32(1.0) - (ct.astype(F64) * r_tt).astype(F32)) * TEN) + EPS)
    else:
        tt = np.full(c.shape, TEN, F32)
    if m_na > 0:
        na = np.trunc(((cn * TEN).astype(F64) * r_na).astype(F32) + EPS)
    else:
        na = np.zeros(c.shape, F32)
    return (F32(norm.w_tt) * tt.astype(F32) + F32(norm.w_na) * na.astype(F32)).astype(F32)


def _raw_counts(norm, p):
    """u32[N]: pod p's raw packed counts at every node as norm_raw_counts
    packs them (untolerated taints in bits 0-7, the met terms' weights from
    bit 8), each 0 where the pod's count cannot be nonzero."""
    taint = norm.node_taint.numpy().view(np.uint64)
    req = norm.node_req.numpy().view(np.uint64)
    untol = np.uint64(norm.pod_untol[p].numpy().view(np.uint64))
    terms = norm.pod_terms[p].numpy().view(np.uint64)
    wts = [int(w) if w > 0 else 0 for w in norm.pod_weights[p].tolist()]
    ct = np.zeros(taint.shape, np.int64)
    if bool(norm.w_tt) and untol != 0:
        ct = np.array([bin(int(v)).count("1") for v in taint & untol], np.int64)
    cn = np.zeros(taint.shape, np.int64)
    if bool(norm.w_na) and any(wts):
        for k in range(NORM_SLOTS):
            cn += np.where((req & terms[k]) == terms[k], wts[k], 0)
    return (ct | cn << CN_SHIFT).astype(np.uint32)


def _packed_maxima(c, feasible, nb):
    """The cluster's maxima as every block sends them in the triple's free
    word: each block's (over its nb nodes) packed, then the lanes' max of
    each field."""
    n = c.shape[0]
    words = []
    for b in range(CLUSTER):
        sl = slice(b * nb, min((b + 1) * nb, n))
        cb, fb = c[sl], feasible[sl]
        mt = int((cb[fb] & CT).max(initial=0))
        mn = int((cb[fb] >> CN_SHIFT).max(initial=0))
        word = norm_pack(mt, mn)
        assert 0 <= word < 1 << 26
        words.append(word)
    mt = max(w & 0xFF for w in words)
    mn = max(w >> 8 for w in words)
    return norm_pack(mt, mn)


class _Model:
    """The main and gang builds' chain with the flag, pod by pod: the scan
    (`assign_scan_plain`'s signature, with `gang`), counting hits, misses
    and the counts taken again. `key` and `entries` set the table (the
    kernel's: norm_row_key, NORM_TABLE)."""

    def __init__(self, key=norm_row_key, entries=NORM_TABLE, threads=4, run=1):
        self.key, self.entries = key, entries
        self.nb = threads * run      # nodes a block, so the 16 blocks differ
        self.hits = self.misses = self.recounts = self.diverged = 0
        self.maxima: list = []

    def scan(self, masked_static, requests, nonzero_requests, allocatable, requested,
             nonzero, rr_start, w_lr, w_ba, *rest):
        gang = rest[0] if len(rest) == 2 else None
        norm = rest[-1]
        assert norm is not None
        p_count, n = masked_static.shape
        assert n <= CLUSTER * self.nb
        table = NormMaximaTable(self.entries)
        rows = norm_pod_rows(norm).numpy()
        exch = norm_exchanges(norm)
        req, nz = requested.clone(), nonzero.clone()
        rr = int(rr_start) % (1 << 32)
        out_a = np.full(p_count, -1, np.int32)
        out_s = np.zeros(p_count, F32)
        out_f = np.zeros(p_count, np.int32)
        cnt, cnt_ok = None, False
        ids = gang.gang_id.tolist() if gang is not None else [0] * p_count
        mins = gang.gang_min.tolist() if gang is not None else [0] * p_count
        gang_cur, placed, quorum, snap = 0, 0, 0, None
        for p in range(p_count):
            if ids[p] != gang_cur:   # settle the group left, open the pod's
                if gang_cur > 0 and placed < quorum:
                    req, nz, rr = snap[0].clone(), snap[1].clone(), snap[2]
                if ids[p] > 0:
                    snap, placed, quorum = (req.clone(), nz.clone(), rr), 0, mins[p]
                gang_cur = ids[p]
            ms = masked_static[p].numpy()
            feasible = ((ms > -np.inf) & fits_resources_dyn(
                allocatable, requests[p:p + 1], req, dyn_gpu=False,
                dyn_storage=False)[0].numpy())
            lr = least_requested(allocatable, nonzero_requests[p:p + 1], nz)[0].numpy()
            ba = balanced_allocation(allocatable, nonzero_requests[p:p + 1], nz)[0].numpy()

            def select(flag):
                sc = (((ms + flag).astype(F32) + F32(w_lr) * lr).astype(F32)
                      + F32(w_ba) * ba).astype(F32)
                sc = np.where(feasible, sc + F32(0.0), -np.inf).astype(F32)
                if not feasible.any():
                    return -1, F32(0.0)
                best = sc.max()
                ties = np.flatnonzero(feasible & (sc == best))
                return int(ties[rr % len(ties)]), best

            if exch[p]:
                if not (cnt_ok and np.array_equal(rows[p], rows[p - 1])):
                    cnt = _raw_counts(norm, p)
                    self.recounts += 1
                cnt_ok = True
                word = _packed_maxima(cnt, feasible, self.nb)
                self.maxima.append(word)
                k = self.key(rows[p])
                guess, at = table.guess(k)
                first = select(_norm_score(norm, cnt, guess))
                table.settle(k, at, word)
                if word == guess:
                    self.hits += 1
                    node, best = first
                else:   # the second round, with the true maxima
                    self.misses += 1
                    node, best = select(_norm_score(norm, cnt, word))
                    self.diverged += (node, best) != first
            else:
                cnt_ok = False
                self.maxima.append(None)
                node, best = select(np.full(n, F32(norm.w_tt) * TEN
                                            + F32(norm.w_na) * F32(0.0), F32))
            out_f[p] = int(feasible.sum())
            if node >= 0:
                out_a[p], out_s[p] = node, best
                req[node] += requests[p]
                nz[node] += nonzero_requests[p]
                rr = (rr + 1) % (1 << 32)
                placed += gang_cur > 0
        if gang_cur > 0 and placed < quorum:
            req, nz, rr = snap
        return ScanResult(torch.from_numpy(out_a), torch.from_numpy(out_s),
                          torch.from_numpy(out_f), req, nz,
                          torch.tensor(rr, dtype=torch.int64))


def _class_cluster(seed, classes):
    """Roomy nodes (64 cpus, 110 pods) in tiers a-c and racks r0-r2, a third
    of them with a PreferNoSchedule taint, and pods of `classes` classes in
    turn: class k prefers tier k % 3 (weight 10 (k + 1)) and rack k % 3
    (weight k + 1), and tolerates the taint when k is even. Each class
    keeps its own maxima (11 (k + 1) where a node meets both) through the
    batch."""
    rng = np.random.RandomState(seed)
    nodes = []
    for i in range(48):
        taints = ([{"key": "soft", "value": "x", "effect": "PreferNoSchedule"}]
                  if rng.rand() < 0.33 else [])
        nodes.append({"metadata": {"name": f"n{i}", "labels": {
                          "kubernetes.io/hostname": f"n{i}", "tier": "abc"[i % 3],
                          "rack": f"r{rng.randint(3)}"}},
                      "spec": {"taints": taints},
                      "status": {"allocatable": {"cpu": "64", "memory": "64Gi",
                                                 "pods": "110"},
                                 "conditions": [{"type": "Ready", "status": "True"}]}})
    pods = []
    for i in range(P):
        k = i % classes
        spec = {"containers": [{"name": "c", "image": "k8s.gcr.io/pause:3.0",
                                "resources": {"requests": {"cpu": "250m",
                                                           "memory": "256Mi"}}}],
                "affinity": {"nodeAffinity": {
                    "preferredDuringSchedulingIgnoredDuringExecution": [
                        {"weight": 10 * (k + 1), "preference": {"matchExpressions": [
                            {"key": "tier", "operator": "In", "values": ["abc"[k % 3]]}]}},
                        {"weight": k + 1, "preference": {"matchExpressions": [
                            {"key": "rack", "operator": "In", "values": [f"r{k % 3}"]}]}}]}}}
        if k % 2 == 0:
            spec["tolerations"] = [{"key": "soft", "operator": "Exists"}]
        pods.append({"metadata": {"name": f"p{i}"}, "spec": spec})
    return nodes, pods


def _solve_with(model, state, batch, rr, names):
    """The port's solver with the model in place of the main and gang
    scans (the other builds' plain versions, unused)."""
    return solver._solve(state, batch, rr, DEFAULT_POLICY, pflags(names), CAPS, None,
                         solver.static_mask_plain, model.scan, assign_scan_spread_plain,
                         assign_scan_interpod_plain, model.scan,
                         assign_scan_spread_interpod_plain)


def _cluster(seed, gang=False, classes=0):
    """A batch encoded both ways (gang: _gang_rows' groups): tt_na_cluster's,
    or with `classes`, _class_cluster's."""
    nodes, pods = _class_cluster(seed, classes) if classes else tt_na_cluster(seed)
    (state, batch, _), (jstate, jbatch, _) = encode_both(nodes, pods)
    if gang:
        _gang_rows(batch)
        _gang_rows(jbatch)
    return (state_from_numpy(state, "cpu"), batch_from_numpy(batch, "cpu"),
            jstate, jbatch)


# ---- (a) the speculate-check-redo scan against JAX

def _scan_args(st, b, names, rr):
    """The main or gang scan's operands as the port's solver makes them."""
    g = solver.check_supported(DEFAULT_POLICY, pflags(names))
    masked = solver.masked_static_scores(st, b, DEFAULT_POLICY, g)
    args = [masked, b.requests, b.nonzero_requests, st.allocatable, st.requested,
            st.nonzero_requested, rr, float(g.w_lr), float(g.w_ba)]
    if "gang" in names:
        args.append(solver.GangInputs(gang_id=b.gang_id.contiguous(),
                                      gang_min=b.gang_min.contiguous()))
    return (*args, solver.scan_norm_inputs(st, b, g))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("gang", [False, True])
def test_guess_check_redo_scan_matches_reference(seed, gang):
    names = ("tt", "na") + (("gang",) if gang else ())
    st, b, jstate, jbatch = _cluster(50 + seed, gang)
    rr = [0, 3, 2**32 - 1][seed]
    want = jax_solve(jstate, jbatch, rr, jflags(names))
    model = _Model()
    assert_same(_solve_with(model, st, b, rr, names), want)
    exchanging = sum(norm_exchanges(_scan_args(st, b, names, rr)[-1]))
    assert model.hits + model.misses == exchanging > 0
    assert model.misses > 0   # the first pod of each key at least


def test_gang_build_revert_matches_reference():
    """A group that places members and then reverts (its last member fits
    nowhere): the ledger restored, and the guesses and checks of the pods
    after it, equal JAX."""
    names = ("tt", "na", "gang")
    (state, batch, _), (jstate, jbatch, _) = encode_both(*tt_na_cluster(60))
    _gang_rows(batch)
    _gang_rows(jbatch)
    for host in (batch, jbatch):   # group 1's last member requests 10^6 cpus
        host.requests[3, 1] = 1e9
    st, b = state_from_numpy(state, "cpu"), batch_from_numpy(batch, "cpu")
    want = jax_solve(jstate, jbatch, 1, jflags(names))
    raw = _Model().scan(*_scan_args(st, b, names, 1))
    assert (raw.assignments[:3] >= 0).any()            # placed members
    assert (np.asarray(want.assignments)[:4] == -1).all()   # then reverted
    assert (np.asarray(want.assignments)[4:] >= 0).any()
    model = _Model()
    assert_same(_solve_with(model, st, b, 1, names), want)
    assert model.misses > 0 and model.hits > 0


# ---- (b) traffics that force misses

def _hot_cluster():
    """Nodes and pods where the only nodes holding the maxima fill up: every
    pod prefers tier a (weight 60) and rack r1 (weight 40) and tolerates
    no PreferNoSchedule taint; node 0 is in both (sum 100), node 1 in tier
    a only (60), node 2 in rack r1 only (40), the other 45 in neither, and
    nodes 0-2 take two pods each; the taint is on node 3 alone, which takes
    no pod. So NodeAffinity's maximum goes 100, 60, 40, 0 and
    TaintToleration's is 0 with an exchange."""
    nodes = []
    for i in range(48):
        labels = {"kubernetes.io/hostname": f"n{i}",
                  "tier": "a" if i in (0, 1) else "c",
                  "rack": "r1" if i in (0, 2) else "r9"}
        taints = ([{"key": "soft", "value": "x", "effect": "PreferNoSchedule"}]
                  if i == 3 else [])
        nodes.append({"metadata": {"name": f"n{i}", "labels": labels},
                      "spec": {"taints": taints},
                      "status": {"allocatable": {
                          "cpu": "64" if i < 3 else "4",
                          "memory": "64Gi" if i < 3 else "8Gi",
                          "pods": "2" if i < 3 else "0" if i == 3 else "4"},
                          "conditions": [{"type": "Ready", "status": "True"}]}})
    prefer = [{"weight": 60, "preference": {"matchExpressions": [
                  {"key": "tier", "operator": "In", "values": ["a"]}]}},
              {"weight": 40, "preference": {"matchExpressions": [
                  {"key": "rack", "operator": "In", "values": ["r1"]}]}}]
    pods = [{"metadata": {"name": f"p{i}"},
             "spec": {"containers": [{"name": "c", "image": "k8s.gcr.io/pause:3.0",
                                      "resources": {"requests": {
                                          "cpu": "100m", "memory": "128Mi"}}}],
                      "affinity": {"nodeAffinity": {
                          "preferredDuringSchedulingIgnoredDuringExecution": prefer}}}}
            for i in range(P)]
    return nodes, pods


def test_a_filling_maximum_and_zero_maxima_force_misses():
    names = ("tt", "na")
    (state, batch, _), (jstate, jbatch, _) = encode_both(*_hot_cluster())
    st, b = state_from_numpy(state, "cpu"), batch_from_numpy(batch, "cpu")
    want = jax_solve(jstate, jbatch, 0, jflags(names))
    assert np.asarray(want.assignments)[:6].tolist() == [0, 0, 1, 1, 2, 2]
    model = _Model()
    assert_same(_solve_with(model, st, b, 0, names), want)
    na = [w >> 8 for w in model.maxima]
    assert na[:7] == [100, 100, 60, 60, 40, 40, 0] and set(na[6:]) == {0}
    assert [w & 0xFF for w in model.maxima] == [0] * P
    assert model.misses == 4   # the first pod, then each fall


@pytest.mark.parametrize("gang", [False, True])
def test_colliding_keys_force_misses(gang):
    """Every row one key: classes with other maxima evict each other's."""
    names = ("tt", "na") + (("gang",) if gang else ())
    st, b, jstate, jbatch = _cluster(90, gang, classes=3)
    want = jax_solve(jstate, jbatch, 5, jflags(names))
    model, alone = _Model(key=lambda row: 0), _Model()
    assert_same(_solve_with(model, st, b, 5, names), want)
    assert_same(_solve_with(alone, st, b, 5, names), want)
    assert model.hits == 0 and alone.misses == 3


@pytest.mark.parametrize("gang", [False, True])
def test_more_classes_than_the_table_holds_force_misses(gang):
    """A table of 2 entries over 3 classes in turn: first in, first out
    evicts each key before it comes back, so every pod misses."""
    names = ("tt", "na") + (("gang",) if gang else ())
    st, b, jstate, jbatch = _cluster(91, gang, classes=3)
    want = jax_solve(jstate, jbatch, 2**31, jflags(names))
    small, full = _Model(entries=2), _Model()
    assert_same(_solve_with(small, st, b, 2**31, names), want)
    assert_same(_solve_with(full, st, b, 2**31, names), want)
    assert small.hits == 0 and full.misses == 3


def test_the_table_evicts_first_in_and_keeps_a_key_in_place():
    table = NormMaximaTable()
    keys = list(range(NORM_TABLE + 8))
    # 40 keys cycling through 32 entries: every pod misses
    assert all(table.step(k, 7 + k) for _ in range(3) for k in keys)
    table = NormMaximaTable()
    assert [table.step(k, 1) for k in (5, 6, 5, 6)] == [True, True, False, False]
    assert table.step(5, 2) and not table.step(6, 1)   # its own entry, new maxima
    assert table.keys[:2] == [5, 6]


def test_host_replay_counts_the_models_misses():
    """norm_true_maxima and norm_table_misses (what chip_smoke.py counts)
    give the model's maxima and misses, gang revert included."""
    for seed, gang in ((50, False), (51, True)):
        names = ("tt", "na") + (("gang",) if gang else ())
        st, b, _j, _jb = _cluster(seed, gang)
        args = _scan_args(st, b, names, 3)
        model = _Model()
        raw = model.scan(*args)
        gang_in = args[9] if gang else None
        maxima = norm_true_maxima(args[0], args[1], args[3], args[4], args[-1],
                                  raw.assignments, gang_in)
        assert maxima == model.maxima
        misses = norm_table_misses(args[-1], maxima)
        assert sum(m is True for m in misses) == model.misses
        assert sum(m is False for m in misses) == model.hits


def test_colliding_rows_share_one_key():
    """Two rows that differ in their words and in an unweighted term slot
    solved for one key (as chip_smoke.py's collide traffic makes them) are
    one entry of the table."""
    a = np.zeros(16, np.int64)
    a[0] = 1
    b = a.copy()
    b[0] = 5
    b[9] = ((norm_row_key(a) - norm_row_key(b))
            * pow(norm_key_weight(9), -1, 1 << 32)) % (1 << 32)
    assert norm_row_key(b) == norm_row_key(a) and not np.array_equal(a, b)
    table = NormMaximaTable()
    assert table.step(norm_row_key(a), 1) and table.step(norm_row_key(b), 2)
    assert table.keys.count(norm_row_key(a)) == 1
    # the key is the warp's: one product a lane, added mod 2^32
    lanes = [(int(v) & U32) * norm_key_weight(l) for l, v in enumerate(b)]
    assert sum(lanes) % (1 << 32) == norm_row_key(b)
    assert all(norm_key_weight(l) % 2 == 1 for l in range(16))


# ---- (c) the packed word at its extremes

def test_packed_maxima_at_their_extremes_match_reference():
    """64 untolerated taints on one node and 4 terms of weight 65,535 met
    on another: the packed word is a non-negative int below 2^26, unpacks
    to both maxima, and the scores of both normalizations at those maxima
    equal JAX's."""
    n = 6
    untol = np.ones((1, 64), np.float32)
    prefer = np.zeros((n, 64), np.float32)
    prefer[0] = 1.0
    prefer[1, :7] = 1.0
    req = np.zeros((n, 64), np.float32)
    req[2] = 1.0
    req[3, :2] = 1.0
    onehot = np.zeros((1, NORM_SLOTS, 64), np.float32)
    for k in range(NORM_SLOTS):
        onehot[0, k, k] = 1.0
    weight = np.full((1, NORM_SLOTS), 65535.0, np.float32)
    t = torch.from_numpy
    norm = norm_inputs(1.0, 1.0, t(prefer), t(req), t(untol), t(onehot), t(weight))
    c = _raw_counts(norm, 0)
    feasible = np.ones(n, bool)
    word = _packed_maxima(c, feasible, 4)
    assert word == norm_pack(64, 4 * 65535) == 64 | (4 * 65535) << 8
    assert 0 <= word < 1 << 26 and np.int32(word) == word
    assert (word & 0xFF, word >> 8) == (64, 262140)
    ct, cn = (c & CT).astype(np.float32), (c >> CN_SHIFT).astype(np.float32)
    assert ct.tolist() == [64, 7, 0, 0, 0, 0] and cn.max() == 262140
    tt, na = norm_counts(norm, 0)
    np.testing.assert_array_equal(tt.numpy(), ct)
    np.testing.assert_array_equal(na.numpy(), cn)
    # the terms at those maxima, one weight at a time, against JAX's
    # normalizations (counts 64, 7 and 0; sums 262,140, 131,070 and 0)
    want_tt = np.asarray(jprios.taint_toleration_from_counts(ct, feasible))
    want_na = np.asarray(jprios.normalized_from_counts(cn, feasible))
    for w_tt, w_na, want in ((1.0, 0.0, want_tt), (0.0, 1.0, want_na),
                             (3.0, 2.0, 3 * want_tt + 2 * want_na)):
        v = norm_inputs(w_tt, w_na, t(prefer), t(req), t(untol), t(onehot), t(weight))
        np.testing.assert_array_equal(_norm_score(v, c, word), want.astype(np.float32))


# ---- (d) the count cache

def test_count_cache_matches_norm_counts_and_reference():
    """A sequence of pods in runs of one pod's words and of others', the
    feasible set drawn anew at each: the counts kept (taken again only
    where a row differs from the previous one, or the previous pod
    exchanged nothing) equal norm_counts' and JAX's at every pod, and the
    feasible maxima from them JAX's."""
    rng = np.random.RandomState(11)
    (state, batch, _), (jstate, jbatch, _) = encode_both(*tt_na_cluster(12))
    st, b = state_from_numpy(state, "cpu"), batch_from_numpy(batch, "cpu")
    norm = norm_inputs(1.0, 1.0, st.taint_prefer_member, st.req_member,
                       untolerated(st, b), b.pref_onehot, b.pref_weight)
    rows = norm_pod_rows(norm).numpy()
    exch = norm_exchanges(norm)
    live = [q for q in range(P) if exch[q]]
    order = [live[i] for i in (0, 0, 0, 1, 1, 2, 0, 0, 3, 3, 3, 1, 4, 4, 5, 5, 0)]
    order[9:9] = [q for q in range(P) if not exch[q]][:1]   # a quiet pod in a run
    cnt, ok, prev, recounts = None, False, None, 0
    for q in order:
        if not exch[q]:
            ok = False
            prev = q
            continue
        if not (ok and np.array_equal(rows[q], rows[prev])):
            cnt, recounts = _raw_counts(norm, q), recounts + 1
        ok, prev = True, q
        tt, na = norm_counts(norm, q)
        pod = jax.tree.map(lambda a: np.asarray(a)[q], jbatch)
        jtt = np.asarray(jpreds.count_untolerated_prefer_taints(jstate, pod))
        jna = np.asarray(jprios.node_affinity_counts(jstate, pod))
        tt_on = int(norm.pod_untol[q]) != 0
        na_on = bool((norm.pod_weights[q] > 0).any())
        ct = (cnt & CT).astype(np.float32)
        cn = (cnt >> CN_SHIFT).astype(np.float32)
        np.testing.assert_array_equal(ct, tt.numpy() if tt_on else 0 * ct)
        np.testing.assert_array_equal(cn, na.numpy() if na_on else 0 * cn)
        if tt_on:
            np.testing.assert_array_equal(ct, jtt)
        if na_on:
            np.testing.assert_array_equal(cn, jna)
        feasible = rng.rand(ct.shape[0]) < 0.5
        word = _packed_maxima(cnt, feasible, 4)
        assert word & 0xFF == (jtt[feasible].max(initial=0) if tt_on else 0)
        assert word >> 8 == (jna[feasible].max(initial=0) if na_on else 0)
    # runs of one pod's rows reused their counts: 10 runs in 18 pods
    assert recounts == 10 and sum(exch[q] for q in order) == 17
