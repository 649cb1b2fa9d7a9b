"""Numpy models of the spread and interpod builds' chains under the
normalization flag in csrc/assign_scan.cu (TaintToleration and
NodeAffinity), held against the reference package on the CPU:

- the guess-check-redo scan: each pod scored with the maxima a table keyed
  by its row of words guesses, the block's true maxima over its feasible
  nodes packed into the triple's free word (feasible: the static row and
  the ledger fit, and in the interpod build the inter-pod predicate too),
  every block's check, and on a miss the pod scored again with the true
  maxima, SelectorSpread or the inter-pod priority kept from the first
  round; through the port's solver in place of the spread or interpod
  scan, against JAX `schedule_batch` with the spread, tt and na gates
  (pods with and without a spread entry) and with the ipa, tt and na gates
  (pods that count and pods that do not, and a miss the predicate causes);
- traffics that force misses (the maxima filling up, colliding keys, more
  classes than the table holds) on both builds;
- the host replay (`norm_true_maxima` with the interpod predicate,
  `norm_table_misses`) against the model's maxima and misses, and against
  the plain interpod scan's placements;
- the count cache across runs of equal and differing words, with the
  feasible set (the fit, and the predicate) changing between them.

Every comparison is exact."""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import predicates as jpreds
from kubernetes_tpu.ops import priorities as jprios
from kubernetes_tpu_torch.models.policy import DEFAULT_POLICY
from kubernetes_tpu_torch.ops import solver
from kubernetes_tpu_torch.ops.assign_scan import (
    NORM_TABLE,
    POD_ROW_FIELDS,
    NormMaximaTable,
    ScanResult,
    assign_scan_gang_plain,
    assign_scan_interpod_plain,
    assign_scan_plain,
    assign_scan_spread_interpod_plain,
    assign_scan_spread_plain,
    norm_exchanges,
    norm_pod_rows,
    norm_row_key,
    norm_table_misses,
    norm_true_maxima,
)
from kubernetes_tpu_torch.ops.interpod import (
    interpod_counts,
    interpod_feasible,
    interpod_score,
    ledger_add,
    make_ledger,
    topology_onehot,
)
from kubernetes_tpu_torch.ops.predicates import fits_resources_dyn
from kubernetes_tpu_torch.ops.priorities import balanced_allocation, least_requested
from kubernetes_tpu_torch.ops.spread import selector_spread
from kubernetes_tpu_torch.state.convert import batch_from_numpy, state_from_numpy
from tests.test_torch_interpod import HOST, ZONE, interpod_cluster
from tests.test_torch_norm_redesign import (
    CN_SHIFT,
    CT,
    TEN,
    _norm_score,
    _packed_maxima,
    _raw_counts,
)
from tests.test_torch_spread_interpod import SERVICES
from tests.test_torch_tt_na import (
    CAPS,
    EXPRS,
    P,
    add_tt_na,
    assert_same,
    encode_both,
    jax_solve,
    jflags,
    pflags,
)

F32 = np.float32
SPREAD_GATES = ("tt", "na", "spread", "svcanti")
IPA_GATES = ("tt", "na", "ipa")
# the fields of a spread or interpod solve
FIELDS = ("assignments", "scores", "feasible_counts", "new_requested", "new_nonzero",
          "new_podsel")


class _Model:
    """The spread or interpod build's chain with the flag, pod by pod: a
    scan with assign_scan_spread_plain's or assign_scan_interpod_plain's
    signature, counting hits, misses and the counts taken again, and the
    pods that ran without a spread entry or without an inter-pod count.
    `key` and `entries` set the table (the kernel's: norm_row_key,
    NORM_TABLE)."""

    def __init__(self, key=norm_row_key, entries=NORM_TABLE, threads=4, run=1):
        self.key, self.entries = key, entries
        self.nb = threads * run      # nodes a block, so the 16 blocks differ
        self.hits = self.misses = self.recounts = 0
        self.no_entry = self.no_count = 0   # exchanging pods of each kind
        self.maxima: list = []

    def scan(self, masked_static, requests, nonzero_requests, allocatable, requested,
             nonzero, rr_start, w_lr, w_ba, extra, norm):
        spread = extra if hasattr(extra, "spread_q") else None
        ip = None if spread is not None else extra
        assert norm is not None
        p_count, n = masked_static.shape
        table = NormMaximaTable(self.entries)
        rows = norm_pod_rows(norm).numpy()
        exch = norm_exchanges(norm)
        req, nz = requested.clone(), nonzero.clone()
        rr = int(rr_start) % (1 << 32)
        out_a = np.full(p_count, -1, np.int32)
        out_s = np.zeros(p_count, F32)
        out_f = np.zeros(p_count, np.int32)
        if spread is not None:
            ledger = make_ledger(spread.podsel_count)
            onehot = topology_onehot(spread.topology, spread.domain_universe)
        else:
            ledger = make_ledger(ip.podsel_count, ip.term_count, ip.topology,
                                 ip.domain_universe)
            onehot = topology_onehot(ip.topology, ip.domain_universe)
        cnt, cnt_ok = None, False
        for p in range(p_count):
            ms = masked_static[p].numpy()
            feasible = ((ms > -np.inf) & fits_resources_dyn(
                allocatable, requests[p:p + 1], req, dyn_gpu=False,
                dyn_storage=False)[0].numpy())
            lr = least_requested(allocatable, nonzero_requests[p:p + 1], nz)[0].numpy()
            ba = balanced_allocation(allocatable, nonzero_requests[p:p + 1], nz)[0].numpy()
            # the build's own term (and the interpod build's predicate): kept
            # from the first round
            if spread is not None:
                w_x = F32(spread.w_ss)
                x = selector_spread(spread.topology, spread.spread_q[p], ledger,
                                    torch.from_numpy(feasible), spread.domain_universe,
                                    onehot).numpy()
                quiet = int(spread.spread_q[p]) < 0
            else:
                pod = SimpleNamespace(**{f: getattr(ip, f)[p] for f in POD_ROW_FIELDS})
                if ip.use_ipa:
                    feasible = feasible & interpod_feasible(ip, pod, ledger, onehot).numpy()
                counts = interpod_counts(ip, pod, ledger, ip.hard_w, onehot)
                w_x = F32(ip.w_ip)
                x = interpod_score(counts, torch.from_numpy(feasible)).numpy()
                quiet = not bool((counts != 0).any())

            def select(flag):
                # the kernel's order: the flag's terms first, then the score
                # loop's terms
                sc = (((((ms + flag).astype(F32) + F32(w_lr) * lr).astype(F32)
                        + F32(w_ba) * ba).astype(F32) + w_x * x).astype(F32))
                sc = np.where(feasible, sc + F32(0.0), -np.inf).astype(F32)
                if not feasible.any():
                    return -1, F32(0.0)
                best = sc.max()
                ties = np.flatnonzero(feasible & (sc == best))
                return int(ties[rr % len(ties)]), best

            if exch[p]:
                self.no_entry += spread is not None and quiet
                self.no_count += ip is not None and quiet
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
                one = torch.ones(())
                if spread is not None:
                    ledger_add(ledger, spread.pod_matches_q[p], node, one)
                else:
                    ledger_add(ledger, ip.pod_matches_q[p], node, one,
                               ip.pod_carries_e[p], ip.topology)
        return ScanResult(torch.from_numpy(out_a), torch.from_numpy(out_s),
                          torch.from_numpy(out_f), req, nz,
                          torch.tensor(rr, dtype=torch.int64), ledger.podsel_count,
                          None if ip is None else ledger.term_count)


def _solve_with(model, state, batch, rr, names):
    """The port's solver with the model in place of the spread and
    interpod scans (the other builds' plain versions, unused)."""
    return solver._solve(state, batch, rr, DEFAULT_POLICY, pflags(names), CAPS, None,
                         solver.static_mask_plain, assign_scan_plain, model.scan,
                         model.scan, assign_scan_gang_plain,
                         assign_scan_spread_interpod_plain)


def _scan_args(st, b, names, rr):
    """The spread or interpod scan's operands as the port's solver makes
    them."""
    g = solver.check_supported(DEFAULT_POLICY, pflags(names))
    masked = solver.masked_static_scores(st, b, DEFAULT_POLICY, g)
    args = (masked, b.requests, b.nonzero_requests, st.allocatable, st.requested,
            st.nonzero_requested, rr, float(g.w_lr), float(g.w_ba))
    u = CAPS.domain_universe
    extra = (solver.spread_inputs(st, b, g, u, None) if "spread" in names
             else solver.interpod_inputs(st, b, g, u))
    return (*args, extra, solver.scan_norm_inputs(st, b, g))


def _cluster(seed, build, classes=0):
    """interpod_cluster's nodes and pods with tt_na's taints, tolerations and
    preferred terms (with `classes`, pod i's words are class i % classes':
    no toleration, and a preferred term of EXPRS[k] at weight 10 (k + 1)
    for class k), encoded both ways, with the build's gates: the port's
    state and batch, JAX's, and the gate names."""
    rng = np.random.RandomState(seed)
    spread = build == "spread"
    nodes, pods, _ = interpod_cluster(rng, 48, P, p_none=1.0 if spread else 0.4)
    add_tt_na(rng, nodes, pods)
    for i, d in enumerate(pods if classes else ()):
        k = i % classes
        d["spec"].pop("tolerations", None)
        d["spec"].setdefault("affinity", {})["nodeAffinity"] = {
            "preferredDuringSchedulingIgnoredDuringExecution": [
                {"weight": 10 * (k + 1),
                 "preference": {"matchExpressions": list(EXPRS[k])}}]}
    (state, batch, _), (jstate, jbatch, _) = encode_both(
        nodes, pods, SERVICES if spread else ())
    names = SPREAD_GATES if spread else IPA_GATES
    return (state_from_numpy(state, "cpu"), batch_from_numpy(batch, "cpu"),
            jstate, jbatch, names)


def _fields(build):
    return FIELDS + (("new_term",) if build == "ipa" else ())


# ---- (a) the guess-check-redo scan against JAX

@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("build", ["spread", "ipa"])
def test_guess_check_redo_scan_matches_reference(build, seed):
    st, b, jstate, jbatch, names = _cluster(70 + seed, build)
    rr = [0, 2**32 - 1][seed]
    want = jax_solve(jstate, jbatch, rr, jflags(names))
    model = _Model()
    assert_same(_solve_with(model, st, b, rr, names), want, _fields(build))
    exchanging = sum(norm_exchanges(_scan_args(st, b, names, rr)[-1]))
    assert model.hits + model.misses == exchanging > 0
    assert model.misses > 0   # the first pod of each key at least
    # pods that exchanged only for the flag before: no spread entry, or no
    # inter-pod count, and the maxima in the triple all the same
    assert (model.no_entry if build == "spread" else model.no_count) > 0


def _predicate_cluster():
    """Nodes and pods where the inter-pod predicate alone moves the flag's
    maxima: every node carries a PreferNoSchedule taint that no pod
    tolerates, every pod prefers disk=ssd (weight 100), and node 0 alone
    has disk=ssd (and room for every pod), so it wins the first pod, a web
    pod with hostname anti-affinity to app=web. From then on the web pods
    may not go there (its carried term), and their NodeAffinity maximum is
    0, while the db pods between them may, and go there: the maxima
    alternate with no change in the fit, under one key."""
    nodes = []
    for i in range(12):
        nodes.append({"metadata": {"name": f"n{i}", "labels": {
                          HOST: f"n{i}", ZONE: f"z{i % 3}",
                          **({"disk": "ssd"} if i == 0 else {})}},
                      "spec": {"taints": [{"key": "soft", "value": "x",
                                           "effect": "PreferNoSchedule"}]},
                      "status": {"allocatable": {
                          "cpu": "64" if i == 0 else "4",
                          "memory": "64Gi" if i == 0 else "8Gi",
                          "pods": "110" if i == 0 else "8"},
                          "conditions": [{"type": "Ready", "status": "True"}]}})
    prefer = [{"weight": 100, "preference": {"matchExpressions": [
        {"key": "disk", "operator": "In", "values": ["ssd"]}]}}]
    pods = []
    for i in range(P):
        app = "web" if i % 2 == 0 else "db"
        affinity = {"nodeAffinity": {
            "preferredDuringSchedulingIgnoredDuringExecution": prefer}}
        if app == "web":
            affinity["podAntiAffinity"] = {
                "requiredDuringSchedulingIgnoredDuringExecution": [
                    {"labelSelector": {"matchLabels": {"app": "web"}},
                     "topologyKey": HOST}]}
        pods.append({"metadata": {"name": f"p{i}", "namespace": "default",
                                  "labels": {"app": app}},
                     "spec": {"containers": [{"name": "c", "image": "k8s.gcr.io/pause:3.0",
                                              "resources": {"requests": {
                                                  "cpu": "100m", "memory": "128Mi"}}}],
                              "affinity": affinity}})
    return nodes, pods


def test_a_miss_caused_by_the_predicate_matches_reference():
    (state, batch, _), (jstate, jbatch, _) = encode_both(*_predicate_cluster())
    st, b = state_from_numpy(state, "cpu"), batch_from_numpy(batch, "cpu")
    want = jax_solve(jstate, jbatch, 0, jflags(IPA_GATES))
    got_a = np.asarray(want.assignments)
    assert got_a[0] == 0 and (got_a[1::2] == 0).all() and (got_a[2::2] != 0).all()
    model = _Model()
    assert_same(_solve_with(model, st, b, 0, IPA_GATES), want, _fields("ipa"))
    # one key; the maxima (1 taint, weight 100) on node 0 for pod 0 and the
    # db pods, none for the web pods after pod 0
    assert len({norm_row_key(r) for r in norm_pod_rows(_scan_args(
        st, b, IPA_GATES, 0)[-1]).numpy()}) == 1
    full, empty = 1 | 100 << CN_SHIFT, 1
    assert model.maxima == [full] + [full if i % 2 else empty for i in range(1, P)]
    assert model.misses == P - 1 and model.hits == 1   # pod 1 repeats pod 0
    # the host replay counts them only with the predicate: the fit alone
    # leaves node 0 feasible to every pod
    args = _scan_args(st, b, IPA_GATES, 0)
    raw = _Model().scan(*args)
    with_ip = norm_true_maxima(args[0], args[1], args[3], args[4], args[-1],
                               raw.assignments, None, args[9])
    fit_only = norm_true_maxima(args[0], args[1], args[3], args[4], args[-1],
                                raw.assignments)
    assert with_ip == model.maxima and set(fit_only) == {full}
    assert sum(m is True for m in norm_table_misses(args[-1], with_ip)) == P - 1
    assert sum(m is True for m in norm_table_misses(args[-1], fit_only)) == 1


# ---- (b) traffics that force misses

def _fill_cluster():
    """Every pod prefers tier a (weight 60) and rack r1 (weight 40) and
    tolerates no PreferNoSchedule taint; node 0 is in both (sum 100), node
    1 in tier a only (60), node 2 in rack r1 only (40), each in a zone of
    its own and with room for one pod; the taint is on node 3, which takes
    none. So NodeAffinity's maximum goes 100, 60, 40, 0 as nodes 0-2 fill,
    SelectorSpread's zone counts leaving each next one ahead."""
    nodes = []
    for i in range(48):
        labels = {HOST: f"n{i}", ZONE: f"z{i % 3}",
                  "tier": "a" if i in (0, 1) else "c",
                  "rack": "r1" if i in (0, 2) else "r9"}
        nodes.append({"metadata": {"name": f"n{i}", "labels": labels},
                      "spec": {"taints": [{"key": "soft", "value": "x",
                                           "effect": "PreferNoSchedule"}]
                               if i == 3 else []},
                      "status": {"allocatable": {
                          "cpu": "64" if i < 3 else "4",
                          "memory": "64Gi" if i < 3 else "8Gi",
                          "pods": "1" if i < 3 else "0" if i == 3 else "4"},
                          "conditions": [{"type": "Ready", "status": "True"}]}})
    prefer = [{"weight": 60, "preference": {"matchExpressions": [
                  {"key": "tier", "operator": "In", "values": ["a"]}]}},
              {"weight": 40, "preference": {"matchExpressions": [
                  {"key": "rack", "operator": "In", "values": ["r1"]}]}}]
    pods = [{"metadata": {"name": f"p{i}", "namespace": "default",
                          "labels": {"app": "web" if i % 2 else "db"}},
             "spec": {"containers": [{"name": "c", "image": "k8s.gcr.io/pause:3.0",
                                      "resources": {"requests": {
                                          "cpu": "100m", "memory": "128Mi"}}}],
                      "affinity": {"nodeAffinity": {
                          "preferredDuringSchedulingIgnoredDuringExecution": prefer}}}}
            for i in range(P)]
    return nodes, pods


@pytest.mark.parametrize("build", ["spread", "ipa"])
def test_a_filling_maximum_forces_misses(build):
    names = SPREAD_GATES if build == "spread" else IPA_GATES
    (state, batch, _), (jstate, jbatch, _) = encode_both(
        *_fill_cluster(), SERVICES if build == "spread" else ())
    st, b = state_from_numpy(state, "cpu"), batch_from_numpy(batch, "cpu")
    want = jax_solve(jstate, jbatch, 0, jflags(names))
    assert np.asarray(want.assignments)[:3].tolist() == [0, 1, 2]
    model = _Model()
    assert_same(_solve_with(model, st, b, 0, names), want, _fields(build))
    na = [w >> CN_SHIFT for w in model.maxima]
    assert na[:4] == [100, 60, 40, 0] and set(na[3:]) == {0}
    assert [w & CT for w in model.maxima] == [0] * P
    assert model.misses == 4   # the first pod, then each fall


@pytest.mark.parametrize("build", ["spread", "ipa"])
def test_colliding_keys_and_a_small_table_force_misses(build):
    """Every row one key (classes with other maxima evict each other's
    entry), and a table of 2 entries over 3 classes in turn (first in,
    first out evicts each key before it comes back): every pod misses
    where the kernel's table misses only the first of each class."""
    st, b, jstate, jbatch, names = _cluster(90, build, classes=3)
    want = jax_solve(jstate, jbatch, 5, jflags(names))
    collide, small, full = _Model(key=lambda row: 0), _Model(entries=2), _Model()
    for model in (collide, small, full):
        assert_same(_solve_with(model, st, b, 5, names), want, _fields(build))
    norm = _scan_args(st, b, names, 5)[-1]
    assert all(norm_exchanges(norm))
    assert len({r.tobytes() for r in norm_pod_rows(norm).numpy()}) == 3
    # each class's NodeAffinity maximum is its weight (or 0 where the
    # predicate leaves no node that meets its term): they differ pod to pod
    na = [w >> CN_SHIFT for w in full.maxima]
    assert na[:3] == [10, 20, 30]
    assert all(m in (0, 10 * (i % 3 + 1)) for i, m in enumerate(na))
    # one key guesses the previous pod's maxima; a key evicted before it
    # comes back guesses 0 (an unknown key's guess): a hit only where the
    # true maxima are those
    words = full.maxima
    assert collide.hits == sum(w == prev for prev, w in zip([0] + words, words))
    assert small.hits == sum(w == 0 for w in words)
    assert full.misses >= 3 and full.hits > 0
    assert min(collide.misses, small.misses) > full.misses


# ---- (c) the host replay

@pytest.mark.parametrize("build", ["spread", "ipa"])
def test_host_replay_counts_the_models_misses(build):
    """norm_true_maxima (with the interpod build's predicate) and
    norm_table_misses, what chip_smoke.py counts, give the model's maxima
    and misses."""
    st, b, _j, _jb, names = _cluster(71, build)
    args = _scan_args(st, b, names, 3)
    model = _Model()
    raw = model.scan(*args)
    interpod = args[9] if build == "ipa" else None
    maxima = norm_true_maxima(args[0], args[1], args[3], args[4], args[-1],
                              raw.assignments, None, interpod)
    assert maxima == model.maxima
    misses = norm_table_misses(args[-1], maxima)
    assert sum(m is True for m in misses) == model.misses
    assert sum(m is False for m in misses) == model.hits


def test_host_replay_follows_the_plain_interpod_scan():
    """On the plain interpod scan's placements, the replay's feasible set is
    the plain scan's: the pods with no feasible node at all have maxima 0,
    and each placed pod's node holds counts no larger than its maxima."""
    st, b, _j, _jb, names = _cluster(72, "ipa")
    args = _scan_args(st, b, names, 0)
    norm = args[-1]
    plain = assign_scan_interpod_plain(*args)
    maxima = norm_true_maxima(args[0], args[1], args[3], args[4], norm,
                              plain.assignments, None, args[9])
    rows = norm_pod_rows(norm).numpy()
    for p, (word, node, feas) in enumerate(zip(maxima, plain.assignments.tolist(),
                                               plain.feasible_counts.tolist())):
        if word is None:
            continue
        if feas == 0:
            assert word == 0
        if node >= 0:
            c = int(_raw_counts(norm, p)[node])
            assert c & CT <= word & CT and c >> CN_SHIFT <= word >> CN_SHIFT
    assert any(w for w in maxima if w is not None)
    # the model's maxima on the model's placements equal it too, and the
    # model places as the plain scan does
    model = _Model()
    got = model.scan(*args)
    np.testing.assert_array_equal(got.assignments.numpy(), plain.assignments.numpy())
    assert model.maxima == maxima
    assert len({r.tobytes() for r in rows}) > 1


# ---- (d) the count cache

@pytest.mark.parametrize("build", ["spread", "ipa"])
def test_count_cache_matches_reference_with_feasibility_changing(build):
    """A sequence of pods in runs of one pod's words and of others', their
    feasible sets those the pod's own scan gives (the fit, and in the
    interpod build the predicate) on a ledger that placements change
    between them, each further cut by a random share drawn anew: the
    counts kept (taken again only where a row differs from the previous
    one, or the previous pod exchanged nothing) equal JAX's at every pod,
    and the feasible maxima from them JAX's over the same feasible set."""
    rng = np.random.RandomState(13)
    st, b, jstate, jbatch, names = _cluster(73, build)
    args = _scan_args(st, b, names, 0)
    norm = args[-1]
    rows = norm_pod_rows(norm).numpy()
    exch = norm_exchanges(norm)
    live = [q for q in range(P) if exch[q]]
    order = [live[i % len(live)] for i in (0, 0, 0, 1, 1, 2, 0, 0, 3, 3, 3, 1, 4, 4, 5, 5, 0)]
    order[9:9] = [q for q in range(P) if not exch[q]][:1]   # a quiet pod in a run
    # the ledger moves between the pods: the plain scan's placements
    plain = (assign_scan_spread_plain if build == "spread"
             else assign_scan_interpod_plain)(*args)
    placed = plain.assignments.tolist()
    extra = args[9]
    if build == "ipa":
        ledger = make_ledger(extra.podsel_count, extra.term_count, extra.topology,
                             extra.domain_universe)
        onehot = topology_onehot(extra.topology, extra.domain_universe)
    req = args[4].clone()
    cnt, ok, prev, recounts, moved = None, False, None, 0, set()
    for step, q in enumerate(order):
        # a placement before each pod: the fit (and the predicate) move
        src = step % P
        if placed[src] >= 0:
            req[placed[src]] += args[1][src]
            if build == "ipa":
                ledger_add(ledger, extra.pod_matches_q[src], placed[src], torch.ones(()),
                           extra.pod_carries_e[src], extra.topology)
        if not exch[q]:
            ok, prev = False, q
            continue
        if not (ok and np.array_equal(rows[q], rows[prev])):
            cnt, recounts = _raw_counts(norm, q), recounts + 1
        ok, prev = True, q
        feasible = ((args[0][q] > float("-inf")) & fits_resources_dyn(
            args[3], args[1][q:q + 1], req, dyn_gpu=False, dyn_storage=False)[0])
        if build == "ipa" and extra.use_ipa:
            pod = SimpleNamespace(**{f: getattr(extra, f)[q] for f in POD_ROW_FIELDS})
            feasible = feasible & interpod_feasible(extra, pod, ledger, onehot)
        feasible = feasible.numpy() & (rng.rand(feasible.shape[0]) < 0.6)
        moved.add(feasible.tobytes())
        pod = jax.tree.map(lambda a: np.asarray(a)[q], jbatch)
        jtt = np.asarray(jpreds.count_untolerated_prefer_taints(jstate, pod))
        jna = np.asarray(jprios.node_affinity_counts(jstate, pod))
        tt_on = int(norm.pod_untol[q]) != 0
        na_on = bool((norm.pod_weights[q] > 0).any())
        ct = (cnt & CT).astype(np.float32)
        cn = (cnt >> CN_SHIFT).astype(np.float32)
        np.testing.assert_array_equal(ct, jtt if tt_on else 0 * ct)
        np.testing.assert_array_equal(cn, jna if na_on else 0 * cn)
        word = _packed_maxima(cnt, feasible, 4)
        assert word & CT == (jtt[feasible].max(initial=0) if tt_on else 0)
        assert word >> CN_SHIFT == (jna[feasible].max(initial=0) if na_on else 0)
    assert recounts < sum(exch[q] for q in order) and len(moved) > 1
