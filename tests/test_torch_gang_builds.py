"""The gang carry in kernel 2's spread, interpod and spread+interpod builds
against the reference package on the CPU: `schedule_batch` with the gang
gate and SelectorSpread, inter-pod (anti-)affinity or both, with the
normalization flag off and on, equals JAX `schedule_batch` (assignments,
scores, feasible counts, the resource, pod-selector and carried-term
ledgers, rr_end) exactly, on batches whose groups revert: a reverted group
that put two members on one node, one whose required anti-affinity member
blocked a later member of its own group, one right before a pod whose
preferred affinity reads the domain counts it gave back, one open at the
last row, solo pods between groups; random batches equal
tests/serial_reference.py `schedule_gang`; the host replay of the flag's
maxima (`norm_true_maxima`) restores the inter-pod ledger at a revert as
the plain scan does; and a Scheduler whose cluster holds a pod with an
anti-affinity term places gang groups with and without Services batch
after batch as JAX does, its StateDB's ledgers equal to JAX's. Every
comparison is exact: counts, scores and ledgers are integer-valued f32.
The reference is jitted once per gate set, at 64 nodes."""

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
from kubernetes_tpu.state.pod_batch import blob_col as j_blob_col  # noqa: E402
from kubernetes_tpu.state.pod_batch import empty_batch as j_empty_batch  # noqa: E402
from kubernetes_tpu.state.pod_batch import pack_batch as j_pack_batch  # noqa: E402
from kubernetes_tpu.state.pod_batch import unpack_batch as j_unpack_batch  # noqa: E402
from kubernetes_tpu.state.statedb import StateDB as JStateDB  # noqa: E402
from tests.serial_reference import SerialScheduler  # noqa: E402

from kubernetes_tpu_torch.api import objects as obj  # noqa: E402
from kubernetes_tpu_torch.gang import GROUP_MIN_ANNOTATION, GROUP_NAME_ANNOTATION  # noqa: E402
from kubernetes_tpu_torch.models.policy import DEFAULT_POLICY  # noqa: E402
from kubernetes_tpu_torch.ops import assign_scan as scan_mod  # noqa: E402
from kubernetes_tpu_torch.ops import solver  # noqa: E402
from kubernetes_tpu_torch.ops.assign_scan import (  # noqa: E402
    GangInputs,
    assign_scan_interpod_gang,
    assign_scan_interpod_gang_plain,
    assign_scan_spread_gang,
    assign_scan_spread_interpod_gang,
    norm_exchanges,
    norm_pack,
    norm_table_misses,
    norm_true_maxima,
)
from kubernetes_tpu_torch.ops.solver import (  # noqa: E402
    BatchFlags,
    schedule_batch,
    schedule_batch_plain,
)
from kubernetes_tpu_torch.scheduler import Scheduler, driver  # noqa: E402
from kubernetes_tpu_torch.state import Capacities, encode_cluster  # noqa: E402
from kubernetes_tpu_torch.state.context import EncodeContext  # noqa: E402
from kubernetes_tpu_torch.state.convert import (  # noqa: E402
    batch_from_numpy,
    rr_from_numpy,
    state_from_numpy,
)
from tests.test_torch_interpod import HOST, REGION, ZONE  # noqa: E402
from tests.test_torch_spread_interpod import SERVICES, _context  # noqa: E402
from tests.test_torch_tt_na import add_tt_na  # noqa: E402

N_NODES, P = 64, 64
CAPS = Capacities(num_nodes=N_NODES, batch_pods=P, term_universe=64)
JCAPS = JCaps(num_nodes=N_NODES, batch_pods=P, term_universe=64)
GATES = ("ipa", "spread", "svcanti", "vol", "attach", "tt", "na", "ports",
         "gpu", "storage", "gang", "preempt")
# each build's gates (svcanti rides spread; no policy here registers it)
BUILDS = {"spread": ("spread", "svcanti", "gang"), "ipa": ("ipa", "gang"),
          "both": ("spread", "svcanti", "ipa", "gang")}
NORM = ("tt", "na")
FIELDS = ("assignments", "scores", "feasible_counts", "new_requested",
          "new_nonzero", "new_podsel")
LEDGERS = ("requested", "nonzero_requested", "podsel_count", "term_count")


def jflags(names):
    return jsolver.BatchFlags(*(g in names for g in GATES))


def pflags(names):
    return BatchFlags(*(g in names for g in GATES))


_JAX_SOLVE = {}


def jax_solve(state, batch, rr, flags):
    """JAX schedule_batch under DEFAULT_POLICY with `flags`, jitted once per
    flags value."""
    fn = _JAX_SOLVE.get(flags)
    if fn is None:
        fn = _JAX_SOLVE[flags] = jax.jit(
            lambda s, b, r: jsolver.schedule_batch(s, b, r, J_POLICY, caps=JCAPS,
                                                   flags=flags))
    return fn(state, batch, np.uint32(rr))


def assert_same(got, want, with_terms, msg=""):
    for name in FIELDS + (("new_term",) if with_terms else ()):
        np.testing.assert_array_equal(
            getattr(got, name).cpu().numpy(), np.asarray(getattr(want, name)),
            err_msg=f"{msg} {name}")
    assert int(got.rr_end) == rr_from_numpy(want.rr_end), msg


# ---- the cluster and the pods ----

def mk_node(i, zone, cpu="4", pods="6", pool=None):
    labels = {HOST: f"n{i}", ZONE: f"z{zone}", REGION: "r0"}
    if pool:
        labels["pool"] = pool
    return {"metadata": {"name": f"n{i}", "labels": labels}, "spec": {},
            "status": {"allocatable": {"cpu": cpu, "memory": "8Gi", "pods": pods},
                       "conditions": [{"type": "Ready", "status": "True"}]}}


def gang_nodes(rng, n=40):
    """n nodes over 3 zones, 2 to 4 CPUs and 3 to 6 pods each; nodes 0-1 in
    pool `small` (zone 0), nodes 2-3 in pool `z1` (zone 1)."""
    pools = {0: "small", 1: "small", 2: "z1", 3: "z1"}
    return [mk_node(i, 0 if i < 2 else 1 if i < 4 else int(rng.randint(3)),
                    cpu=str(rng.randint(2, 5)), pods=str(rng.randint(3, 7)),
                    pool=pools.get(i)) for i in range(n)]


def term(app, key=HOST):
    return {"labelSelector": {"matchLabels": {"app": app}}, "topologyKey": key}


def member(name, app, kind="plain", group=None, quorum=None, pool=None):
    """A pod of `app`: `kind` plain; anti (required hostname anti-affinity
    to its app); pack (required hostname affinity to its app); pref
    (preferred zone affinity, weight 10, to app cache); big (5 CPUs, which
    fit no node)."""
    cpu = "5" if kind == "big" else ("250m", "500m", "1")[sum(map(ord, name)) % 3]
    spec = {"containers": [{"name": "c", "resources": {"requests": {
        "cpu": cpu, "memory": "256Mi"}}}]}
    if kind == "anti":
        spec["affinity"] = {"podAntiAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [term(app)]}}
    elif kind == "pack":
        spec["affinity"] = {"podAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [term(app)]}}
    elif kind == "pref":
        spec["affinity"] = {"podAffinity": {
            "preferredDuringSchedulingIgnoredDuringExecution": [
                {"weight": 10, "podAffinityTerm": term("cache", ZONE)}]}}
    if pool:
        spec["nodeSelector"] = {"pool": pool}
    meta = {"name": name, "namespace": "default", "labels": {"app": app}}
    if group:
        meta["annotations"] = {GROUP_NAME_ANNOTATION: group,
                               GROUP_MIN_ANNOTATION: str(quorum)}
    return {"metadata": meta, "spec": spec}


def hazard_pods(rng, with_terms):
    """(pods, gang_ids, gang_mins): the hazards, then random groups and solo
    pods up to P - 3, then a reverting group open at the last row. Without
    terms, the hazards' terms are left out (the spread build)."""
    pods, ids, mins = [], [], []

    def group(kinds, app, quorum=None, pool=None):
        gid = max(ids, default=0) + 1
        quorum = len(kinds) if quorum is None else quorum
        for k in kinds:
            pods.append(member(f"g{gid}-{len(pods)}", app,
                               k if with_terms or k in ("plain", "big") else "plain",
                               pool=pool))
            ids.append(gid)
            mins.append(quorum)

    def solo(app, kind="plain", pool=None):
        pods.append(member(f"s{len(pods)}", app,
                           kind if with_terms or kind == "plain" else "plain", pool=pool))
        ids.append(0)
        mins.append(0)

    # two members of a reverting group on one node (they pack), then a
    # packing group, whose first member holds everywhere again
    group(["pack", "pack", "pack", "big"], "web")
    group(["pack", "pack"], "web")
    # a required anti member blocks a later member of its own group (pool
    # `small` has two nodes), then a pod that needs both nodes free again
    group(["anti", "anti", "anti"], "db", pool="small")
    solo("db", "anti", pool="small")
    # a reverting group in zone 1 right before a pod whose preferred
    # affinity reads zone 1's counts of app cache
    group(["plain", "plain", "big"], "cache", pool="z1")
    solo("web", "pref")
    solo("cache")
    # random groups and solo pods
    kinds = ("plain", "plain", "anti", "pack", "pref", "big")
    apps = ("web", "db", "cache")
    while len(pods) < P - 3:
        size = min(int(rng.randint(1, 5)), P - 3 - len(pods))
        app = str(rng.choice(apps))
        if rng.rand() < 0.6:
            group([str(rng.choice(kinds)) for _ in range(size)], app,
                  quorum=int(rng.randint(1, size + 1)))
        else:
            for _ in range(size):
                solo(app, str(rng.choice(kinds[:5])))
    # a group open at the last row, which reverts
    group(["plain", "big", "plain"], "web")
    return pods, ids, mins


def encode(nodes, pods, ids, mins, services):
    """Both packages' state and batch, the gang columns written, JAX's
    gates of the batch and the port's node names by row."""
    (state, batch, _t) = encode_cluster(
        [obj.Node.from_dict(d) for d in nodes], [obj.Pod.from_dict(d) for d in pods],
        CAPS, ctx=_context(obj, EncodeContext, list(services)))
    (jstate, jbatch, jtable) = j_encode_cluster(
        [jobj.Node.from_dict(d) for d in nodes], [jobj.Pod.from_dict(d) for d in pods],
        JCAPS, ctx=_context(jobj, JContext, list(services)))
    n = len(pods)
    for b in (batch, jbatch):
        b.gang_id[:n] = np.asarray(ids, np.int32)
        b.gang_min[:n] = np.asarray(mins, np.int32)
    return (state, batch, jstate, jbatch, jsolver.batch_flags(jbatch, n, jtable),
            _t.name_of)


def solve_both(build, norm, seed, rr=0):
    """The port's schedule_batch, its plain path and JAX's on gang_nodes
    and hazard_pods of one seed, with the build's gates (+ tt and na with
    `norm`), and the raw scan assignments (before the gang mask) of the
    port's kernel path, the gang columns and the node names by row."""
    rng = np.random.RandomState(seed)
    nodes = gang_nodes(rng)
    pods, ids, mins = hazard_pods(rng, build != "spread")
    if norm:
        add_tt_na(rng, nodes, pods)
    names = BUILDS[build] + (NORM if norm else ())
    state, batch, jstate, jbatch, flags, name_of = encode(
        nodes, pods, ids, mins, SERVICES if build != "ipa" else ())
    assert all(getattr(jflags(names), f) for f in GATES if getattr(flags, f)), flags
    dstate, dbatch = state_from_numpy(state, "cpu"), batch_from_numpy(batch, "cpu")
    raw = []
    mask = solver.gang_member_mask

    def recording(gang_id, gang_min, assignments, scores):
        raw.append(assignments.clone())
        return mask(gang_id, gang_min, assignments, scores)

    solver.gang_member_mask = recording
    try:
        got = schedule_batch(dstate, dbatch, rr, flags=pflags(names), caps=CAPS)
    finally:
        solver.gang_member_mask = mask
    plain = schedule_batch_plain(dstate, dbatch, rr, flags=pflags(names), caps=CAPS)
    want = jax_solve(jstate, jbatch, rr, jflags(names))
    return got, plain, want, raw[0], (nodes, pods, ids, mins), name_of


def _reverted_groups(got, raw, ids):
    """{group id: raw rows} of the groups the mask took out."""
    out = {}
    final = got.assignments.tolist()
    for i, g in enumerate(ids):
        if g and final[i] < 0:
            out.setdefault(g, []).append(int(raw[i]))
    return {g: rows for g, rows in out.items() if any(r >= 0 for r in rows)}


# ---- (a) schedule_batch against JAX on the hazards ----

@pytest.mark.parametrize("norm", [False, True], ids=["flag_off", "flag_on"])
@pytest.mark.parametrize("build", ["spread", "ipa", "both"])
def test_gang_builds_match_reference_on_the_hazards(build, norm):
    got, plain, want, raw, (_n, _p, ids, _m), _names = solve_both(build, norm,
                                                                  3100 + 7 * norm)
    terms = build != "spread"
    assert_same(got, want, terms, build)
    assert_same(plain, want, terms, f"{build} plain")
    assert int(got.gang_reverted) >= 3 and int(got.gang_placed) > 0
    reverted = _reverted_groups(got, raw, ids)
    # the first group's two members that packed onto one node, and the
    # group open at the last row
    placed_first = [r for r in reverted[1] if r >= 0]
    assert len(placed_first) >= 2
    if terms:
        assert len(set(placed_first)) == 1
    assert ids[-1] in reverted
    # the packing group after the reverted one placed, on any node
    if terms:
        second = [i for i, g in enumerate(ids) if g == 2]
        assert all(got.assignments[i] >= 0 for i in second)
        # the anti group reverted after two members; the solo anti pod
        # after it found the pool's nodes free
        anti = [i for i, g in enumerate(ids) if g == 3]
        assert sorted(raw[i] >= 0 for i in anti) == [False, True, True]
        assert got.assignments[anti[-1] + 1] >= 0


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("build", ["spread", "ipa", "both"])
def test_gang_builds_match_reference_on_random_batches(build, seed):
    got, plain, want, _raw, _case, _names = solve_both(build, seed == 1, 3200 + seed,
                                                       rr=[5, 2**32 - 3][seed])
    assert_same(got, want, build != "spread", f"{build} {seed}")
    assert_same(plain, want, build != "spread", f"{build} {seed} plain")
    assert int(got.gang_reverted) > 0


def test_wrappers_run_the_plain_scans_on_the_cpu():
    """The gang wrappers of the three builds are their plain versions on CPU
    tensors, and check the gang operands."""
    rng = np.random.RandomState(3300)
    nodes = gang_nodes(rng)
    pods, ids, mins = hazard_pods(rng, True)
    state, batch, _js, _jb, _f, _names = encode(nodes, pods, ids, mins, SERVICES)
    st, b = state_from_numpy(state, "cpu"), batch_from_numpy(batch, "cpu")
    g = solver.check_supported(DEFAULT_POLICY, pflags(BUILDS["both"]))
    masked = solver.masked_static_scores(st, b, DEFAULT_POLICY, g)
    args = (masked, b.requests, b.nonzero_requests, st.allocatable, st.requested,
            st.nonzero_requested, 0, float(g.w_lr), float(g.w_ba))
    gang = GangInputs(b.gang_id.contiguous(), b.gang_min.contiguous())
    u = CAPS.domain_universe
    sp, ip = solver.spread_interpod_inputs(st, b, g, u, None)
    for fn, ops in ((assign_scan_spread_gang, (sp,)), (assign_scan_interpod_gang, (ip,)),
                    (assign_scan_spread_interpod_gang, (sp, ip))):
        got = fn(*args, *ops, gang)
        want = scan_mod._scan_plain(*args, sp if fn is not assign_scan_interpod_gang
                                    else None,
                                    ip if fn is not assign_scan_spread_gang else None,
                                    gang)
        for name in ("assignments", "scores", "new_requested", "new_podsel", "rr_end"):
            assert torch.equal(getattr(got, name), getattr(want, name)), (fn.__name__, name)
        with pytest.raises(ValueError, match="gang_min"):
            fn(*args, *ops, GangInputs(gang.gang_id, gang.gang_min[:3]))


# ---- (b) the serial oracle ----

@pytest.mark.parametrize("seed", range(2))
def test_gang_interpod_batches_match_the_serial_oracle(seed):
    got, _plain, want, _raw, (nodes, pods, ids, mins), name_of = solve_both(
        "ipa", False, 3400 + seed)
    ref = SerialScheduler([jobj.Node.from_dict(d) for d in nodes], with_interpod=True)
    expect = ref.schedule_gang([jobj.Pod.from_dict(d) for d in pods], ids, mins)
    names = [name_of[r] if r >= 0 else None
             for r in got.assignments[:len(pods)].tolist()]
    assert names == expect
    assert None in names and any(names)
    assert_same(got, want, True)


# ---- (c) the host replay of the flag's maxima ----

def test_host_replay_restores_the_interpod_ledger_at_a_revert(monkeypatch):
    """norm_true_maxima with gang and interpod gives the maxima the plain
    gang interpod scan took (its feasible sets follow the inter-pod
    predicate over a ledger a revert restored), and so the misses they
    imply; a replay that does not settle groups takes other maxima."""
    rng = np.random.RandomState(3500)
    nodes = gang_nodes(rng)
    pods, ids, mins = hazard_pods(rng, True)
    add_tt_na(rng, nodes, pods, p_terms=1.0)
    for d in pods:   # every pod untolerant of the soft taint: it exchanges
        d["spec"].pop("tolerations", None)
    state, batch, _js, _jb, _f, _names = encode(nodes, pods, ids, mins, ())
    st, b = state_from_numpy(state, "cpu"), batch_from_numpy(batch, "cpu")
    names = BUILDS["ipa"] + NORM
    g = solver.check_supported(DEFAULT_POLICY, pflags(names))
    masked = solver.masked_static_scores(st, b, DEFAULT_POLICY, g)
    args = (masked, b.requests, b.nonzero_requests, st.allocatable, st.requested,
            st.nonzero_requested, 0, float(g.w_lr), float(g.w_ba))
    ip = solver.interpod_inputs(st, b, g, CAPS.domain_universe)
    norm = solver.scan_norm_inputs(st, b, g)
    gang = GangInputs(b.gang_id.contiguous(), b.gang_min.contiguous())
    seen = {"tt": [], "na": []}
    for key, name in (("tt", "taint_toleration_from_counts"),
                      ("na", "normalized_from_counts")):
        fn = getattr(scan_mod, name)

        def recording(counts, feasible, fn=fn, key=key):
            seen[key].append(int(torch.where(feasible, counts, 0.0).max()))
            return fn(counts, feasible)

        monkeypatch.setattr(scan_mod, name, recording)
    raw = assign_scan_interpod_gang_plain(*args, ip, gang, norm)
    monkeypatch.undo()
    exch = norm_exchanges(norm)
    tt_on = (norm.pod_untol != 0).tolist()
    na_on = (norm.pod_weights > 0).any(1).tolist()
    truth = [norm_pack(mt if t else 0, mn if n_ else 0) if x else None
             for mt, mn, t, n_, x in zip(seen["tt"], seen["na"], tt_on, na_on, exch)]
    maxima = norm_true_maxima(args[0], args[1], args[3], args[4], norm,
                              raw.assignments, gang, ip)
    assert maxima == truth
    assert norm_table_misses(norm, maxima) == norm_table_misses(norm, truth)
    assert sum(x for x in exch) > P // 2
    # without the settle, the replay keeps the reverted members' terms
    unsettled = norm_true_maxima(args[0], args[1], args[3], args[4], norm,
                                 raw.assignments, None, ip)
    assert unsettled != truth


# ---- (d) the driver: a carried anti term, then gang groups ----

class _JaxChain:
    """The reference package driven as this package's Scheduler drives a
    gang batch with Services: encode cache, re-encode on an epoch move,
    gang columns after encoding, StateDB flush, schedule_batch, commit."""

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

    def schedule(self, pod_dicts, gang_id, gang_min):
        pods = [jobj.Pod.from_dict(d) for d in pod_dicts]
        fblob, iblob = j_pack_batch(j_empty_batch(JCAPS), JCAPS)
        epoch = self.db.table.pod_row_epoch
        for i, pod in enumerate(pods):
            self.cache.encode_packed_into(fblob, iblob, i, pod)
        if self.db.table.pod_row_epoch != epoch:
            for i, pod in enumerate(pods):
                self.cache.encode_packed_into(fblob, iblob, i, pod)
        j_blob_col(fblob, iblob, "gang_id", JCAPS)[:len(pods)] = gang_id
        j_blob_col(fblob, iblob, "gang_min", JCAPS)[:len(pods)] = gang_min
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


# a bound pod with required hostname anti-affinity against app=web
GUARD = {"metadata": {"name": "guard", "namespace": "default",
                      "labels": {"app": "guard"}},
         "spec": {"containers": [{"name": "c", "resources": {"requests": {
             "cpu": "100m", "memory": "128Mi"}}}],
                  "affinity": {"podAntiAffinity": {
                      "requiredDuringSchedulingIgnoredDuringExecution": [
                          term("web")]}}}}


def test_scheduler_chains_gang_groups_with_a_carried_term_like_the_reference(monkeypatch):
    """A bound pod with an anti-affinity term is accounted first, which
    raises the ipa gate for every later batch; then three batches of gang
    groups (of Service-selected apps and of one no Service selects) and
    solo pods: each batch's result equals the reference's on the rows and
    gang columns the driver built, and the StateDB's ledgers, host and
    flushed, after the last batch equal the reference's."""
    seen = []
    solve = driver.schedule_batch

    def recording(state, batch, rr, policy, flags, caps, **kw):
        result = solve(state, batch, rr, policy, flags, caps, **kw)
        seen.append((batch, flags, result))
        return result

    monkeypatch.setattr(driver, "schedule_batch", recording)
    rng = np.random.RandomState(3600)
    nodes = gang_nodes(rng, 24)
    dicts, g = [], 0
    kinds = ("plain", "plain", "anti", "pack", "pref", "big")
    while len(dicts) < 3 * P - 16:
        size = int(rng.randint(1, 6))
        app = str(rng.choice(("web", "db", "cache")))
        if rng.rand() < 0.7:
            dicts += [member(f"j{g}-{m}", app, str(rng.choice(kinds)), group=f"job{g}",
                             quorum=int(rng.randint(1, size + 1)))
                      for m in range(size)]
            g += 1
        else:
            dicts += [member(f"s{len(dicts)}-{m}", app, str(rng.choice(kinds[:5])))
                      for m in range(size)]
    sched = Scheduler(CAPS, device="cpu")
    sched.add_nodes([obj.Node.from_dict(d) for d in nodes])
    for d in SERVICES:
        sched.add_service(obj.Service.from_dict(d))
    ref = _JaxChain(nodes)
    assert sched.add_pod(obj.Pod.from_dict(GUARD), "n5")
    assert ref.add_pod(GUARD, "n5")
    chunks = []
    schedule_chunk = sched._schedule_chunk

    def chunk_recording(pods, gang_id=None, gang_min=None):
        chunks.append([p.metadata.name for p in pods])
        return schedule_chunk(pods, gang_id, gang_min)

    monkeypatch.setattr(sched, "_schedule_chunk", chunk_recording)
    placed = sched.schedule([obj.Pod.from_dict(d) for d in dicts])
    assert len(chunks) == len(seen) >= 3
    by_name = {d["metadata"]["name"]: d for d in dicts}
    for k, (names, (batch, flags, result)) in enumerate(zip(chunks, seen)):
        n = len(names)
        want, res, jf = ref.schedule([by_name[m] for m in names],
                                     batch.gang_id[:n].numpy(), batch.gang_min[:n].numpy())
        assert jf.ipa and jf.gang and flags.ipa and flags.gang, f"batch {k}"
        assert {key: placed[key] for key in want} == want, f"batch {k}"
        assert_same(result, res, True, f"batch {k}")
    # (the Scheduler ran every batch first: its StateDB is the last batch's)
    for name in LEDGERS:
        np.testing.assert_array_equal(getattr(sched.statedb.host, name),
                                      np.asarray(getattr(ref.db.host, name)),
                                      err_msg=f"host {name}")
        np.testing.assert_array_equal(getattr(sched.statedb.flush(), name).numpy(),
                                      np.asarray(getattr(ref.db.flush(), name)),
                                      err_msg=f"flushed {name}")
    assert sched.gang_reverted > 0 and sched.gang_placed > 0
    # no web pod on the guard's node
    web = {f"default/{d['metadata']['name']}" for d in dicts
           if d["metadata"]["labels"]["app"] == "web"}
    assert "n5" not in {placed[key] for key in web}
