"""Host ports and the gpu and storage fit (the ports, gpu and storage gates)
in kubernetes_tpu_torch against the reference package on the CPU: the
encoder's port rows, both StateDBs' host-port counts through add_pod and
remove_pod, the encode cache's row of a host-port class against a fresh
encode; the plain PodFitsHostPorts and the fit with `dyn_gpu` and
`dyn_storage` (the overlay request falling through to scratch, the
all-zero shortcut over all five columns) against JAX's predicates, and a
numpy model of the EXT variant's word and f32 order against them;
`schedule_batch` with the three gates raised, gang off and on (groups that
revert, two members on one node), normalization flag off and on, against
JAX `schedule_batch` on assignments, scores, feasible counts, both
ledgers, the host-port counts and rr; the wrapper's post-scan host-port
sum against the plain scan's carried ledger; `Scheduler` over two batches
whose second sees the first's ports and GPUs against the reference's
StateDB; the refusal with SelectorSpread or inter-pod affinity; and the
gpu_ports traffic at a small size. Every comparison is exact: counts,
requests and scores are integer-valued f32. The reference is jitted once
per gate set (four in all), at 64 nodes x 32 pods."""

import dataclasses

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
from kubernetes_tpu_torch.ops import predicates as preds  # noqa: E402
from kubernetes_tpu_torch.ops.assign_scan import (  # noqa: E402
    ExtInputs,
    GangInputs,
    assign_scan_ext,
    assign_scan_gang_ext,
    assign_scan_gang_ext_plain,
    ext_port_count,
    pack_words,
)
from kubernetes_tpu_torch.ops.solver import (  # noqa: E402
    BatchFlags,
    check_supported,
    masked_static_scores,
    schedule_batch,
    schedule_batch_plain,
)
from kubernetes_tpu_torch.perf.fixtures import make_pods  # noqa: E402
from kubernetes_tpu_torch.perf.harness import (  # noqa: E402
    GPU_PORTS_PODS,
    default_caps,
    gpu_ports_cluster,
)
from kubernetes_tpu_torch.scheduler import Scheduler  # noqa: E402
from kubernetes_tpu_torch.state import Capacities, encode_cluster  # noqa: E402
from kubernetes_tpu_torch.state.convert import (  # noqa: E402
    batch_from_numpy,
    rr_from_numpy,
    state_from_numpy,
)
from kubernetes_tpu_torch.state.encode_cache import EncodeCache  # noqa: E402
from kubernetes_tpu_torch.state.layout import Resource  # noqa: E402
from kubernetes_tpu_torch.state.pod_batch import (  # noqa: E402
    blob_col,
    blob_widths,
    encode_pods,
    pack_batch,
    packed_batch_flags,
)
from kubernetes_tpu_torch.state.statedb import StateDB  # noqa: E402
from tests.test_torch_state import random_cluster  # noqa: E402

N_NODES, P = 64, 32
CAPS = Capacities(num_nodes=N_NODES, batch_pods=P)
JCAPS = JCaps(num_nodes=N_NODES, batch_pods=P)
GATES = ("ipa", "spread", "svcanti", "vol", "attach", "tt", "na", "ports",
         "gpu", "storage", "gang", "preempt")
EXT_GATES = ("ports", "gpu", "storage")
FIELDS = ("assignments", "scores", "feasible_counts", "new_requested",
          "new_nonzero", "new_port_count")
GPU = "alpha.kubernetes.io/nvidia-gpu"
SCRATCH = "storage.kubernetes.io/scratch"
OVERLAY = "storage.kubernetes.io/overlay"
PORTS = (80, 443, 8080, 9100)
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
    flags value."""
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


def _container(pod: dict) -> dict:
    return pod["spec"]["containers"][0]


def ext_cluster(seed: int, n_nodes: int = 48, n_pods: int = P, gpus=(0, 1, 2, 4),
                overlay_share: float = 0.4):
    """random_cluster's gated cluster (PreferNoSchedule taints, preferred
    node affinity, gpu and scratch requests) widened for the EXT variant:
    nodes with 0-4 GPUs, scratch on most, overlay allocatable on some (the
    rest take overlay requests from scratch); pods asking a GPU, scratch,
    overlay, only a GPU or only scratch (cpu = memory = 0), and host ports,
    one of them listed twice."""
    rng = np.random.RandomState(seed)
    nodes, pods = random_cluster(rng, n_nodes, n_pods, gated=True)
    for d in nodes:
        alloc = d["status"]["allocatable"]
        alloc["pods"] = str(rng.randint(2, 6))
        alloc[GPU] = str(gpus[rng.randint(len(gpus))])
        if rng.rand() < 0.8:
            alloc[SCRATCH] = f"{rng.randint(1, 5)}Gi"
        if rng.rand() < overlay_share:
            alloc[OVERLAY] = f"{rng.randint(1, 4)}Gi"
    for i, d in enumerate(pods):
        c = _container(d)
        req = c.setdefault("resources", {}).setdefault("requests", {})
        u = rng.rand()
        if u < 0.1:   # only a GPU, or only scratch
            req.clear()
            req[GPU if i % 2 else SCRATCH] = "1" if i % 2 else "1Gi"
        elif u < 0.35:
            req[GPU] = str(rng.randint(1, 3))
        if rng.rand() < 0.3:
            req[OVERLAY] = f"{[512, 1024][rng.randint(2)]}Mi"
        if rng.rand() < 0.2:
            req[SCRATCH] = f"{[512, 1024, 2048][rng.randint(3)]}Mi"
        if rng.rand() < 0.35:
            ports = [PORTS[rng.randint(len(PORTS))]]
            if rng.rand() < 0.2:
                ports.append(ports[0])   # a port listed twice
            c["ports"] = [{"containerPort": p, "hostPort": p} for p in ports]
    return nodes, pods


def encode_both(nodes, pods):
    mine = encode_cluster([obj.Node.from_dict(d) for d in nodes],
                          [obj.Pod.from_dict(d) for d in pods], CAPS)
    ref = j_encode_cluster([jobj.Node.from_dict(d) for d in nodes],
                           [jobj.Pod.from_dict(d) for d in pods], JCAPS)
    return mine, ref


def _accounted_ports(states, rng, n_nodes: int, ids: int) -> None:
    """The same host-port counts (0-2 a cell, ids below `ids`) into each
    state's ledger."""
    counts = rng.randint(0, 3, size=(n_nodes, ids)) * (rng.rand(n_nodes, ids) < 0.2)
    for st in states:
        st.port_count[:n_nodes, :ids] = counts


# ---- (a) the encoder, the StateDB and the cache ----

@pytest.mark.parametrize("seed", range(2))
def test_encoder_port_rows_match_reference(seed):
    nodes, pods = ext_cluster(seed)
    (_s, batch, table), (_js, jbatch, jtable) = encode_both(nodes, pods)
    np.testing.assert_array_equal(batch.port_onehot, np.asarray(jbatch.port_onehot))
    np.testing.assert_array_equal(batch.requests, np.asarray(jbatch.requests))
    assert table.ports == jtable.ports and table.ports
    assert (batch.port_onehot == 2.0).any()   # a port listed twice counts 2
    fblob, iblob = pack_batch(batch, CAPS)
    flags = packed_batch_flags(fblob, iblob, int(batch.valid.sum()), table, CAPS)
    assert flags == pflags(EXT_GATES + ("tt", "na")), flags


def test_convert_carries_the_port_and_resource_columns_both_ways():
    """The reference's host arrays onto this package's tensors and back:
    port_count, port_onehot and the gpu, scratch and overlay columns, a
    node without overlay allocatable holding 0 there (the fallthrough)."""
    nodes, pods = ext_cluster(5)
    (state, batch, _), (jstate, jbatch, _) = encode_both(nodes, pods)
    _accounted_ports((jstate,), np.random.RandomState(5), len(nodes), 4)
    dstate, dbatch = state_from_numpy(jstate, "cpu"), batch_from_numpy(jbatch, "cpu")
    for got, want in ((dstate.port_count, jstate.port_count),
                      (dbatch.port_onehot, jbatch.port_onehot),
                      (dstate.allocatable, jstate.allocatable),
                      (dbatch.requests, jbatch.requests)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    overlay = [OVERLAY in d["status"]["allocatable"] for d in nodes]
    assert any(overlay) and not all(overlay)
    np.testing.assert_array_equal(state.allocatable[:len(nodes), Resource.OVERLAY] > 0,
                                  overlay)
    assert (state.allocatable[:len(nodes), Resource.GPU] > 0).any()


def test_statedb_accounts_host_ports_like_the_reference():
    nodes, pods = ext_cluster(3, n_nodes=8, n_pods=24)
    db, jdb = StateDB(CAPS, device="cpu"), JStateDB(JCAPS)
    for d in nodes:
        db.upsert_node(obj.Node.from_dict(d))
        jdb.upsert_node(jobj.Node.from_dict(d))
    for i, d in enumerate(pods):
        node = f"n{i % 3}"
        assert db.add_pod(obj.Pod.from_dict(d), node)
        assert jdb.add_pod(jobj.Pod.from_dict(d), node)
    for i in (0, 3, 5):
        key = f"default/p{i}"
        db.remove_pod(key)
        jdb.remove_pod(key)
    for name in ("port_count", "requested"):
        np.testing.assert_array_equal(getattr(db.host, name),
                                      np.asarray(getattr(jdb.host, name)), name)
    assert db.table.ports == jdb.table.ports
    assert db.host.port_count.max() >= 2   # counts >= 2 on a node
    # the device mirror carries the counts across
    np.testing.assert_array_equal(db.flush().port_count.numpy(), db.host.port_count)


def test_cached_host_port_rows_equal_a_fresh_encode():
    _nodes, pods = ext_cluster(4, n_nodes=8, n_pods=24)
    pods = [obj.Pod.from_dict(d) for d in pods]
    pods = pods + pods[::-1]   # every class twice: hits after the first
    db = StateDB(Capacities(num_nodes=N_NODES, batch_pods=48), device="cpu")
    caps = db.caps
    cache = EncodeCache(caps, db.table)
    f_width, i_width = blob_widths(caps)
    fblob = np.zeros((48, f_width), np.float32)
    iblob = np.zeros((48, i_width), np.int32)
    for i, pod in enumerate(pods):
        cache.encode_packed_into(fblob, iblob, i, pod)
    assert cache.hits >= 24
    fresh = pack_batch(encode_pods(pods, caps, StateDB(caps, device="cpu").table), caps)
    np.testing.assert_array_equal(fblob.view(np.int32), fresh[0].view(np.int32))
    np.testing.assert_array_equal(iblob, fresh[1])
    assert blob_col(fblob, iblob, "port_onehot", caps).any()


# ---- (b) the predicates and a model of the kernel's fit ----

def _ext_states(seed):
    nodes, pods = ext_cluster(seed)
    (state, batch, _), (jstate, jbatch, _) = encode_both(nodes, pods)
    rng = np.random.RandomState(100 + seed)
    _accounted_ports((state, jstate), rng, len(nodes), 4)
    # a running ledger: some gpu, scratch and overlay already requested
    ledger = np.zeros_like(state.requested)
    ledger[:, Resource.GPU] = rng.randint(0, 3, N_NODES)
    ledger[:, Resource.SCRATCH] = 512.0 * rng.randint(0, 6, N_NODES)
    ledger[:, Resource.OVERLAY] = 512.0 * rng.randint(0, 4, N_NODES)
    return state, batch, jstate, jbatch, ledger


def _ext_fits_model(alloc, r, q, node_word, pod_word, all_zero):
    """The kernel's ext_fits in numpy f32, one (pod, node) pair: the port
    words, then unless all_zero the gpu column and the storage fit with
    each add rounded to f32 in the kernel's order."""
    f = np.float32
    if node_word & pod_word:
        return False
    if all_zero:
        return True
    if not alloc[Resource.GPU] >= f(r[Resource.GPU] + q[Resource.GPU]):
        return False
    if alloc[Resource.OVERLAY] == 0:
        need = f(f(r[Resource.SCRATCH] + r[Resource.OVERLAY])
                 + f(q[Resource.OVERLAY] + q[Resource.SCRATCH]))
        return bool(alloc[Resource.SCRATCH] >= need)
    return bool(alloc[Resource.SCRATCH] >= f(r[Resource.SCRATCH] + q[Resource.SCRATCH])
                and alloc[Resource.OVERLAY] >= f(r[Resource.OVERLAY] + q[Resource.OVERLAY]))


@pytest.mark.parametrize("seed", range(2))
def test_predicates_and_the_kernels_fit_model_match_reference(seed):
    state, batch, jstate, jbatch, ledger = _ext_states(seed)
    dstate = state_from_numpy(state, "cpu")
    dbatch = batch_from_numpy(batch, "cpu")
    got_ports = preds.fits_host_ports(dstate.port_count, dbatch.port_onehot).numpy()
    got_fit = preds.fits_resources_dyn(dstate.allocatable, dbatch.requests,
                                       torch.from_numpy(ledger)).numpy()
    node_words = pack_words(dstate.port_count).tolist()
    pod_words = pack_words(dbatch.port_onehot).tolist()
    zero = preds._requests_all_zero(dbatch.requests).tolist()
    for p in range(P):
        pod = jax.tree.map(lambda a, p=p: np.asarray(a)[p], jbatch)
        want_ports = np.asarray(jpreds.fits_host_ports(jstate, pod))
        want_fit = np.asarray(jpreds.fits_resources_dyn(jstate, pod, ledger))
        np.testing.assert_array_equal(got_ports[p], want_ports, err_msg=f"pod {p}")
        np.testing.assert_array_equal(got_fit[p], want_fit, err_msg=f"pod {p}")
        # the kernel's order: node_terms' pods, cpu and memory, then ext_fits
        base = np.asarray(jpreds.fits_resources_dyn(jstate, pod, ledger, False, False))
        model = [bool(base[n]) and _ext_fits_model(
            state.allocatable[n], batch.requests[p], ledger[n], node_words[n],
            pod_words[p], zero[p]) for n in range(N_NODES)]
        np.testing.assert_array_equal(model, want_fit & want_ports, err_msg=f"pod {p}")
    # the overlay fallthrough and the all-zero shortcut are reached
    no_overlay = state.allocatable[:, Resource.OVERLAY] == 0
    assert no_overlay[:48].any() and (~no_overlay[:48]).any()
    assert (batch.requests[:, Resource.OVERLAY] > 0).any()
    only = (batch.requests[:, Resource.CPU] == 0) & (batch.requests[:, Resource.MEMORY] == 0)
    assert (only & batch.valid & ((batch.requests[:, Resource.GPU] > 0)
                                  | (batch.requests[:, Resource.SCRATCH] > 0))).any()


# ---- (c) schedule_batch against the reference ----

def _gang_rows(batch) -> None:
    """Groups of consecutive rows: (0-3) at quorum 4, (4-7) at quorum 4
    whose row 6 asks 99 GPUs (it reverts), rows 8-9 alone, (10-13) at
    quorum 2, (14-19) at quorum 6 whose rows share nothing but ask the
    same GPU request (two members on one node), (20-21) at quorum 3 (it
    reverts after two members), (24-31) at quorum 8, open at the last
    row."""
    for rows, quorum, gid in (((0, 1, 2, 3), 4, 1), ((4, 5, 6, 7), 4, 2),
                              ((10, 11, 12, 13), 2, 3),
                              (tuple(range(14, 20)), 6, 4), ((20, 21), 3, 5),
                              (tuple(range(24, 32)), 8, 6)):
        batch.gang_id[list(rows)] = gid
        batch.gang_min[list(rows)] = quorum
    batch.requests[6, Resource.GPU] = 99.0
    batch.requests[14:20, Resource.GPU] = 1.0
    batch.port_onehot[4, 0] = 1.0   # the reverted group gives back a port


@pytest.mark.parametrize("norm", [False, True], ids=["flag_off", "flag_on"])
@pytest.mark.parametrize("gang", [False, True], ids=["main", "gang"])
@pytest.mark.parametrize("seed", range(2))
def test_schedule_batch_with_ports_gpu_storage_matches_reference(seed, gang, norm):
    state, batch, jstate, jbatch, _ledger = _ext_states(seed + 10)
    names = EXT_GATES + (("tt", "na") if norm else ()) + (("gang",) if gang else ())
    if gang:
        _gang_rows(batch)
        _gang_rows(jbatch)
    want = jax_solve(jstate, jbatch, 5, jflags(names))
    dstate, dbatch = state_from_numpy(state, "cpu"), batch_from_numpy(batch, "cpu")
    got = schedule_batch(dstate, dbatch, 5, flags=pflags(names), caps=CAPS)
    assert_same(got, want, msg=str(names))
    assert (np.asarray(want.assignments) >= 0).any()
    assert (np.asarray(want.assignments)[:int(batch.valid.sum())] < 0).any()
    if gang:
        assert int(got.gang_reverted) >= 2 and int(got.gang_placed) >= 1
    # the plain path is the same function here
    assert_same(schedule_batch_plain(dstate, dbatch, 5, flags=pflags(names), caps=CAPS),
                want, msg="plain")


@pytest.mark.parametrize("seed", range(2))
def test_the_wrappers_port_sum_equals_the_carried_ledger(seed):
    """The kernel path sums the host-port counts after the launch from the
    assignments, members of reverted groups left out (`ext_port_count`):
    on the plain scan's own assignments that is its carried and restored
    ledger, exactly."""
    state, batch, _js, _jb, _ledger = _ext_states(seed + 20)
    _gang_rows(batch)
    dstate, dbatch = state_from_numpy(state, "cpu"), batch_from_numpy(batch, "cpu")
    flags = pflags(EXT_GATES + ("gang",))
    g = check_supported(DEFAULT_POLICY, flags)
    masked = masked_static_scores(dstate, dbatch, DEFAULT_POLICY, g)
    ext = ExtInputs(use_ports=True, port_onehot=dbatch.port_onehot,
                    port_count=dstate.port_count)
    gang = GangInputs(gang_id=dbatch.gang_id, gang_min=dbatch.gang_min)
    args = (masked, dbatch.requests, dbatch.nonzero_requests, dstate.allocatable,
            dstate.requested, dstate.nonzero_requested, 3, 1.0, 1.0, ext, gang)
    plain = assign_scan_gang_ext_plain(*args)
    assert torch.equal(ext_port_count(ext, plain.assignments, gang), plain.new_port_count)
    assert not torch.equal(ext_port_count(ext, plain.assignments), plain.new_port_count)
    # the wrappers on CPU tensors run the plain version, and count nothing
    launches = assign_scan_gang_ext.launches
    assert torch.equal(assign_scan_gang_ext(*args).assignments, plain.assignments)
    assert assign_scan_gang_ext.launches == launches
    off = dataclasses.replace(ext, use_ports=False)
    assert assign_scan_ext(*args[:9], off).new_port_count is None


def test_host_replay_of_the_flags_maxima_takes_the_ext_fit(monkeypatch):
    """norm_true_maxima with `ext` gives the maxima the plain gang EXT scan
    took (its feasible sets follow the gpu and storage fit and the host
    ports over ledgers a revert restores), so the misses chip_smoke.py
    counts on the EXT builds are the kernel's; without `ext` it takes
    other maxima."""
    from kubernetes_tpu_torch.ops import assign_scan as scan_mod
    from kubernetes_tpu_torch.ops.assign_scan import (
        norm_exchanges,
        norm_pack,
        norm_table_misses,
        norm_true_maxima,
    )
    from kubernetes_tpu_torch.ops.solver import scan_norm_inputs

    state, batch, _js, _jb, _ledger = _ext_states(40)
    _gang_rows(batch)
    batch.tol_op[:] = 0   # every pod untolerant of the soft taints: it exchanges
    dstate, dbatch = state_from_numpy(state, "cpu"), batch_from_numpy(batch, "cpu")
    g = check_supported(DEFAULT_POLICY, pflags(EXT_GATES + ("gang", "tt", "na")))
    masked = masked_static_scores(dstate, dbatch, DEFAULT_POLICY, g)
    args = (masked, dbatch.requests, dbatch.nonzero_requests, dstate.allocatable,
            dstate.requested, dstate.nonzero_requested, 0, float(g.w_lr), float(g.w_ba))
    ext = ExtInputs(use_ports=True, port_onehot=dbatch.port_onehot,
                    port_count=dstate.port_count)
    gang = GangInputs(gang_id=dbatch.gang_id, gang_min=dbatch.gang_min)
    norm = scan_norm_inputs(dstate, dbatch, g)
    seen = {"tt": [], "na": []}
    for key, name in (("tt", "taint_toleration_from_counts"),
                      ("na", "normalized_from_counts")):
        fn = getattr(scan_mod, name)

        def recording(counts, feasible, fn=fn, key=key):
            seen[key].append(int(torch.where(feasible, counts, 0.0).max()))
            return fn(counts, feasible)

        monkeypatch.setattr(scan_mod, name, recording)
    raw = assign_scan_gang_ext_plain(*args, ext, gang, norm)
    monkeypatch.undo()
    exch = norm_exchanges(norm)
    tt_on = (norm.pod_untol != 0).tolist()
    na_on = (norm.pod_weights > 0).any(1).tolist()
    truth = [norm_pack(mt if t else 0, mn if n_ else 0) if x else None
             for mt, mn, t, n_, x in zip(seen["tt"], seen["na"], tt_on, na_on, exch)]
    maxima = norm_true_maxima(args[0], args[1], args[3], args[4], norm,
                              raw.assignments, gang, ext=ext)
    assert maxima == truth
    assert norm_table_misses(norm, maxima) == norm_table_misses(norm, truth)
    assert sum(x for x in exch) > P // 2
    assert norm_true_maxima(args[0], args[1], args[3], args[4], norm,
                            raw.assignments, gang) != truth


def test_priority_gpu_batch_through_ext_then_kernel_3_matches_reference():
    """A batch with priorities and GPU requests (some also a host port the
    bound pods hold) runs the EXT scan, then the preemption pass on its
    ledger (resources only, as JAX's): assignments, verdicts and victim
    counts equal JAX `schedule_batch(victims=)`, the kernel path's and the
    plain path's alike."""
    from tests.test_torch_preemption import assert_equal_to_jax, jax_side, port_side

    def node(i):
        return {"metadata": {"name": f"n{i}"}, "status": {
            "allocatable": {"cpu": "4", "memory": "8Gi", "pods": "110", GPU: "2"},
            "conditions": [{"type": "Ready", "status": "True"}]}}

    def pod(name, priority, node_name=None, gpu="1", port=None):
        c = {"name": "c", "resources": {"requests": {"cpu": "500m", "memory": "256Mi",
                                                     GPU: gpu}}}
        if port:
            c["ports"] = [{"containerPort": port, "hostPort": port}]
        spec = {"containers": [c], "priority": priority}
        if node_name:
            spec["nodeName"] = node_name
        return {"metadata": {"name": name}, "spec": spec}

    nodes = [node(i) for i in range(6)]
    # every GPU taken by priority-0 pods, those on even nodes holding 8080
    filler = [pod(f"f{i}-{k}", 0, f"n{i}", port=8080 if i % 2 == 0 and k == 0 else None)
              for i in range(6) for k in range(2)]
    wave = [pod(f"w{j}", 100, gpu="2" if j % 3 == 2 else "1",
                port=8080 if j % 4 == 1 else None) for j in range(9)]
    got, plain, name_of, _slots, _host = port_side(nodes, wave, filler)
    want, jname_of, _by, _jslots, _jv = jax_side(nodes, wave, filler)
    assert_equal_to_jax(got, plain, name_of, want, jname_of, len(wave))
    assert (got.preempt_node[:len(wave)] >= 0).any()
    assert (got.assignments[:len(wave)] < 0).all()


def test_a_port_universe_past_the_words_raises():
    state, batch, _js, _jb, _ledger = _ext_states(30)
    dstate, dbatch = state_from_numpy(state, "cpu"), batch_from_numpy(batch, "cpu")
    wide = ExtInputs(use_ports=True,
                     port_onehot=torch.zeros((P, 72), dtype=torch.float32),
                     port_count=torch.zeros((N_NODES, 72), dtype=torch.float32))
    masked = torch.zeros((P, N_NODES), dtype=torch.float32)
    with pytest.raises(ValueError, match="72 host ports"):
        assign_scan_ext(masked, dbatch.requests, dbatch.nonzero_requests,
                        dstate.allocatable, dstate.requested,
                        dstate.nonzero_requested, 0, 1.0, 1.0, wide)


@pytest.mark.parametrize("other, why", [
    (("spread",), "SelectorSpread"), (("ipa",), "inter-pod affinity")])
@pytest.mark.parametrize("gate", EXT_GATES)
def test_ext_gates_with_spread_or_ipa_raise_naming_what_is_missing(gate, other, why):
    with pytest.raises(NotImplementedError,
                       match="host ports / GPU or storage requests with "
                             "SelectorSpread or inter-pod affinity"):
        check_supported(DEFAULT_POLICY, pflags((gate,) + other))
    # the gate alone, and with the gang carry, is carried
    check_supported(DEFAULT_POLICY, pflags((gate, "gang")))


# ---- (d) Scheduler against the reference's driver flow ----

class _JaxChain:
    """The reference package's StateDB, encode cache, schedule_batch and
    commit, as its driver runs them."""

    def __init__(self, nodes, bound):
        ctx = JContext(**NO_CONTEXT)
        self.db = JStateDB(JCAPS, volume_ctx=ctx)
        for d in nodes:
            self.db.upsert_node(jobj.Node.from_dict(d))
        for d, node in bound:
            self.db.add_pod(jobj.Pod.from_dict(d), node)
        self.cache = JEncodeCache(JCAPS, self.db.table, volume_ctx=ctx)
        self.rr = 0

    def schedule(self, pod_dicts):
        pods = [jobj.Pod.from_dict(d) for d in pod_dicts]
        fblob, iblob = j_pack_batch(j_empty_batch(JCAPS), JCAPS)
        for i, pod in enumerate(pods):
            self.cache.encode_packed_into(fblob, iblob, i, pod)
        batch = j_unpack_batch(fblob, iblob, JCAPS)
        flags = jsolver.batch_flags(batch, len(pods), self.db.table)
        assert flags == jflags(EXT_GATES + ("tt", "na")), flags
        res = jax_solve(self.db.flush(), batch, self.rr, flags)
        rows = np.asarray(res.assignments)
        names = [self.db.table.name_of[r] if r >= 0 else None
                 for r in rows[:len(pods)]]
        self.db.commit_batch(res, fblob, [(p, n, i) for i, (p, n)
                                          in enumerate(zip(pods, names)) if n])
        self.rr = rr_from_numpy(res.rr_end)
        return {p.key: n for p, n in zip(pods, names)}, res


def test_scheduler_chains_port_and_gpu_batches_like_the_reference():
    nodes, pods = ext_cluster(50, n_pods=2 * P, gpus=(0, 1, 2))
    # the second batch repeats the first's ports and GPUs: it sees their claims
    for i, d in enumerate(pods):
        d["metadata"]["name"] = f"t{i}"
    bound = [(d, f"n{i}") for i, d in enumerate(ext_cluster(51, n_pods=8)[1])]
    for i, (d, _node) in enumerate(bound):
        d["metadata"]["name"] = f"bound{i}"
        d["spec"].pop("nodeName", None)
        _container(d)["ports"] = [{"containerPort": 8080, "hostPort": 8080}]
    sched = Scheduler(CAPS, device="cpu")
    sched.add_nodes([obj.Node.from_dict(d) for d in nodes])
    for d, node in bound:
        assert sched.add_pod(obj.Pod.from_dict(d), node)
    ref = _JaxChain(nodes, bound)
    for k in range(2):
        chunk = pods[k * P:(k + 1) * P]
        got = sched.schedule([obj.Pod.from_dict(d) for d in chunk])
        want, res = ref.schedule(chunk)
        assert got == want, f"batch {k}"
        assert_same(sched.last_result, res, msg=f"batch {k}")
        for name in ("requested", "nonzero_requested", "port_count"):
            np.testing.assert_array_equal(getattr(sched.statedb.host, name),
                                          np.asarray(getattr(ref.db.host, name)),
                                          err_msg=f"batch {k} {name}")
        np.testing.assert_array_equal(sched.statedb.flush().port_count.numpy(),
                                      sched.statedb.host.port_count)
    assert None in got.values() and any(got.values())
    assert int(sched.rr) == ref.rr
    # removing a bound host-port pod frees its port on both sides
    sched.remove_pod("default/bound0")
    ref.db.remove_pod("default/bound0")
    np.testing.assert_array_equal(sched.statedb.host.port_count,
                                  np.asarray(ref.db.host.port_count))


def test_gpu_ports_traffic_at_a_small_size():
    """The gpu_ports traffic's cluster and mix at 200 nodes and 384 pods:
    every pod placed, no node past its GPUs or scratch, no host port
    twice on a node (bound pods included), equal to the plain path."""
    n_nodes, n_pods = 200, 384
    caps = default_caps(n_nodes, n_pods)
    sched = gpu_ports_cluster(n_nodes, caps, device="cpu")
    pods = make_pods(n_pods, **GPU_PORTS_PODS)
    placed = sched.schedule(pods)
    assert all(placed.values())
    host = sched.statedb.host
    table = sched.statedb.table
    assert (host.requested[:, Resource.GPU] <= host.allocatable[:, Resource.GPU]).all()
    assert (host.requested[:, Resource.SCRATCH] + host.requested[:, Resource.OVERLAY]
            <= host.allocatable[:, Resource.SCRATCH]).all()
    assert host.port_count.max() == 1.0 and set(table.ports) == {8080, 9100}
    gpu_nodes = {placed[p.key] for p in pods[::4]}
    assert all(int(name.split("-")[1]) % 4 == 0 for name in gpu_nodes)
    assert sched.last_result.new_port_count is not None
