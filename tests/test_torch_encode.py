"""kubernetes_tpu_torch host plane against the reference package on the CPU:
packed blobs (`pack_batch`, `pack_row`, `unpack_batch`,
`packed_batch_flags`, `PackedRow`), the EncodeCache (hits, misses, the
LRU bound, the epoch rule, one fingerprint case per field, refused pods
never served from the cache), `Scheduler` through the cache over chained batches, and the
StateDB's pod and node lifecycle, each held exactly against the JAX
package on the same seeded inputs."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
try:
    torch.set_num_interop_threads(1)
except RuntimeError:  # the interop pool already started in this process
    pass

from kubernetes_tpu.api.objects import Node as JNode  # noqa: E402
from kubernetes_tpu.api.objects import Pod as JPod  # noqa: E402
from kubernetes_tpu.state.encode_cache import EncodeCache as JEncodeCache  # noqa: E402
from kubernetes_tpu.state.pod_batch import _layout as j_layout  # noqa: E402
from kubernetes_tpu.state.pod_batch import empty_batch as j_empty_batch  # noqa: E402
from kubernetes_tpu.state.pod_batch import pack_batch as j_pack_batch  # noqa: E402
from kubernetes_tpu.state.pod_batch import pack_row as j_pack_row  # noqa: E402
from kubernetes_tpu.state.pod_batch import unpack_batch as j_unpack_batch  # noqa: E402
from kubernetes_tpu.state.statedb import StateDB as JStateDB  # noqa: E402

from kubernetes_tpu_torch.api.objects import Node, Pod  # noqa: E402
from kubernetes_tpu_torch.ops.solver import BatchFlags, schedule_batch  # noqa: E402
from kubernetes_tpu_torch.scheduler import Scheduler  # noqa: E402
from kubernetes_tpu_torch.state import Capacities  # noqa: E402
from kubernetes_tpu_torch.state.cluster_state import AVOID_PODS_ANNOTATION  # noqa: E402
from kubernetes_tpu_torch.state.convert import (  # noqa: E402
    batch_from_numpy,
    state_from_numpy,
    upload_blobs,
)
from kubernetes_tpu_torch.state import encode_cache  # noqa: E402
from kubernetes_tpu_torch.state.encode_cache import EncodeCache  # noqa: E402
from kubernetes_tpu_torch.state.pod_batch import (  # noqa: E402
    BATCH_FIELDS,
    KERNEL_OPERANDS,
    PackedRow,
    _layout,
    batch_flags,
    blob_col,
    blob_widths,
    empty_batch,
    encode_pod_into,
    encode_pods,
    pack_batch,
    pack_row,
    packed_batch_flags,
    padding_row,
    unpack_batch,
)
from kubernetes_tpu_torch.state.statedb import StateDB  # noqa: E402
from tests.test_torch_solver import jax_solve  # noqa: E402
from tests.test_torch_state import (  # noqa: E402
    BATCH,
    CAPS,
    JCAPS,
    N_NODES,
    _avoid,
    encode_both,
    random_cluster,
)

NONE = BatchFlags(*([False] * 12))


def _bits(a):
    return np.asarray(a).view(np.int32)


def _read_cols(caps=CAPS):
    """f32-blob column mask of the fields this package encodes: the
    reference also fills img_onehot, which the main path never reads."""
    layout, f_width, _ = _layout(caps)
    _blob, off, width, _t, _d = layout["img_onehot"]
    keep = np.ones(f_width, bool)
    keep[off:off + width] = False
    return keep


def _blobs(caps=CAPS):
    return pack_batch(empty_batch(caps), caps)


def _j_blobs():
    return j_pack_batch(j_empty_batch(JCAPS), JCAPS)


def _pod(name="p", ns="default", labels=None, annotations=None, owner=None,
         **spec):
    spec.setdefault("containers", [{"name": "c", "image": "pause", "resources": {
        "requests": {"cpu": "250m", "memory": "256Mi"}}}])
    meta = {"name": name, "namespace": ns, "labels": labels or {},
            "annotations": annotations or {}}
    if owner:
        meta["ownerReferences"] = [{"kind": "ReplicaSet", "uid": owner,
                                    "controller": True}]
    return {"metadata": meta, "spec": spec}


def _node(name, avoid_uid=None, labels=None):
    meta = {"name": name, "labels": {"disk": "ssd", **(labels or {})}}
    if avoid_uid:
        meta["annotations"] = {AVOID_PODS_ANNOTATION: _avoid(avoid_uid)}
    return {"metadata": meta, "spec": {}, "status": {
        "allocatable": {"cpu": "4", "memory": "8Gi", "pods": "10"},
        "conditions": [{"type": "Ready", "status": "True"}]}}


# ---- blobs ----

@pytest.mark.parametrize("seed", range(3))
def test_pack_matches_reference_bit_for_bit(seed):
    rng = np.random.RandomState(40 + seed)
    nodes, pods = random_cluster(rng, 30, BATCH - seed, gated=seed == 1)
    (_s, batch, _t), (_js, jbatch, _jt) = encode_both(nodes, pods)
    assert blob_widths(CAPS) == j_layout(JCAPS)[1:]
    want_f, want_i = j_pack_batch(jbatch, JCAPS)
    # the reference's batch through this package's packer: every bit
    got_f, got_i = pack_batch(jbatch, CAPS)
    np.testing.assert_array_equal(_bits(got_f), _bits(want_f))
    np.testing.assert_array_equal(got_i, want_i)
    for i in range(BATCH):
        frow, irow = pack_row(jbatch, i, CAPS)
        jf, ji = j_pack_row(jbatch, i, JCAPS)
        np.testing.assert_array_equal(_bits(frow), _bits(jf))
        np.testing.assert_array_equal(irow, ji)
        np.testing.assert_array_equal(_bits(frow), _bits(got_f[i]))
    # this package's own encoding, on the columns it encodes
    own_f, own_i = pack_batch(batch, CAPS)
    keep = _read_cols()
    np.testing.assert_array_equal(_bits(own_f[:, keep]), _bits(want_f[:, keep]))
    np.testing.assert_array_equal(own_i, want_i)
    # padding rows pack to the padding row
    for r in range(len(pods), BATCH):
        np.testing.assert_array_equal(_bits(own_f[r]), _bits(padding_row(CAPS)[0]))
        np.testing.assert_array_equal(own_i[r], padding_row(CAPS)[1])


def test_blob_widths_at_the_headline_caps():
    assert blob_widths(Capacities(num_nodes=16384, batch_pods=64)) == (1181, 84)


@pytest.mark.parametrize("source", ["own", "reference"])
@pytest.mark.parametrize("seed", range(2))
def test_unpack_equals_the_batch_field_for_field(seed, source):
    rng = np.random.RandomState(50 + seed)
    nodes, pods = random_cluster(rng, 30, BATCH - 3, gated=seed == 1)
    (_s, batch, _t), (_js, jbatch, _jt) = encode_both(nodes, pods)
    if source == "own":
        host, blobs = batch, pack_batch(batch, CAPS)
    else:  # the reference package's blobs carried across
        host, blobs = jbatch, j_pack_batch(jbatch, JCAPS)
    got = unpack_batch(*upload_blobs(*blobs, "cpu"), CAPS)
    want = batch_from_numpy(host, "cpu")
    for name in BATCH_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name
    # the kernels' operands are contiguous; the rest stay views of the blobs
    assert all(getattr(got, name).is_contiguous() for name in KERNEL_OPERANDS)
    assert not got.tol_key.is_contiguous()


@pytest.mark.parametrize("seed", range(2))
def test_packed_row_encodes_as_pack_row(seed):
    """One PackedRow reused for every pod, as the cache reuses it: each
    encode writes the whole packed row, bools included, and leaves nothing
    of the previous pod behind."""
    rng = np.random.RandomState(55 + seed)
    nodes, pod_dicts = random_cluster(rng, 30, BATCH, gated=seed == 1)
    pods = [Pod.from_dict(d) for d in pod_dicts]
    table = _port_db(nodes).table
    row = PackedRow(CAPS)
    np.testing.assert_array_equal(_bits(row.pack()[0]), _bits(padding_row(CAPS)[0]))
    np.testing.assert_array_equal(row.pack()[1], padding_row(CAPS)[1])
    fresh = encode_pods(pods, CAPS, _port_db(nodes).table)
    for i, pod in enumerate(pods):
        encode_pod_into(row.batch, 0, pod, CAPS, table)
        frow, irow = row.pack()
        want_f, want_i = pack_row(fresh, i, CAPS)
        np.testing.assert_array_equal(_bits(frow), _bits(want_f))
        np.testing.assert_array_equal(irow, want_i)


def test_upload_copies_the_host_blobs():
    fblob, iblob = _blobs()
    f_dev, i_dev = upload_blobs(fblob, iblob, "cpu")
    fblob[0, 0] = 7.0
    iblob[0, 0] = 7
    assert f_dev[0, 0].item() != 7.0 and i_dev[0, 0].item() != 7
    with pytest.raises(TypeError):
        upload_blobs(fblob.astype(np.float64), iblob, "cpu")


_GATE_EDITS = {
    "none": None,
    "ports": ("port_onehot", (0, 0), 1.0),
    "ipa": ("paff_q", (0, 0), 0),
    "ipaff_fail": ("ipaff_fail", (0,), True),
    "spread": ("spread_q", (0,), 2),
    "svcanti": ("svcanti_q", (0,), 1),
    "vol": ("vol_want_ro", (0, 3), 1.0),
    "attach": ("att_fail", (0,), True),
    "gang": ("gang_id", (0,), 1),
    "preempt": ("priority", (0,), -5),
}


@pytest.mark.parametrize("gated", [False, True], ids=["plain", "gated"])
@pytest.mark.parametrize("edit", list(_GATE_EDITS))
def test_packed_flags_equal_batch_flags(edit, gated):
    rng = np.random.RandomState(60 + len(edit))
    n = BATCH - 5  # a tail of padding rows
    nodes, pods = random_cluster(rng, 30, n, gated=gated)
    (state, batch, table), _ = encode_both(nodes, pods)
    if _GATE_EDITS[edit] is not None:
        name, where, value = _GATE_EDITS[edit]
        getattr(batch, name)[where] = value
    fblob, iblob = pack_batch(batch, CAPS)
    got = packed_batch_flags(fblob, iblob, n, table, CAPS)
    want = batch_flags(state_from_numpy(state, "cpu"),
                       batch_from_numpy(batch, "cpu"))
    assert got == want
    assert (got == NONE) == (edit == "none" and not gated)
    # rows past n are never read
    fblob[n:] = fblob[0]
    iblob[n:] = iblob[0]
    iblob[n:, _layout(CAPS)[0]["gang_id"][1]] = 3
    assert packed_batch_flags(fblob, iblob, n, table, CAPS) == got


# ---- the cache ----

def _port_db(node_dicts):
    db = StateDB(CAPS, device="cpu")
    for d in node_dicts:
        db.upsert_node(Node.from_dict(d))
    return db


def _jax_db(node_dicts):
    db = JStateDB(JCAPS)
    for d in node_dicts:
        db.upsert_node(JNode.from_dict(d))
    return db


@pytest.mark.parametrize("seed", range(3))
def test_cached_rows_equal_fresh_encoding_and_the_reference_cache(seed):
    rng = np.random.RandomState(70 + seed)
    nodes, half = random_cluster(rng, 30, BATCH // 2)
    # every spec twice, under another name the second time
    pod_dicts = half + [{**d, "metadata": {**d["metadata"], "name": f"{k}-again"}}
                        for k, d in enumerate(half)]
    pods = [Pod.from_dict(d) for d in pod_dicts]
    db = _port_db(nodes)
    cache = EncodeCache(CAPS, db.table)
    fblob, iblob = _blobs()
    for _ in range(2):  # the second pass hits on every row
        for i, pod in enumerate(pods):
            cache.encode_packed_into(fblob, iblob, i, pod)
    classes = {cache._key(p) for p in pods}
    assert cache.misses == len(classes) < len(pods)
    assert cache.hits == 2 * len(pods) - len(classes)
    # fresh encoding against a table that saw the same nodes
    fresh = encode_pods(pods, CAPS, _port_db(nodes).table)
    want_f, want_i = pack_batch(fresh, CAPS)
    np.testing.assert_array_equal(_bits(fblob), _bits(want_f))
    np.testing.assert_array_equal(iblob, want_i)
    # the reference package's cache on the same pods
    jcache = JEncodeCache(JCAPS, _jax_db(nodes).table)
    jf, ji = _j_blobs()
    for i, d in enumerate(pod_dicts):
        jcache.encode_packed_into(jf, ji, i, JPod.from_dict(d))
    keep = _read_cols()
    np.testing.assert_array_equal(_bits(fblob[:, keep]), _bits(jf[:, keep]))
    np.testing.assert_array_equal(iblob, ji)


def test_cache_is_lru_bounded(monkeypatch):
    monkeypatch.setattr(encode_cache, "MAX_ENTRIES", 2)
    db = _port_db([_node("n0")])
    cache = EncodeCache(CAPS, db.table)
    fblob, iblob = _blobs()
    pods = [Pod.from_dict(_pod(f"p{k}", nodeName=f"n{k}")) for k in range(3)]
    for i, pod in enumerate(pods + pods[2:]):
        cache.encode_packed_into(fblob, iblob, i, pod)
    assert (cache.misses, cache.hits) == (3, 1)
    cache.encode_packed_into(fblob, iblob, 0, pods[0])  # evicted first
    assert cache.misses == 4


def test_the_epoch_rule_and_claim_backed_pods():
    db = _port_db([_node("n0")])
    cache = EncodeCache(CAPS, db.table)
    fblob, iblob = _blobs()
    pod = Pod.from_dict(_pod("a", owner="rs-x"))
    cache.encode_packed_into(fblob, iblob, 0, pod)
    cache.encode_packed_into(fblob, iblob, 1, pod)     # the class row
    assert (cache.misses, cache.hits) == (1, 1)
    # a node interning the pod's controller as an avoid signature moves
    # the epoch: the class row may not be served
    epoch = db.table.pod_row_epoch
    db.upsert_node(Node.from_dict(_node("n1", avoid_uid="rs-x")))
    assert db.table.pod_row_epoch == epoch + 1
    cache.encode_packed_into(fblob, iblob, 2, pod)
    assert cache.misses == 2
    want_f, want_i = pack_row(encode_pods([pod], CAPS, db.table), 0, CAPS)
    np.testing.assert_array_equal(_bits(fblob[2]), _bits(want_f))
    np.testing.assert_array_equal(iblob[2], want_i)
    assert not np.array_equal(fblob[1], fblob[2])     # the avoid one-hot
    # a node naming a known signature does not move it
    db.upsert_node(Node.from_dict(_node("n2", avoid_uid="rs-x")))
    assert db.table.pod_row_epoch == epoch + 1
    # a claim-backed pod is never cached: the encoder sees it every time
    # (encoded since the EXT variant carries volumes: the claim is not
    # found, so one ANY attach atom of its own and a VolumeZone error)
    classes = len(cache._packed)
    claim = Pod.from_dict(_pod("a", owner="rs-x", volumes=[{
        "name": "v", "persistentVolumeClaim": {"claimName": "c"}}]))
    assert not encode_cache.cacheable(claim)
    for _ in range(2):
        cache.encode_packed_into(fblob, iblob, 3, claim)
    assert (len(cache._packed), cache.misses, cache.hits) == (classes, 2, 1)
    assert len(db.table.attach_atoms) == 1
    want_f, want_i = pack_row(encode_pods([claim], CAPS, db.table), 0, CAPS)
    np.testing.assert_array_equal(_bits(fblob[3]), _bits(want_f))
    np.testing.assert_array_equal(iblob[3], want_i)
    assert blob_col(fblob, iblob, "att_onehot", CAPS)[3].sum() == 1.0
    assert blob_col(fblob, iblob, "vz_fail", CAPS)[3] == 1


_BASE = _pod("base", owner="rs-x", nodeSelector={"disk": "ssd"},
             tolerations=[{"key": "k", "operator": "Exists"}])


def _variant(**change):
    d = _pod("variant", owner="rs-x", nodeSelector={"disk": "ssd"},
             tolerations=[{"key": "k", "operator": "Exists"}])
    for key, value in change.items():
        if key == "owner":
            d["metadata"]["ownerReferences"][0]["uid"] = value
        else:
            d["spec"][key] = value
    return d


_C = {"name": "c", "image": "pause"}
_FINGERPRINT_FIELDS = {
    "requests": _variant(containers=[{**_C, "resources": {"requests": {
        "cpu": "500m", "memory": "256Mi"}}}]),
    "limits presence": (
        _pod("base", owner="rs-x", containers=[_C]),
        _pod("variant", owner="rs-x", containers=[{**_C, "resources": {
            "limits": {"cpu": "1"}}}])),
    "containers": _variant(containers=2 * [{**_C, "resources": {"requests": {
        "cpu": "250m", "memory": "256Mi"}}}]),
    "nodeSelector": _variant(nodeSelector={"disk": "hdd"}),
    "tolerations": _variant(tolerations=[{"key": "k", "operator": "Equal",
                                          "value": "v"}]),
    "toleration effect": _variant(tolerations=[
        {"key": "k", "operator": "Exists", "effect": "NoSchedule"}]),
    "nodeName": _variant(nodeName="n0"),
    "node affinity": _variant(affinity={"nodeAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": {"nodeSelectorTerms": [
            {"matchExpressions": [{"key": "disk", "operator": "Exists"}]}]}}}),
    "preferred node affinity": _variant(affinity={"nodeAffinity": {
        "preferredDuringSchedulingIgnoredDuringExecution": [{
            "weight": 3, "preference": {"matchExpressions": [
                {"key": "disk", "operator": "In", "values": ["ssd"]}]}}]}}),
    "controller": _variant(owner="rs-y"),
}


@pytest.mark.parametrize("field", list(_FINGERPRINT_FIELDS))
def test_fingerprint_separates_every_field_the_encoder_reads(field):
    case = _FINGERPRINT_FIELDS[field]
    base, variant = case if isinstance(case, tuple) else (_BASE, case)
    db = _port_db([_node("n0", avoid_uid="rs-x"), _node("n1", avoid_uid="rs-y")])
    cache = EncodeCache(CAPS, db.table)
    fblob, iblob = _blobs()
    for i, d in enumerate((base, variant)):
        cache.encode_packed_into(fblob, iblob, i, Pod.from_dict(d))
    assert cache.misses == 2
    assert not (np.array_equal(fblob[0], fblob[1])
                and np.array_equal(iblob[0], iblob[1]))
    fresh = pack_batch(encode_pods([Pod.from_dict(base), Pod.from_dict(variant)],
                                   CAPS, _port_db([_node("n0", avoid_uid="rs-x"),
                                                   _node("n1", avoid_uid="rs-y")]
                                                  ).table), CAPS)
    np.testing.assert_array_equal(_bits(fblob[:2]), _bits(fresh[0][:2]))
    np.testing.assert_array_equal(iblob[:2], fresh[1][:2])


@pytest.mark.parametrize("meta, read", [
    ({"ns": "other"}, True), ({"labels": {"app": "web"}}, True),
    ({"annotations": {"note": "x"}}, False), ({"name": "another"}, False),
    ({"annotations": {"scheduling.ktpu.io/group-name": "g",
                      "scheduling.ktpu.io/group-min": "2"}}, False)],
    ids=["namespace", "labels", "annotations", "name", "gang_annotations"])
def test_fingerprint_ignores_what_the_encoder_never_reads(meta, read):
    """Annotations, names and images share a class. Namespace and labels
    are read by the spreading encoder, so they separate classes; both rows
    still equal the fresh encoding."""
    db = _port_db([_node("n0", avoid_uid="rs-x")])
    cache = EncodeCache(CAPS, db.table)
    fblob, iblob = _blobs()
    other = _pod(meta.get("name", "base"), ns=meta.get("ns", "default"),
                 labels=meta.get("labels"), annotations=meta.get("annotations"),
                 owner="rs-x", nodeSelector={"disk": "ssd"},
                 tolerations=[{"key": "k", "operator": "Exists"}])
    other["spec"]["containers"][0]["image"] = "nginx:1"
    pods = [Pod.from_dict(d) for d in (_BASE, other)]
    for i, pod in enumerate(pods):
        cache.encode_packed_into(fblob, iblob, i, pod)
    assert (cache.misses, cache.hits) == ((2, 0) if read else (1, 1))
    fresh = pack_batch(encode_pods(pods, CAPS, _port_db(
        [_node("n0", avoid_uid="rs-x")]).table), CAPS)
    np.testing.assert_array_equal(_bits(fblob[:2]), _bits(fresh[0][:2]))
    np.testing.assert_array_equal(iblob[:2], fresh[1][:2])


@pytest.mark.parametrize("feature, meta, spec", [
    ("pod priority", {}, {"priority": 10}),
    ("host ports", {}, {"containers": [{"name": "c", "image": "pause",
                                        "ports": [{"containerPort": 80, "hostPort": 80}],
                                        "resources": {"requests": {
                                            "cpu": "250m", "memory": "256Mi"}}}]}),
    ("volumes", {}, {"volumes": [{"name": "v", "persistentVolumeClaim": {
        "claimName": "c"}}]}),
])
def test_refused_pods_are_never_served_from_the_cache(feature, meta, spec):
    db = _port_db([_node("n0")])
    cache = EncodeCache(CAPS, db.table)
    fblob, iblob = _blobs()
    base = Pod.from_dict(_pod("base"))
    cache.encode_packed_into(fblob, iblob, 0, base)
    d = _pod("base", **spec)  # the cached pod, updated
    d["metadata"].update(meta)
    refused = Pod.from_dict(d)
    if feature == "pod priority":
        # encoded since the preemption pass: the changed priority is a
        # class of its own, never the cached base's row
        for _ in range(2):
            cache.encode_packed_into(fblob, iblob, 1, refused)
        assert cache.misses == 2 and cache.hits == 1
        assert blob_col(fblob, iblob, "priority", CAPS)[[0, 1]].tolist() == [0, 10]
        return
    if feature == "host ports":
        # encoded since the EXT variant: the port row is a class of its own,
        # never the cached base's row, and a hit equals a fresh encode
        for _ in range(2):
            cache.encode_packed_into(fblob, iblob, 1, refused)
        assert cache.misses == 2 and cache.hits == 1
        ports = blob_col(fblob, iblob, "port_onehot", CAPS)
        assert ports[0].sum() == 0 and ports[1, db.table.ports[80]] == 1.0
        fresh = pack_batch(encode_pods([base, refused], CAPS, _port_db(
            [_node("n0")]).table), CAPS)
        np.testing.assert_array_equal(_bits(fblob[:2]), _bits(fresh[0][:2]))
        np.testing.assert_array_equal(iblob[:2], fresh[1][:2])
        return
    # volumes: encoded since the EXT variant carries them; a claim-backed
    # pod is never stored to hit later, and each encode equals a fresh one
    for _ in range(2):
        cache.encode_packed_into(fblob, iblob, 1, refused)
    assert cache.hits == 0 and len(cache._packed) == 1
    fresh = pack_batch(encode_pods([base, refused], CAPS, db.table), CAPS)
    np.testing.assert_array_equal(_bits(fblob[:2]), _bits(fresh[0][:2]))
    np.testing.assert_array_equal(iblob[:2], fresh[1][:2])


# ---- the driver ----

def _fresh_chain(node_dicts, chunks):
    """The fresh-encode path chained by hand: encode_pods, batch_from_numpy,
    schedule_batch, commit."""
    db = _port_db(node_dicts)
    rr = 0
    placed = {}
    for chunk in chunks:
        host = encode_pods(chunk, CAPS, db.table)
        state = db.flush()
        res = schedule_batch(state, batch_from_numpy(host, "cpu"), rr)
        rows = res.assignments.numpy()
        names = [db.table.name_of[r] if r >= 0 else None for r in rows[:len(chunk)]]
        db.commit_batch(res, pack_batch(host, CAPS)[0],
                        [(p, n, i) for i, (p, n) in enumerate(zip(chunk, names))
                         if n is not None])
        rr = res.rr_end
        placed.update({p.key: n for p, n in zip(chunk, names)})
    return placed, db


@pytest.mark.parametrize("seed", range(2))
def test_scheduler_through_the_cache_places_as_fresh_and_the_reference(seed):
    from tests.test_torch_solver import _chained_reference

    rng = np.random.RandomState(300 + seed)  # test_torch_solver's clusters
    nodes, pod_dicts = random_cluster(rng, 30, 3 * BATCH)
    want, jtable = _chained_reference(nodes, pod_dicts, 3)
    expected = {}
    for k, res in enumerate(want):
        for i, row in enumerate(np.asarray(res.assignments)):
            expected[f"default/{pod_dicts[k * BATCH + i]['metadata']['name']}"] = (
                jtable.name_of[row] if row >= 0 else None)
    pods = [Pod.from_dict(d) for d in pod_dicts]
    sched = Scheduler(CAPS, device="cpu")
    sched.add_nodes([Node.from_dict(d) for d in nodes])
    assert sched.schedule(pods) == expected
    assert sched.encode_cache.hits > 0
    fresh, fresh_db = _fresh_chain(nodes, [pods[k * BATCH:(k + 1) * BATCH]
                                           for k in range(3)])
    assert fresh == expected
    np.testing.assert_array_equal(sched.statedb.host.requested,
                                  fresh_db.host.requested)
    assert all(sched.statedb.is_accounted(k) for k, v in expected.items() if v)

    # ragged chunks: a short batch after a full one must not see the
    # full batch's rows in its reused blobs' tail
    chunks = [pods[:BATCH], pods[BATCH:BATCH + 3], pods[BATCH + 3:2 * BATCH + 3]]
    ragged = Scheduler(CAPS, device="cpu")
    ragged.add_nodes([Node.from_dict(d) for d in nodes])
    got = {}
    for chunk in chunks:
        got.update(ragged.schedule(chunk))
    assert got == _fresh_chain(nodes, chunks)[0]


def _j_schedule(jdb, jcache, pod_dicts, rr):
    """One batch through the reference package's cache, blobs, solver and
    commit, as its driver runs them."""
    jpods = [JPod.from_dict(d) for d in pod_dicts]
    fblob, iblob = _j_blobs()
    for i, pod in enumerate(jpods):
        jcache.encode_packed_into(fblob, iblob, i, pod)
    state = jdb.flush()
    res = jax_solve(state, j_unpack_batch(fblob, iblob, JCAPS), rr, pallas=False)
    rows = np.asarray(res.assignments)
    names = [jdb.table.name_of[r] if r >= 0 else None for r in rows]
    jdb.commit_batch(res, fblob, [(p, n, i) for i, (p, n)
                                  in enumerate(zip(jpods, names)) if n])
    return {p.key: n for p, n in zip(jpods, names)}, int(np.asarray(res.rr_end))


def test_lifecycle_matches_the_reference_statedb():
    rng = np.random.RandomState(90)
    nodes, pod_dicts = random_cluster(rng, 40, 5 * BATCH)
    bound, batch1, batch2 = (pod_dicts[:2 * BATCH], pod_dicts[2 * BATCH:3 * BATCH],
                             pod_dicts[3 * BATCH:4 * BATCH])
    sched = Scheduler(CAPS, device="cpu")
    sched.add_nodes([Node.from_dict(d) for d in nodes])
    jdb = _jax_db(nodes)
    jcache = JEncodeCache(JCAPS, jdb.table)

    # bound pods, some on a node the cluster does not have
    for k, d in enumerate(bound):
        node = f"n{rng.randint(44)}"
        assert sched.add_pod(Pod.from_dict(d), node) == jdb.add_pod(
            JPod.from_dict(d), node) == (node in jdb.table.row_of), node
    # accounting a pod twice changes nothing
    before = sched.statedb.host.requested.copy()
    first = next(d for d in bound if sched.statedb.is_accounted(
        f"default/{d['metadata']['name']}"))
    assert sched.add_pod(Pod.from_dict(first), "n1")
    np.testing.assert_array_equal(sched.statedb.host.requested, before)
    got1 = sched.schedule([Pod.from_dict(d) for d in batch1])
    want1, rr = _j_schedule(jdb, jcache, batch1, 0)
    assert got1 == want1

    # deletions: bound and scheduled pods, then nodes; a new node reuses
    # the row freed last
    gone = [f"default/{d['metadata']['name']}" for d in bound[::3] + batch1[::2]]
    for key in gone:
        assert sched.statedb.is_accounted(key) == jdb.is_accounted(key)
        sched.remove_pod(key)
        jdb.remove_pod(key)
        assert not sched.statedb.is_accounted(key)
    for name in ("n3", "n17", "n29", "n99"):
        sched.remove_node(name)
        jdb.remove_node(name)
        assert not sched.statedb.has_node(name)
    freed = sched.statedb.table.free[-1]
    fresh_nodes = random_cluster(np.random.RandomState(91), 2, 0)[0]
    for k, d in enumerate(fresh_nodes):
        d["metadata"]["name"] = f"new{k}"
        sched.add_nodes([Node.from_dict(d)])
        jdb.upsert_node(JNode.from_dict(d))
    assert sched.statedb.table.row_of["new0"] == freed
    assert sched.statedb.table.row_of == jdb.table.row_of
    assert sched.statedb.table.free == jdb.table.free
    assert sched.statedb.ledger_dirty
    np.testing.assert_array_equal(sched.statedb.host.requested,
                                  jdb.host.requested)

    got2 = sched.schedule([Pod.from_dict(d) for d in batch2])
    want2, _ = _j_schedule(jdb, jcache, batch2, rr)
    assert got2 == want2
    assert None in got2.values() and any(got2.values())
    for name in ("requested", "nonzero_requested", "topology", "valid",
                 "allocatable", "sel_member", "name_lo"):
        np.testing.assert_array_equal(getattr(sched.statedb.host, name),
                                      np.asarray(getattr(jdb.host, name)),
                                      err_msg=name)
    # the device mirror equals the host truth after a flush
    dev = sched.statedb.flush()
    np.testing.assert_array_equal(dev.requested.numpy(), sched.statedb.host.requested)
    assert not sched.statedb.ledger_dirty


def test_statedb_refuses_bound_pods_it_cannot_account():
    # (bound host-port and volume pods are accounted since the EXT variant
    # carries them, as the reference accounts them; only a pod on an
    # unknown node is refused)
    db, jdb = _port_db([_node("n0")]), _jax_db([_node("n0")])
    d = _pod("hp", volumes=[{"name": "d", "gcePersistentDisk": {"pdName": "disk-0"}},
                            {"name": "e", "awsElasticBlockStore": {"volumeID": "v"}}])
    assert db.add_pod(Pod.from_dict(d), "n0") and jdb.add_pod(JPod.from_dict(d), "n0")
    for name in ("vol_any", "vol_rw", "attach_count", "requested"):
        np.testing.assert_array_equal(getattr(db.host, name),
                                      np.asarray(getattr(jdb.host, name)), err_msg=name)
    assert db.host.vol_rw[0, :2].tolist() == [1.0, 1.0]
    assert db.add_pod(Pod.from_dict(_pod("x")), "missing") is False
    assert not db.is_accounted("default/x")


def test_mark_ledger_dirty_reuploads_the_host_ledger():
    db = _port_db([_node("n0"), _node("n1")])
    dev = db.flush()
    rows = db.flush_rows_total
    dev.requested += 5.0   # device charges the host truth does not have
    db.mark_ledger_dirty()
    assert db.ledger_dirty
    dev = db.flush()
    assert not dev.requested.any()
    assert db.flush_rows_total == rows + N_NODES

