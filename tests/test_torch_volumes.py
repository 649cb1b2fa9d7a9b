"""Volumes (the vol and attach gates, VolumeZone and VolumeNode) in
kubernetes_tpu_torch against the reference package on the CPU: the
encoder's conflict, attach, zone and PV-selector rows and the NodeTable's
atoms, claims resolved through PVs (bound, not found, not bound, without a
name) and the feature gate; the NodeTable's `volsel_member` and
`attach_type` after a refresh and for a node added later; both StateDBs'
conflict and attach ledgers through add_pod and remove_pod (a broken claim
skipped); NoDiskConflict, MaxPDVolumeCount, VolumeZone and VolumeNode
against JAX's predicates on the cases of the reference's
tests/test_volumes.py (EBS read-write whatever its flag, an RBD disk on
several monitors, ANY atoms of claims not found, a disk listed twice), with
the answers that file expects through the port's `schedule_batch`; a numpy
model of the EXT variant's words against JAX's predicates at full 64-atom
universes (bit 63); `schedule_batch` with the vol and attach gates, gang
off and on (groups that revert), normalization flag off and on, against
JAX `schedule_batch` on every field and ledger; the wrapper's post-scan
ledger sums against the plain scan's carry; the 64-atom limit; a Scheduler
over two batches against the reference's StateDB, encode cache and solver
and against tests/serial_reference.py; KUBE_MAX_PD_VOLS; the refusal with
SelectorSpread; and the volumes traffic at a small size. Every comparison
is exact: counts, requests and scores are integer-valued f32. The
reference is jitted once per gate set (three), at 64 nodes x 32 pods."""

import dataclasses
import json

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
from kubernetes_tpu.models.policy import Policy as JPolicy  # noqa: E402
from kubernetes_tpu.ops import predicates as jpreds  # noqa: E402
from kubernetes_tpu.ops import solver as jsolver  # noqa: E402
from kubernetes_tpu.state import Capacities as JCaps  # noqa: E402
from kubernetes_tpu.state.context import EncodeContext as JContext  # noqa: E402
from kubernetes_tpu.state.encode_cache import EncodeCache as JEncodeCache  # noqa: E402
from kubernetes_tpu.state.pod_batch import empty_batch as j_empty_batch  # noqa: E402
from kubernetes_tpu.state.pod_batch import encode_pods as j_encode_pods  # noqa: E402
from kubernetes_tpu.state.pod_batch import pack_batch as j_pack_batch  # noqa: E402
from kubernetes_tpu.state.pod_batch import unpack_batch as j_unpack_batch  # noqa: E402
from kubernetes_tpu.state.statedb import StateDB as JStateDB  # noqa: E402

from kubernetes_tpu_torch.api import objects as obj  # noqa: E402
from kubernetes_tpu_torch.models.policy import DEFAULT_POLICY, Policy  # noqa: E402
from kubernetes_tpu_torch.ops import predicates as preds  # noqa: E402
from kubernetes_tpu_torch.ops.assign_scan import (  # noqa: E402
    EXT_MAX_UP,
    GangInputs,
    assign_scan_ext,
    assign_scan_gang_ext_plain,
    ext_ledgers,
    pack_words,
)
from kubernetes_tpu_torch.ops.solver import (  # noqa: E402
    BatchFlags,
    check_supported,
    ext_inputs,
    masked_static_scores,
    policy_gates,
    schedule_batch,
)
from kubernetes_tpu_torch.perf.harness import (  # noqa: E402
    VOLUMES_DATA_DISKS,
    volumes_caps,
    volumes_cluster,
    volumes_pods,
)
from kubernetes_tpu_torch.scheduler import Scheduler  # noqa: E402
from kubernetes_tpu_torch.state import Capacities  # noqa: E402
from kubernetes_tpu_torch.state.context import EncodeContext  # noqa: E402
from kubernetes_tpu_torch.state.convert import (  # noqa: E402
    batch_from_numpy,
    rr_from_numpy,
)
from kubernetes_tpu_torch.state.layout import VolType  # noqa: E402
from kubernetes_tpu_torch.state.pod_batch import batch_flags, encode_pods  # noqa: E402
from kubernetes_tpu_torch.state.statedb import StateDB  # noqa: E402
from tests.serial_reference import SerialScheduler  # noqa: E402
from tests.test_torch_state import random_cluster  # noqa: E402

N_NODES, P = 64, 32
CAPS = Capacities(num_nodes=N_NODES, batch_pods=P)
JCAPS = JCaps(num_nodes=N_NODES, batch_pods=P)
GATES = ("ipa", "spread", "svcanti", "vol", "attach", "tt", "na", "ports",
         "gpu", "storage", "gang", "preempt")
VOL_FIELDS = ("vol_want_rw", "vol_want_ro", "att_onehot", "att_fail", "vz_onehot",
              "vz_count", "vz_fail", "vs_onehot", "vs_count", "vs_fail")
LEDGERS = ("vol_any", "vol_rw", "attach_count")
FIELDS = ("assignments", "scores", "feasible_counts", "new_requested",
          "new_nonzero")
ZONE = "failure-domain.beta.kubernetes.io/zone"
AFFINITY = "volume.alpha.kubernetes.io/node-affinity"
# the fused static mask's predicates, which every policy the port carries
# runs, then the volume predicates of a case
BASE = ("GeneralPredicates", "PodToleratesNodeTaints", "CheckNodeCondition",
        "CheckNodeMemoryPressure", "CheckNodeDiskPressure")


def jflags(names):
    return jsolver.BatchFlags(*(g in names for g in GATES))


def pflags(names):
    return BatchFlags(*(g in names for g in GATES))


def node(name, labels=None, cpu="64", pods="110"):
    return {"metadata": {"name": name, "labels": labels or {}},
            "status": {"allocatable": {"cpu": cpu, "memory": "256Gi", "pods": pods},
                       "conditions": [{"type": "Ready", "status": "True"}]}}


def pod(name, volumes=(), node_name="", cpu="100m"):
    return {"metadata": {"name": name, "namespace": "default", "uid": f"uid-{name}"},
            "spec": {"nodeName": node_name,
                     "containers": [{"name": "c", "resources": {"requests": {"cpu": cpu}}}],
                     "volumes": list(volumes)}}


def gce(pd, ro=False):
    return {"name": pd, "gcePersistentDisk": {"pdName": pd, "readOnly": ro}}


def ebs(vid, ro=False):
    return {"name": vid, "awsElasticBlockStore": {"volumeID": vid, "readOnly": ro}}


def rbd(image, monitors, ro=False):
    return {"name": image, "rbd": {"monitors": monitors, "pool": "rbd", "image": image,
                                   "readOnly": ro}}


def iscsi(iqn, ro=False):
    return {"name": iqn, "iscsi": {"iqn": iqn, "readOnly": ro}}


def azure(disk):
    return {"name": disk, "azureDisk": {"diskName": disk}}


def claim(name):
    return {"name": name, "persistentVolumeClaim": {"claimName": name}}


SECRETS = [{"name": "token", "secret": {"secretName": "default-token"}},
           {"name": "conf", "configMap": {"name": "app"}},
           {"name": "tmp", "emptyDir": {}},
           {"name": "info", "downwardAPI": {"items": []}},
           {"name": "host", "hostPath": {"path": "/var/log"}}]


def pv(name, spec, zone=None, affinity=None):
    meta = {"name": name, "labels": {ZONE: zone} if zone else {}}
    if affinity is not None:
        meta["annotations"] = {AFFINITY: json.dumps(
            {"requiredDuringSchedulingIgnoredDuringExecution": {"nodeSelectorTerms": [
                {"matchExpressions": affinity}]}})}
    return {"metadata": meta, "spec": spec}


def pvc(name, volume_name=""):
    return {"metadata": {"name": name, "namespace": "default"},
            "spec": {"volumeName": volume_name} if volume_name else {}}


def contexts(pvs=(), pvcs=(), local=False):
    """(the port's EncodeContext, the reference's) over the same PV and
    claim dicts."""
    def lookups(module):
        vols = {d["metadata"]["name"]: module.PersistentVolume.from_dict(d) for d in pvs}
        claims = {("default", d["metadata"]["name"]):
                  module.PersistentVolumeClaim.from_dict(d) for d in pvcs}
        return dict(get_pvc=lambda ns, name: claims.get((ns, name)), get_pv=vols.get,
                    local_volumes_enabled=local)
    return EncodeContext(**lookups(obj)), JContext(**lookups(jobj))


class Both:
    """The port's StateDB and the reference's over the same nodes, bound
    pods, PVs and claims; `encode` encodes pending pods against each."""

    def __init__(self, nodes, bound=(), pvs=(), pvcs=(), local=False):
        self.ctx, self.jctx = contexts(pvs, pvcs, local)
        self.db = StateDB(CAPS, "cpu", self.ctx)
        self.jdb = JStateDB(JCAPS, volume_ctx=self.jctx)
        for d in nodes:
            self.db.upsert_node(obj.Node.from_dict(d))
            self.jdb.upsert_node(jobj.Node.from_dict(d))
        for d in bound:
            assert self.db.add_pod(obj.Pod.from_dict(d))
            assert self.jdb.add_pod(jobj.Pod.from_dict(d))

    def encode(self, pending):
        batch = encode_pods([obj.Pod.from_dict(d) for d in pending], CAPS, self.db.table,
                            ctx=self.ctx)
        jbatch = j_encode_pods([jobj.Pod.from_dict(d) for d in pending], JCAPS,
                               self.jdb.table, ctx=self.jctx)
        return batch, jbatch

    def flush(self):
        return self.db.flush(), self.jdb.flush()


def assert_tables_equal(table, jtable):
    assert table.vol_atoms == jtable.vol_atoms
    assert table.attach_atoms == jtable.attach_atoms
    assert table.attach_types == jtable.attach_types
    assert list(table.volsels) == list(jtable.volsels)
    assert table.sel_terms == jtable.sel_terms


# ---- (a) the encoder, the NodeTable and the StateDB ----

PVS = [pv("pv-ebs", {"awsElasticBlockStore": {"volumeID": "v9"}}, zone="us-a"),
       pv("pv-gce", {"gcePersistentDisk": {"pdName": "pd-z"}}, zone="us-b"),
       pv("pv-az", {"azureDisk": {"diskName": "az-1"}}),
       pv("pv-local", {"local": {"path": "/mnt/x"}},
          affinity=[{"key": "disk", "operator": "In", "values": ["local-1"]}]),
       pv("pv-bad", {"local": {"path": "/mnt/y"}})]
PVS[4]["metadata"]["annotations"] = {AFFINITY: "{not json"}
PVCS = [pvc("c-ebs", "pv-ebs"), pvc("c-gce", "pv-gce"), pvc("c-az", "pv-az"),
        pvc("c-local", "pv-local"), pvc("c-bad", "pv-bad"), pvc("c-loose"),
        pvc("c-gone", "pv-missing")]
CASES = {
    "gce_rw_and_ro": [gce("pd-1"), gce("pd-2", ro=True)],
    "ebs_always_rw": [ebs("v1", ro=True), ebs("v2")],
    "rbd_on_monitors": [rbd("img", ["m1", "m2", "m3"], ro=True), rbd("img2", ["m1"])],
    "iscsi_and_azure": [iscsi("iqn-1"), iscsi("iqn-2", ro=True), azure("az-9")],
    "disk_listed_twice": [gce("pd-1"), gce("pd-1"), ebs("v1"), ebs("v1")],
    "claims": [claim("c-ebs"), claim("c-gce"), claim("c-az"), gce("pd-1")],
    "claim_not_found": [claim("ghost"), claim("c-ebs")],
    "claim_not_bound": [claim("c-loose")],
    "claim_without_a_name": [{"name": "x", "persistentVolumeClaim": {}}],
    "pv_not_found": [claim("c-gone")],
    "local_pv_affinity": [claim("c-local"), claim("c-gce")],
    "bad_affinity_annotation": [claim("c-bad")],
    "secrets_only": SECRETS,
}


@pytest.mark.parametrize("local", [False, True], ids=["gate_off", "gate_on"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_encoder_volume_rows_match_reference(case, local):
    nodes = [node("n0", {ZONE: "us-a"}), node("n1", {"disk": "local-1"})]
    both = Both(nodes, pvs=PVS, pvcs=PVCS, local=local)
    # the case's pod twice under two names (a claim not found is an atom of
    # each pod), then a pod with volumes no predicate reads
    pending = [pod("a", CASES[case]), pod("b", CASES[case]), pod("c", SECRETS)]
    batch, jbatch = both.encode(pending)
    for name in VOL_FIELDS:
        np.testing.assert_array_equal(getattr(batch, name), np.asarray(getattr(jbatch, name)),
                                      err_msg=name)
    assert_tables_equal(both.db.table, both.jdb.table)
    assert not batch.vol_want_rw[2].any() and not batch.att_onehot[2].any()
    state, jstate = both.flush()
    for name in ("volsel_member", "attach_type", "sel_member"):
        np.testing.assert_array_equal(getattr(state, name).numpy(),
                                      np.asarray(getattr(jstate, name)), err_msg=name)


def test_volumes_no_predicate_reads_raise_no_gate():
    both = Both([node("n0")])
    batch, _jbatch = both.encode([pod("a", SECRETS), pod("b")])
    state, _ = both.flush()
    flags = batch_flags(state, batch_from_numpy(batch, "cpu"))
    assert not (flags.vol or flags.attach)
    assert not both.db.table.vol_atoms and not both.db.table.attach_atoms


def test_node_table_columns_refresh_like_the_reference():
    """PV selectors interned after nodes were encoded refill volsel_member,
    a node added later is filled against every selector, and attach types
    reach attach_type at the flush."""
    nodes = [node(f"n{i}", {"disk": "local-1"} if i % 2 else {}) for i in range(6)]
    both = Both(nodes, pvs=PVS, pvcs=PVCS, local=True)
    both.encode([pod("a", [claim("c-local"), claim("c-az")]), pod("b", [ebs("v1")])])
    state, jstate = both.flush()
    for d in (node("late", {"disk": "local-1"}), node("later")):
        both.db.upsert_node(obj.Node.from_dict(d))
        both.jdb.upsert_node(jobj.Node.from_dict(d))
    state, jstate = both.flush()
    for name in ("volsel_member", "attach_type"):
        np.testing.assert_array_equal(getattr(state, name).numpy(),
                                      np.asarray(getattr(jstate, name)), err_msg=name)
    assert state.volsel_member[:, 0].sum() == 4   # n1, n3, n5 and late
    assert state.attach_type[:2].tolist() == [VolType.AZURE, VolType.EBS]


def _random_volumes(rng, n):
    choices = [lambda: gce(f"pd-{rng.randint(3)}", ro=rng.rand() < 0.5),
               lambda: ebs(f"v{rng.randint(3)}", ro=rng.rand() < 0.3),
               lambda: rbd("img", [f"m{rng.randint(4)}", f"m{rng.randint(4)}"],
                           ro=rng.rand() < 0.5),
               lambda: claim(["c-ebs", "c-gce", "c-az", "ghost", "c-loose"][rng.randint(5)]),
               lambda: SECRETS[rng.randint(len(SECRETS))]]
    return [choices[rng.randint(len(choices))]() for _ in range(n)]


@pytest.mark.parametrize("seed", range(2))
def test_statedb_accounts_bound_volumes_like_the_reference(seed):
    rng = np.random.RandomState(seed)
    nodes = [node(f"n{i}", {ZONE: ["us-a", "us-b"][i % 2]}) for i in range(8)]
    bound = [pod(f"b{i}", _random_volumes(rng, rng.randint(1, 4)),
                 node_name=f"n{rng.randint(8)}") for i in range(12)]
    both = Both(nodes, bound, PVS, PVCS)
    state, jstate = both.flush()
    for name in LEDGERS + ("attach_type",):
        np.testing.assert_array_equal(getattr(both.db.host, name),
                                      np.asarray(getattr(both.jdb.host, name)), err_msg=name)
        np.testing.assert_array_equal(getattr(state, name).numpy(),
                                      np.asarray(getattr(jstate, name)), err_msg=name)
    assert_tables_equal(both.db.table, both.jdb.table)
    assert both.db.host.vol_any.any() and both.db.host.attach_count.any()
    for d in bound[::3]:
        both.db.remove_pod(f"default/{d['metadata']['name']}")
        both.jdb.remove_pod(f"default/{d['metadata']['name']}")
    state, jstate = both.flush()
    for name in LEDGERS:
        np.testing.assert_array_equal(getattr(both.db.host, name),
                                      np.asarray(getattr(both.jdb.host, name)), err_msg=name)
        np.testing.assert_array_equal(getattr(state, name).numpy(), getattr(both.db.host, name))


# ---- (b) the predicates on the reference's cases ----

def _case(name):
    """(nodes, bound pods, pending pods, PVs, claims, local gate, policy
    predicates, the placements tests/test_volumes.py expects)."""
    n0, n1 = node("n0"), node("n1")
    zpv = pv("pv-z", {"gcePersistentDisk": {"pdName": "pd"}}, zone="us-a")
    lpv = pv("pv-l", {"local": {"path": "/mnt/disks/x"}},
             affinity=[{"key": "disk", "operator": "In", "values": ["local-1"]}])
    ebs_pv = pv("pv-1", {"awsElasticBlockStore": {"volumeID": "v9"}})
    disk, ebs2 = ("NoDiskConflict",), ("MaxEBSVolumeCount",)
    return {
        "gce_rw_conflicts": ([n0, n1], [pod("a", [gce("pd-1")], "n0")],
                             [pod("p", [gce("pd-1")])], (), (), False, disk, ["n1"]),
        "gce_both_readonly": ([n0], [pod("a", [gce("pd-1", True)], "n0")],
                              [pod("p", [gce("pd-1", True)])], (), (), False, disk, ["n0"]),
        "ebs_conflicts_read_only": ([n0], [pod("a", [ebs("vol-1")], "n0")],
                                    [pod("p", [ebs("vol-1", ro=True)])], (), (), False,
                                    disk, [None]),
        "rbd_monitor_overlap": ([n0, n1], [pod("a", [rbd("img", ["m1", "m2"])], "n0")],
                                [pod("p", [rbd("img", ["m2", "m3"])])], (), (), False, disk,
                                ["n1"]),
        "rbd_disjoint_monitors": ([n0, n1], [pod("a", [rbd("img", ["m1", "m2"])], "n0")],
                                  [pod("q", [rbd("img", ["m4"])])], (), (), False, disk,
                                  ["n0"]),
        "in_batch_conflict_listed_twice": ([n0, n1], [],
                                           [pod("p1", [gce("pd"), gce("pd")]),
                                            pod("p2", [gce("pd", True)])], (), (), False,
                                           disk, ["n0", "n1"]),
        "over_limit": ([n0], [pod("a", [ebs("v1"), ebs("v2")], "n0")],
                       [pod("p", [ebs("v3")])], (), (), False, ebs2, [None]),
        "reusing_attached_volume": ([n0], [pod("a", [ebs("v1"), ebs("v2")], "n0")],
                                    [pod("p", [ebs("v1")])], (), (), False, ebs2, ["n0"]),
        "no_relevant_volumes": ([n0], [pod("a", [ebs("v1"), ebs("v2"), ebs("v3")], "n0")],
                                [pod("p", [gce("pd")])], (), (), False, ebs2, ["n0"]),
        "pvc_resolution": ([n0], [pod("a", [ebs("v1"), ebs("v2")], "n0")],
                           [pod("p", [claim("claim")])], [ebs_pv], [pvc("claim", "pv-1")],
                           False, ebs2, [None]),
        "missing_pvc_counts_any": ([n0], [pod("a", [ebs("v1"), ebs("v2")], "n0")],
                                   [pod("p", [claim("ghost")])], (), (), False, ebs2,
                                   [None]),
        "unbound_pvc_fails": ([n0], [], [pod("p", [claim("claim")])], (),
                              [pvc("claim")], False, ebs2, [None]),
        "zone_match_required": ([node("n0", {ZONE: "us-b"}), node("n1", {ZONE: "us-a"})],
                                [], [pod("p", [claim("claim")])], [zpv],
                                [pvc("claim", "pv-z")], False, ("NoVolumeZoneConflict",),
                                ["n1"]),
        "unzoned_node_passes": ([node("n0", {ZONE: "us-b"}), n1], [],
                                [pod("p", [claim("claim")])], [zpv], [pvc("claim", "pv-z")],
                                False, ("NoVolumeZoneConflict",), ["n1"]),
        "missing_pv_fails_on_zoned_nodes": ([node("n0", {ZONE: "us-a"})], [],
                                            [pod("p", [claim("ghost")])], (), (), False,
                                            ("NoVolumeZoneConflict",), [None]),
        "missing_pv_unzoned_cluster": ([n1], [], [pod("p", [claim("ghost")])], (), (),
                                       False, ("NoVolumeZoneConflict",), ["n1"]),
        "affinity_pins_node": ([n0, node("n1", {"disk": "local-1"})], [],
                               [pod("p", [claim("claim")])], [lpv], [pvc("claim", "pv-l")],
                               True, ("NoVolumeNodeConflict",), ["n1"]),
        "feature_gate_off_ignores": ([n0], [], [pod("p", [claim("claim")])], [lpv],
                                     [pvc("claim", "pv-l")], False,
                                     ("NoVolumeNodeConflict",), ["n0"]),
    }[name]


CASE_NAMES = ("gce_rw_conflicts", "gce_both_readonly", "ebs_conflicts_read_only",
              "rbd_monitor_overlap", "rbd_disjoint_monitors",
              "in_batch_conflict_listed_twice", "over_limit",
              "reusing_attached_volume", "no_relevant_volumes", "pvc_resolution",
              "missing_pvc_counts_any", "unbound_pvc_fails", "zone_match_required",
              "unzoned_node_passes", "missing_pv_fails_on_zoned_nodes",
              "missing_pv_unzoned_cluster", "affinity_pins_node", "feature_gate_off_ignores")


@pytest.mark.parametrize("case", CASE_NAMES)
def test_volume_predicates_match_reference_on_its_cases(case):
    nodes, bound, pending, pvs, pvcs, local, predicates, want = _case(case)
    both = Both(nodes, bound, pvs, pvcs, local)
    batch, jbatch = both.encode(pending)
    state, jstate = both.flush()
    dbatch = batch_from_numpy(batch, "cpu")
    maxes = ((VolType.EBS, 2), (VolType.GCE, 2))
    got = {"disk": preds.no_disk_conflict(state.vol_any, state.vol_rw, dbatch.vol_want_rw,
                                          dbatch.vol_want_ro),
           "attach": preds.max_attach_ok(state.attach_count, state.attach_type,
                                         dbatch.att_onehot, dbatch.att_fail, maxes),
           "zone": preds.volume_zone(state, dbatch),
           "node": preds.volume_node(state, dbatch)}
    for i in range(len(pending)):
        jpod = jax.tree.map(lambda a, i=i: np.asarray(a)[i], jbatch)
        ref = {"disk": jpreds.no_disk_conflict(jstate, jpod),
               "attach": jpreds.max_attach_ok(jstate, jpod, maxes),
               "zone": jpreds.volume_zone(jstate, jpod),
               "node": jpreds.volume_node(jstate, jpod)}
        for name in got:
            np.testing.assert_array_equal(got[name][i].numpy(), np.asarray(ref[name]),
                                          err_msg=f"{name} pod {i}")
    # the answer the reference's test expects, through the port's solver
    policy = Policy(predicates=BASE + predicates, max_ebs_volumes=2)
    res = schedule_batch(state, dbatch, 0, policy)
    names = both.db.table.name_of
    assert [names[r] if r >= 0 else None for r in res.assignments[:len(pending)].tolist()] \
        == want


# ---- (c) the EXT variant's words against the reference ----

def _full_universe_state(rng, n, p):
    """Conflict and attach counts and pod rows over 64-atom universes,
    atoms 0, 1, 31, 32 and 63 most often; a disk listed twice, attach
    types cycled over EBS, GCE, Azure and ANY, a few fail bits."""
    u = 64
    hot = np.array([0, 1, 31, 32, 63])

    def atoms(k):
        return np.where(rng.rand(k) < 0.7, rng.choice(hot, k), rng.randint(0, u, k))

    vol_any = np.zeros((n, u), np.float32)
    vol_rw = np.zeros((n, u), np.float32)
    attach = np.zeros((n, u), np.float32)
    for i in range(n):
        if rng.rand() < 0.5:
            a = atoms(2)
            vol_any[i, a] += rng.randint(1, 3, 2)
            if rng.rand() < 0.4:
                vol_rw[i, a[0]] = vol_any[i, a[0]]
        if rng.rand() < 0.5:
            attach[i, atoms(rng.randint(1, 4))] += 1.0
    want_rw = np.zeros((p, u), np.float32)
    want_ro = np.zeros((p, u), np.float32)
    att = np.zeros((p, u), np.float32)
    for i in range(p):
        if rng.rand() < 0.4:
            want_rw[i, atoms(1)] += rng.randint(1, 3)
        if rng.rand() < 0.4:
            want_ro[i, atoms(1)] = 1.0
        if rng.rand() < 0.6:
            att[i, atoms(rng.randint(1, 4))] = 1.0
    return (vol_any, vol_rw, attach, want_rw, want_ro, att, rng.rand(p) < 0.1,
            (np.arange(u) % 4).astype(np.int32))


def _words(rows):
    return [w & ((1 << 64) - 1) for w in pack_words(torch.from_numpy(rows)).tolist()]


@pytest.mark.parametrize("seed", range(2))
def test_the_kernels_word_form_matches_reference(seed):
    """The kernel's ext_vol_fits in Python ints: (any & rw) | (rw_node &
    ro) == 0, and for each limit popcount(pod & mask) == 0 or
    popcount(node & mask) + popcount(pod & ~node & mask) <= limit, the
    fail bit failing everywhere, against JAX's predicates."""
    rng = np.random.RandomState(40 + seed)
    n, p = 24, 40
    vol_any, vol_rw, attach, want_rw, want_ro, att, fail, types = _full_universe_state(
        rng, n, p)
    maxes = ((VolType.EBS, 2), (VolType.GCE, 1), (VolType.AZURE, 3))
    masks = [sum(1 << u for u in range(64) if types[u] in (vt, VolType.ANY))
             for vt, _ in maxes]
    any_w, rw_w, att_w = _words(vol_any), _words(vol_rw), _words(attach)
    prw, pro, patt = _words(want_rw), _words(want_ro), _words(att)
    assert any(w >> 63 for w in any_w + patt)   # bit 63 in use
    jstate = dataclasses.make_dataclass("S", ["vol_any", "vol_rw", "attach_count",
                                              "attach_type"])(
        vol_any, vol_rw, attach, types)
    for i in range(p):
        jpod = dataclasses.make_dataclass("Q", ["vol_want_rw", "vol_want_ro", "att_onehot",
                                                "att_fail"])(
            want_rw[i], want_ro[i], att[i], fail[i])
        disk = np.asarray(jpreds.no_disk_conflict(jstate, jpod))
        limit = np.asarray(jpreds.max_attach_ok(jstate, jpod, maxes))
        for g in range(n):
            model_disk = ((any_w[g] & prw[i]) | (rw_w[g] & pro[i])) == 0
            model_att = not fail[i] and all(
                (patt[i] & m) == 0
                or bin(att_w[g] & m).count("1") + bin(patt[i] & ~att_w[g] & m).count("1")
                <= lim for m, (_vt, lim) in zip(masks, maxes))
            assert (model_disk, model_att) == (bool(disk[g]), bool(limit[g])), (i, g)


def _volume_cluster(seed, gated=False):
    """random_cluster's nodes and pods with volumes: a third of the nodes
    hold a bound pod with disks, the pods mount GCE, EBS and RBD disks
    read-write or read-only, claims bound to zonal PVs, claims not found
    and not bound; the reference's DEFAULT_POLICY limits are lowered so
    that they bite (EBS 2, GCE 2, Azure 1)."""
    rng = np.random.RandomState(seed)
    nodes, pods = random_cluster(rng, 48, P, gated=gated)
    for d in nodes:
        d["status"]["allocatable"]["pods"] = str(rng.randint(3, 8))
    pvs = [pv(f"pv{k}", {["gcePersistentDisk", "awsElasticBlockStore"][k % 2]: {
        "pdName" if k % 2 == 0 else "volumeID": f"pvd{k}"}}, zone=f"z{k % 3}")
        for k in range(6)]
    pvcs = [pvc(f"c{k}", f"pv{k}") for k in range(6)] + [pvc("loose")]
    choices = [lambda: gce(f"pd{rng.randint(3)}", ro=rng.rand() < 0.5),
               lambda: ebs(f"v{rng.randint(3)}"),
               lambda: rbd("img", [f"m{rng.randint(3)}"], ro=rng.rand() < 0.5),
               lambda: claim(f"c{rng.randint(6)}"), lambda: SECRETS[0]]
    for i, d in enumerate(pods):
        d["metadata"]["uid"] = f"uid-{i}"
        d["spec"]["volumes"] = [choices[rng.randint(5)]() for _ in range(rng.randint(1, 3))]
        if i in (5, 11):
            d["spec"]["volumes"].append(claim(["ghost", "loose"][i == 11]))
    bound = []
    for k in range(0, 48, 3):
        b = pod(f"b{k}", [choices[rng.randint(3)]()], node_name=f"n{k}")
        bound.append(b)
    return nodes, bound, pods, pvs, pvcs


J_VOL_POLICY = JPolicy(max_ebs_volumes=2, max_gce_pd_volumes=2, max_azure_disk_volumes=1)
VOL_POLICY = Policy(max_ebs_volumes=2, max_gce_pd_volumes=2, max_azure_disk_volumes=1)
_JAX_SOLVE = {}


def jax_solve(state, batch, rr, flags):
    fn = _JAX_SOLVE.get(flags)
    if fn is None:
        fn = _JAX_SOLVE[flags] = jax.jit(
            lambda s, b, r: jsolver.schedule_batch(s, b, r, J_VOL_POLICY, caps=JCAPS,
                                                   flags=flags))
    return fn(state, batch, np.uint32(rr))


def assert_same(got, want, msg=""):
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=f"{msg} {name}")
    for name in ("new_vol_any", "new_vol_rw", "new_attach"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=f"{msg} {name}")
    assert int(got.rr_end) == rr_from_numpy(want.rr_end), msg


def _gang_rows(batch, jbatch):
    """Groups of consecutive rows, among them one whose member fits nowhere
    (it reverts), one of two and one open at the last row."""
    for b in (batch, jbatch):
        b.gang_id[:] = 0
        b.gang_min[:] = 0
        for gid, (lo, hi) in enumerate(((0, 4), (4, 8), (10, 12), (26, 32)), 1):
            b.gang_id[lo:hi], b.gang_min[lo:hi] = gid, hi - lo
        b.valid[6] = True
        b.requests[6, 1] = 1e9   # 10^6 cpus: no node
        b.nonzero_requests[6, 0] = 1e9


@pytest.mark.parametrize("norm", [False, True], ids=["flag_off", "flag_on"])
@pytest.mark.parametrize("gang", [False, True], ids=["main", "gang"])
@pytest.mark.parametrize("seed", range(2))
def test_schedule_batch_with_volumes_matches_reference(seed, gang, norm):
    nodes, bound, pods, pvs, pvcs = _volume_cluster(seed, gated=norm)
    if norm:   # (the flag's gates alone beside the volumes)
        for d in pods:
            req = d["spec"]["containers"][0].get("resources", {}).get("requests", {})
            req.pop("alpha.kubernetes.io/nvidia-gpu", None)
            req.pop("storage.kubernetes.io/scratch", None)
    both = Both(nodes, bound, pvs, pvcs)
    batch, jbatch = both.encode(pods)
    if gang:
        _gang_rows(batch, jbatch)
    state, jstate = both.flush()
    names = ("vol", "attach") + (("gang",) if gang else ()) + (("tt", "na") if norm else ())
    dbatch = batch_from_numpy(batch, "cpu")
    assert batch_flags(state, dbatch) == pflags(names)
    got = schedule_batch(state, dbatch, 7, VOL_POLICY, pflags(names))
    want = jax_solve(jstate, jbatch, 7, jflags(names))
    assert_same(got, want, f"seed {seed}")
    assert (got.assignments >= 0).any() and (got.assignments[:P] < 0).any()
    if gang:
        assert int(got.gang_reverted) >= 1
    # the wrapper's post-scan sums equal the plain scan's carried ledgers
    g = check_supported(VOL_POLICY, pflags(names))
    ext = ext_inputs(state, dbatch, g)
    masked = masked_static_scores(state, dbatch, VOL_POLICY, g)
    args = (masked, dbatch.requests, dbatch.nonzero_requests, state.allocatable,
            state.requested, state.nonzero_requested, 7, 1.0, 1.0, ext)
    gi = GangInputs(gang_id=dbatch.gang_id, gang_min=dbatch.gang_min)
    plain = assign_scan_gang_ext_plain(*args, gi)
    for name, value in ext_ledgers(ext, plain.assignments, gi).items():
        assert torch.equal(value, getattr(plain, name)), name


def test_the_wrappers_pod_and_node_words():
    """The words the wrapper hands the kernel: MaxPDVolumeCount's table
    (type masks as unsigned 64-bit ints, the limits packed with their
    count), then a node's conflict atoms in use, in use read-write, attach
    atoms and host ports; a pod's ports, its volume words and its flags
    (EXT_FAIL, EXT_DISK, EXT_ATT, and EXT_SAME where its words and fail
    bit equal the previous pod's, the term cache's key), bit 63 kept."""
    from kubernetes_tpu_torch.ops.assign_scan import (EXT_ATT, EXT_DISK, EXT_FAIL,
                                                      EXT_SAME, ExtInputs, _ext_words)

    rng = np.random.RandomState(8)
    n, p = 12, 20
    vol_any, vol_rw, attach, want_rw, want_ro, att, fail, types = _full_universe_state(
        rng, n, p)
    want_rw[3:6], want_ro[3:6], att[3:6], fail[3:6] = want_rw[2], want_ro[2], att[2], fail[2]
    want_rw[9:11] = want_ro[9:11] = att[9:11] = 0.0
    fail[9:11] = False
    ports = (rng.rand(p, 4) < 0.3).astype(np.float32)
    counts = (rng.rand(n, 4) < 0.3).astype(np.float32)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)

    maxes = ((VolType.GCE, 2), (VolType.AZURE, 1))
    ext = ExtInputs(use_ports=True, port_onehot=t(ports), port_count=t(counts),
                    use_nodisk=True, vol_want_rw=t(want_rw), vol_want_ro=t(want_ro),
                    vol_any=t(vol_any), vol_rw=t(vol_rw), attach_maxes=maxes,
                    att_onehot=t(att), att_fail=t(fail, torch.bool), attach_count=t(attach),
                    attach_type=t(types, torch.int32))
    node_words, pod_words = _ext_words(ext)
    u64 = (1 << 64) - 1
    nodes = [[w & u64 for w in row] for row in node_words.tolist()]
    masks = [sum(1 << u for u in range(64) if types[u] in (vt, VolType.ANY))
             for vt, _ in maxes]
    assert nodes[0] == masks + [0, 2 | 1 << 16 | 2 << 48]
    assert nodes[1:] == [list(x) for x in zip(_words(vol_any), _words(vol_rw), _words(attach),
                                              _words(counts))]
    rows = [[w & u64 for w in row] for row in pod_words.tolist()]
    prev = None
    for i, (port, rw, ro, a) in enumerate(zip(_words(ports), _words(want_rw), _words(want_ro),
                                              _words(att))):
        flags = (EXT_FAIL * int(fail[i]) + EXT_DISK * int(bool(rw | ro))
                 + EXT_ATT * int(bool(a)))
        key = (rw, ro, a, flags)
        assert rows[i] == [port, 0, rw, ro, a, flags + EXT_SAME * int(key == prev)], i
        prev = key
    assert rows[4][5] & EXT_SAME and rows[10][5] == EXT_SAME
    assert any(w >> 63 for row in rows for w in row[2:5])


def test_the_ext_wrapper_refuses_past_64_atoms():
    nodes, bound, pods, pvs, pvcs = _volume_cluster(3)
    both = Both(nodes, bound, pvs, pvcs)
    batch, _ = both.encode(pods)
    state, _ = both.flush()
    dbatch = batch_from_numpy(batch, "cpu")
    g = policy_gates(DEFAULT_POLICY, pflags(("vol", "attach")))
    ext = ext_inputs(state, dbatch, g)
    masked = masked_static_scores(state, dbatch, DEFAULT_POLICY, g)
    args = (masked, dbatch.requests, dbatch.nonzero_requests, state.allocatable,
            state.requested, state.nonzero_requested, 0, 1.0, 1.0)
    assert_scan = assign_scan_ext(*args, ext)   # 32 atoms a universe: carried
    assert assert_scan.new_vol_any is not None and assert_scan.new_attach is not None
    for pod_rows, counts in (("vol_want_rw", "vol_any"), ("att_onehot", "attach_count")):
        wide = dataclasses.replace(ext, **{
            pod_rows: torch.zeros((P, EXT_MAX_UP + 1)),
            counts: torch.zeros((N_NODES, EXT_MAX_UP + 1))})
        if counts == "vol_any":
            wide.vol_want_ro = wide.vol_rw = None
            wide = dataclasses.replace(wide, vol_want_ro=torch.zeros((P, EXT_MAX_UP + 1)),
                                       vol_rw=torch.zeros((N_NODES, EXT_MAX_UP + 1)))
        else:
            wide = dataclasses.replace(wide, attach_type=torch.zeros(
                (EXT_MAX_UP + 1,), dtype=torch.int32))
        with pytest.raises(ValueError, match="at most 64"):
            assign_scan_ext(*args, wide)


@pytest.mark.parametrize("other", ["spread", "ipa"])
@pytest.mark.parametrize("gate", ["vol", "attach"])
def test_volumes_with_spread_or_ipa_raise_naming_them(gate, other):
    with pytest.raises(NotImplementedError, match="^volumes .* with SelectorSpread or "
                                                  "inter-pod affinity"):
        check_supported(DEFAULT_POLICY, pflags((gate, other)))
    with pytest.raises(NotImplementedError, match="^host ports / GPU or storage requests "
                                                  "and volumes"):
        check_supported(DEFAULT_POLICY, pflags((gate, other, "gpu")))
    # the gate alone, and with the gang carry, is carried
    assert check_supported(DEFAULT_POLICY, pflags((gate, "gang"))).use_ext


# ---- (d) Scheduler against the reference's driver flow ----

class _JaxChain:
    """The reference package's StateDB, encode cache, schedule_batch and
    commit, as its driver runs them."""

    def __init__(self, nodes, bound, jctx):
        self.db = JStateDB(JCAPS, volume_ctx=jctx)
        for d in nodes:
            self.db.upsert_node(jobj.Node.from_dict(d))
        for d in bound:
            self.db.add_pod(jobj.Pod.from_dict(d))
        self.cache = JEncodeCache(JCAPS, self.db.table, volume_ctx=jctx)
        self.rr = 0

    def schedule(self, pod_dicts, names):
        pods = [jobj.Pod.from_dict(d) for d in pod_dicts]
        fblob, iblob = j_pack_batch(j_empty_batch(JCAPS), JCAPS)
        for i, p in enumerate(pods):
            self.cache.encode_packed_into(fblob, iblob, i, p)
        batch = j_unpack_batch(fblob, iblob, JCAPS)
        flags = jsolver.batch_flags(batch, len(pods), self.db.table)
        assert flags == jflags(names), flags
        res = jax_solve(self.db.flush(), batch, self.rr, flags)
        rows = np.asarray(res.assignments)
        placed = [self.db.table.name_of[r] if r >= 0 else None for r in rows[:len(pods)]]
        self.db.commit_batch(res, fblob, [(p, n, i) for i, (p, n)
                                          in enumerate(zip(pods, placed)) if n])
        self.rr = rr_from_numpy(res.rr_end)
        return {p.key: n for p, n in zip(pods, placed)}, res


def test_scheduler_chains_volume_batches_like_the_reference():
    nodes, bound, pods0, pvs, pvcs = _volume_cluster(9)
    _, _, pods1, _, _ = _volume_cluster(10)
    for i, d in enumerate(pods1):   # the second batch sees the first's disks
        d["metadata"]["name"] = d["metadata"]["uid"] = f"t{i}"
    sched = Scheduler(CAPS, VOL_POLICY, device="cpu")
    sched.add_nodes([obj.Node.from_dict(d) for d in nodes])
    for d in pvs:
        sched.add_pv(obj.PersistentVolume.from_dict(d))
    for d in pvcs:
        sched.add_pvc(obj.PersistentVolumeClaim.from_dict(d))
    for d in bound:
        assert sched.add_pod(obj.Pod.from_dict(d))
    ref = _JaxChain(nodes, bound, contexts(pvs, pvcs)[1])
    for k, chunk in enumerate((pods0, pods1)):
        got = sched.schedule([obj.Pod.from_dict(d) for d in chunk])
        want, res = ref.schedule(chunk, ("vol", "attach"))
        assert got == want, f"batch {k}"
        assert_same(sched.last_result, res, f"batch {k}")
        for name in LEDGERS + ("requested",):
            np.testing.assert_array_equal(getattr(sched.statedb.host, name),
                                          np.asarray(getattr(ref.db.host, name)),
                                          err_msg=f"batch {k} {name}")
            np.testing.assert_array_equal(getattr(sched.statedb.flush(), name).numpy(),
                                          getattr(sched.statedb.host, name))
    assert None in got.values() and any(got.values())
    # removing a bound disk pod gives its disk back on both sides
    sched.remove_pod("default/b0")
    ref.db.remove_pod("default/b0")
    for name in LEDGERS:
        np.testing.assert_array_equal(getattr(sched.statedb.host, name),
                                      np.asarray(getattr(ref.db.host, name)))


def test_scheduler_matches_the_serial_reference():
    """tests/serial_reference.py's scheduleOne over the same volume traffic
    (disks, attach limits and VolumeZone; no failure-domain spreading in
    the policy, which the serial reference does not weigh)."""
    rng = np.random.RandomState(3)
    nodes = [node(f"n{i}", {ZONE: ["z0", "z1"][i % 2]} if i % 3 else {}, cpu="2",
                  pods="6") for i in range(10)]
    pvs = [pv(f"pv{k}", {"gcePersistentDisk": {"pdName": f"pvd{k}"}}, zone=f"z{k % 2}")
           for k in range(4)]
    pvcs = [pvc(f"c{k}", f"pv{k}") for k in range(4)]
    choices = [lambda: gce(f"pd{rng.randint(3)}", ro=rng.rand() < 0.5),
               lambda: ebs(f"v{rng.randint(3)}"),
               lambda: claim(f"c{rng.randint(5)}")]   # c4: not found
    bound = [pod(f"a{i}", [choices[rng.randint(3)]()], node_name=f"n{rng.randint(10)}")
             for i in range(6)]
    pending = [pod(f"p{i}", [choices[rng.randint(3)]() for _ in range(rng.randint(1, 3))],
                   cpu="500m") for i in range(24)]
    policy = Policy(predicates=BASE + ("NoDiskConflict", "MaxEBSVolumeCount",
                                       "MaxGCEPDVolumeCount", "NoVolumeZoneConflict"),
                    priorities=(("LeastRequestedPriority", 1),
                                ("BalancedResourceAllocation", 1)),
                    max_ebs_volumes=2, max_gce_pd_volumes=2)
    sched = Scheduler(CAPS, policy, device="cpu")
    sched.add_nodes([obj.Node.from_dict(d) for d in nodes])
    for d in pvs:
        sched.add_pv(obj.PersistentVolume.from_dict(d))
    for d in pvcs:
        sched.add_pvc(obj.PersistentVolumeClaim.from_dict(d))
    for d in bound:
        sched.add_pod(obj.Pod.from_dict(d))
    got = sched.schedule([obj.Pod.from_dict(d) for d in pending])
    serial = SerialScheduler([jobj.Node.from_dict(d) for d in nodes],
                             [jobj.Pod.from_dict(d) for d in bound], with_volumes=True,
                             volume_ctx=contexts(pvs, pvcs)[1],
                             attach_limits={"ebs": 2, "gce": 2})
    want = serial.schedule([jobj.Pod.from_dict(d) for d in pending])
    assert [got[f"default/p{i}"] for i in range(len(pending))] == want
    assert None in want and any(want)


def test_kube_max_pd_vols_sets_every_attach_limit(monkeypatch):
    monkeypatch.setenv("KUBE_MAX_PD_VOLS", "1")
    sched = Scheduler(CAPS, device="cpu")
    assert (sched.policy.max_ebs_volumes, sched.policy.max_gce_pd_volumes,
            sched.policy.max_azure_disk_volumes) == (1, 1, 1)
    assert sched.policy == dataclasses.replace(DEFAULT_POLICY, max_ebs_volumes=1,
                                               max_gce_pd_volumes=1, max_azure_disk_volumes=1)
    jpolicy = jsolver.DEFAULT_POLICY.with_env_overrides()
    assert sched.policy.attach_maxes() == jpolicy.attach_maxes()
    sched.add_nodes([obj.Node.from_dict(node("n0")), obj.Node.from_dict(node("n1"))])
    placed = sched.schedule([obj.Pod.from_dict(pod("p", [gce("a")])),
                             obj.Pod.from_dict(pod("q", [gce("b")])),
                             obj.Pod.from_dict(pod("r", [gce("c")]))])
    # one GCE PD a node: the third pod finds none
    assert sorted(filter(None, placed.values())) == ["n0", "n1"]
    assert placed["default/r"] is None
    for raw in ("0", "-3", "x", ""):
        monkeypatch.setenv("KUBE_MAX_PD_VOLS", raw)
        assert DEFAULT_POLICY.with_env_overrides() == DEFAULT_POLICY


def test_volumes_traffic_at_a_small_size():
    """The volumes cell's cluster and mix at 150 nodes and 400 pods, with
    the VolumeNode gate and two PVs with node affinity: the pods with a
    claim not found or not bound left out and every other placed, no
    dataset disk read-only beside its read-write holder, claims in their
    PV's zone and on the nodes their affinity names."""
    n_nodes, n_pods = 150, 400
    caps = volumes_caps(n_nodes, n_pods)
    sched = volumes_cluster(n_nodes, caps, device="cpu", node_affinity_pvs=2)
    pods = volumes_pods(n_pods)
    placed = sched.schedule(pods)
    assert sorted(k for k, v in placed.items() if v is None) == \
        ["default/pod-10", "default/pod-6"]
    table = sched.statedb.table
    assert len(table.vol_atoms) == VOLUMES_DATA_DISKS
    for i, p in enumerate(pods):
        node_i = placed[p.key] and int(placed[p.key].split("-")[1])
        if i % 4 == 1:
            held = node_i % 10 == 0 and (node_i // 10) % 16 == (i // 4) % 16
            assert not held, p.key
        if i % 8 == 3:
            k = (i // 8) % 24
            assert node_i % 3 == k % 3, p.key
            if k < 2:
                assert node_i in range(k % 3, 30, 9), p.key
    assert sched.last_result.new_vol_any is not None
    assert sched.last_result.new_attach is not None
