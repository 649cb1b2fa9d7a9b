"""kubernetes_tpu_torch state plane: the encoders against the reference
package's encoders on every field the solver reads, the host->device
conversion, the StateDB mirror, and the encoder's refusal of pods outside
the main path.

Shared by the other tests/test_torch_*.py files: the random cluster
generator (`random_cluster`), which builds v1 dicts from a numpy seed so
both packages parse the same objects."""

import json

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
from kubernetes_tpu.state import Capacities as JCaps  # noqa: E402
from kubernetes_tpu.state import encode_cluster as j_encode_cluster  # noqa: E402

from kubernetes_tpu_torch.api.objects import Node, Pod  # noqa: E402
from kubernetes_tpu_torch.state import Capacities, encode_cluster  # noqa: E402
from kubernetes_tpu_torch.state.cluster_state import (  # noqa: E402
    AVOID_PODS_ANNOTATION,
    STATE_FIELDS,
)
from kubernetes_tpu_torch.state.convert import (  # noqa: E402
    batch_from_numpy,
    host_tensor,
    rr_from_numpy,
    state_from_numpy,
)
from kubernetes_tpu_torch.state.pod_batch import (  # noqa: E402
    BATCH_FIELDS,
    encode_pods,
)
from kubernetes_tpu_torch.state.statedb import StateDB  # noqa: E402

N_NODES, BATCH = 128, 16
CAPS = Capacities(num_nodes=N_NODES, batch_pods=BATCH)
JCAPS = JCaps(num_nodes=N_NODES, batch_pods=BATCH)

ZONE = "failure-domain.beta.kubernetes.io/zone"
REGION = "failure-domain.beta.kubernetes.io/region"


def _avoid(uid):
    return json.dumps({"preferAvoidPods": [{"podSignature": {"podController": {
        "kind": "ReplicaSet", "uid": uid}}}]})


def random_cluster(rng, n_nodes, n_pods, gated=False):
    """(node dicts, pod dicts) in the main path's feature set: labels,
    zones, hard taints, every condition bit, unschedulable nodes,
    preferAvoidPods, nodeSelector, tolerations, nodeName pins, BestEffort
    pods, required node affinity and controller owner references. Tight
    capacities keep in-batch claims flipping feasibility. `gated` adds the
    features the solver gates per batch (PreferNoSchedule taints, gpu and
    scratch requests, preferred node affinity)."""
    zones = ["z0", "z1", "z2"]
    nodes = []
    for i in range(n_nodes):
        z = zones[rng.randint(3)]
        labels = {"kubernetes.io/hostname": f"n{i}", "zone": z}
        if rng.rand() < 0.8:
            labels[ZONE] = z
            labels[REGION] = "r1"
        if rng.rand() < 0.3:
            labels["disk"] = "ssd"
        taints = []
        if rng.rand() < 0.2:
            taints.append({"key": "dedicated",
                           "value": ["infra", "gpu"][rng.randint(2)],
                           "effect": ["NoSchedule", "NoExecute"][rng.randint(2)]})
        if gated and rng.rand() < 0.3:
            taints.append({"key": "soft", "value": "x",
                           "effect": "PreferNoSchedule"})
        conds = [{"type": "Ready", "status": "True"}]
        u = rng.rand()
        if u < 0.05:
            conds = [{"type": "Ready", "status": "False"}]
        elif u < 0.12:
            conds.append({"type": "MemoryPressure", "status": "True"})
        elif u < 0.16:
            conds.append({"type": "DiskPressure", "status": "True"})
        elif u < 0.19:
            conds.append({"type": "NetworkUnavailable", "status": "True"})
        elif u < 0.21:
            conds.append({"type": "OutOfDisk", "status": "True"})
        spec = {"taints": taints}
        if rng.rand() < 0.04:
            spec["unschedulable"] = True
        meta = {"name": f"n{i}", "labels": labels}
        if rng.rand() < 0.25:
            meta["annotations"] = {AVOID_PODS_ANNOTATION: _avoid(f"rs-{rng.randint(2)}")}
        alloc = {"cpu": str(rng.randint(1, 5)), "memory": f"{rng.randint(2, 9)}Gi",
                 "pods": str(rng.randint(1, 5))}
        if rng.rand() < 0.3:
            alloc["storage.kubernetes.io/scratch"] = f"{rng.randint(2, 20)}Gi"
        nodes.append({"metadata": meta, "spec": spec,
                      "status": {"allocatable": alloc, "conditions": conds}})
    pods = []
    for i in range(n_pods):
        req = {}
        if rng.rand() < 0.8:
            req["cpu"] = f"{[250, 500, 1000, 1500][rng.randint(4)]}m"
        if rng.rand() < 0.8:
            req["memory"] = f"{[256, 512, 1024, 2048][rng.randint(4)]}Mi"
        if gated and rng.rand() < 0.2:
            req["alpha.kubernetes.io/nvidia-gpu"] = "1"
        if gated and rng.rand() < 0.2:
            req["storage.kubernetes.io/scratch"] = "1Gi"
        container = {"name": "c", "image": "k8s.gcr.io/pause:3.0"}
        if req:
            container["resources"] = {"requests": req}
        spec = {"containers": [container]}
        if rng.rand() < 0.25:
            spec["nodeSelector"] = {"disk": "ssd"}
        u = rng.rand()
        if u < 0.15:
            spec["tolerations"] = [{"key": "dedicated", "operator": "Exists"}]
        elif u < 0.25:
            spec["tolerations"] = [{"key": "dedicated", "operator": "Equal",
                                    "value": "infra", "effect": "NoSchedule"}]
        elif u < 0.3:
            spec["tolerations"] = [{"operator": "Exists"}]
        if rng.rand() < 0.1:
            spec["nodeName"] = f"n{rng.randint(n_nodes + 2)}"
        affinity = {}
        u = rng.rand()
        if u < 0.25:
            terms = [[{"key": "zone", "operator": "In", "values": ["z0", "z1"]}],
                     [{"key": "zone", "operator": "NotIn", "values": ["z2"]},
                      {"key": "disk", "operator": "Exists"}],
                     [{"key": "disk", "operator": "DoesNotExist"}],
                     []][rng.randint(4)]
            selector_terms = [{"matchExpressions": terms}]
            if rng.rand() < 0.3:
                selector_terms.append({"matchExpressions": [
                    {"key": "zone", "operator": "In", "values": ["z2"]}]})
            affinity["nodeAffinity"] = {
                "requiredDuringSchedulingIgnoredDuringExecution": {
                    "nodeSelectorTerms": selector_terms}}
        if gated and rng.rand() < 0.3:
            affinity.setdefault("nodeAffinity", {})[
                "preferredDuringSchedulingIgnoredDuringExecution"] = [{
                    "weight": 5, "preference": {"matchExpressions": [
                        {"key": "zone", "operator": "In", "values": ["z1"]}]}}]
        if affinity:
            spec["affinity"] = affinity
        meta = {"name": f"p{i}"}
        if rng.rand() < 0.3:
            meta["ownerReferences"] = [{"kind": "ReplicaSet",
                                        "uid": f"rs-{rng.randint(2)}",
                                        "controller": True}]
        pods.append({"metadata": meta, "spec": spec})
    return nodes, pods


def encode_both(node_dicts, pod_dicts, caps=CAPS, jcaps=JCAPS):
    """(port host state, port host batch, port table), (reference state,
    batch, table) for the same dicts."""
    mine = encode_cluster([Node.from_dict(d) for d in node_dicts],
                          [Pod.from_dict(d) for d in pod_dicts], caps)
    ref = j_encode_cluster([JNode.from_dict(d) for d in node_dicts],
                           [JPod.from_dict(d) for d in pod_dicts], jcaps)
    return mine, ref


# fields the main path never reads (ImageLocality is not in the default
# policy), left unencoded by this package
UNREAD = {"img_onehot", "img_size"}


@pytest.mark.parametrize("seed", range(4))
def test_encoder_matches_reference(seed):
    rng = np.random.RandomState(seed)
    nodes, pods = random_cluster(rng, 40, BATCH, gated=seed % 2 == 1)
    (state, batch, table), (jstate, jbatch, jtable) = encode_both(nodes, pods)
    for name in STATE_FIELDS:
        if name not in UNREAD:
            mine, ref = getattr(state, name), np.asarray(getattr(jstate, name))
            assert mine.dtype == ref.dtype, name
            np.testing.assert_array_equal(mine, ref, err_msg=name)
    for name in BATCH_FIELDS:
        if name not in UNREAD:
            mine, ref = getattr(batch, name), np.asarray(getattr(jbatch, name))
            assert mine.dtype == ref.dtype, name
            np.testing.assert_array_equal(mine, ref, err_msg=name)
    assert table.row_of == jtable.row_of
    assert table.sel_terms == jtable.sel_terms
    assert table.reqs == jtable.reqs


def test_conversion_reinterprets_hashes_and_reduces_rr():
    rng = np.random.RandomState(7)
    nodes, pods = random_cluster(rng, 20, 8)
    _, (jstate, jbatch, _) = encode_both(nodes, pods)
    state = state_from_numpy(jstate, "cpu")
    batch = batch_from_numpy(jbatch, "cpu")
    assert state.name_lo.dtype == torch.int32
    np.testing.assert_array_equal(state.name_lo.numpy().view(np.uint32),
                                  np.asarray(jstate.name_lo))
    assert state.conditions.dtype == torch.int32
    assert batch.valid.dtype == torch.bool
    assert batch.tol_key.dtype == torch.int32
    assert batch.requests.dtype == torch.float32
    # a copy, never a view of the host array
    jstate.requested[0, 0] += 1.0
    assert state.requested[0, 0].item() != jstate.requested[0, 0]
    assert rr_from_numpy(np.uint32(2**32 - 1)) == 2**32 - 1
    assert rr_from_numpy(np.int64(2**32 + 5)) == 5


def test_statedb_flush_copies_only_dirty_rows():
    rng = np.random.RandomState(3)
    nodes, pods = random_cluster(rng, 20, 8)
    db = StateDB(CAPS, device="cpu")
    for d in nodes[:10]:
        db.upsert_node(Node.from_dict(d))
    first = db.flush()
    assert db.flush_rows_total == N_NODES
    for d in nodes[10:12]:
        db.upsert_node(Node.from_dict(d))
    # a pod interning a new selector term refills membership rows
    encode_pods([Pod.from_dict({"metadata": {"name": "s"}, "spec": {
        "nodeSelector": {"disk": "ssd"}, "containers": [{"name": "c"}]}})],
        CAPS, db.table)
    dev = db.flush()
    assert dev is first
    for name in STATE_FIELDS:
        assert torch.equal(getattr(dev, name),
                           host_tensor(getattr(db.host, name))), name
    ssd = [db.table.row_of[d["metadata"]["name"]] for d in nodes[:12]
           if d["metadata"]["labels"].get("disk") == "ssd"]
    tid = db.table.sel_terms[("disk", "ssd")]
    assert sorted(np.flatnonzero(dev.sel_member[:, tid].numpy())) == sorted(ssd)
    assert db.flush_rows_total < 2 * N_NODES


@pytest.mark.parametrize("feature, spec, meta", [
    ("volumes", {"volumes": [{"name": "d", "gcePersistentDisk": {
        "pdName": "disk-0"}}]}, {}),
    ("host ports", {"containers": [{"name": "c", "ports": [
        {"containerPort": 80, "hostPort": 8080}]}]}, {}),
    ("pod priority", {"priority": 100}, {}),
])
def test_encoder_rejects_pods_outside_the_main_path(feature, spec, meta):
    pod = Pod.from_dict({"metadata": {"name": "x", **meta},
                         "spec": {"containers": [{"name": "c"}], **spec}})
    if feature == "pod priority":
        # encoded since the preemption pass, into the priority column
        batch = encode_pods([pod], CAPS, encode_cluster([], [], CAPS)[2])
        assert batch.priority[0] == 100
        return
    if feature == "host ports":
        # encoded since the EXT variant, into the port row
        table = encode_cluster([], [], CAPS)[2]
        batch = encode_pods([pod], CAPS, table)
        assert table.ports == {8080: 0}
        assert batch.port_onehot[0].tolist() == [1.0] + [0.0] * (CAPS.port_universe - 1)
        return
    with pytest.raises(NotImplementedError, match=feature):
        encode_pods([pod], CAPS, encode_cluster([], [], CAPS)[2])


def test_encoder_accepts_fields_the_main_path_never_reads():
    pod = Pod.from_dict({"metadata": {"name": "x", "labels": {"app": "a"}},
                         "spec": {"containers": [{"name": "c",
                                                  "image": "nginx:1"}]}})
    batch = encode_pods([pod], CAPS, encode_cluster([], [], CAPS)[2])
    assert batch.valid[0] and not batch.img_onehot.any()
