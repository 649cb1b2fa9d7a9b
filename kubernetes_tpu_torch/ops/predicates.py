"""Scheduling predicates over a batch: bool[P, N] masks.

Each function re-expresses one reference FitPredicate for a whole batch
of pods against all nodes; where the reference package vmaps a per-pod
function, the pod axis is written out here and pod-side tensors broadcast
against node-side ones. The string-matching predicates are one-hot
products: selector terms and taints are interned into small universes, so
matching is `onehot[P, U] @ member[N, U].T`.

The predicates the fused static mask covers (selector, taints, conditions,
host name) are kept here as separate functions too: the solver calls the
kernel, the tests compose these.
"""

from __future__ import annotations

import torch

from kubernetes_tpu_torch.state.cluster_state import ClusterState
from kubernetes_tpu_torch.state.layout import (
    TOPO_REGION,
    TOPO_ZONE,
    Condition,
    Effect,
    Resource,
    TolOp,
)
from kubernetes_tpu_torch.state.pod_batch import PodBatch


def _requests_all_zero(r: torch.Tensor) -> torch.Tensor:
    """bool[P]: a pod requesting nothing only pays the pod-count check
    (predicates.go:576-578)."""
    return ((r[:, Resource.CPU] == 0) & (r[:, Resource.MEMORY] == 0)
            & (r[:, Resource.GPU] == 0) & (r[:, Resource.SCRATCH] == 0)
            & (r[:, Resource.OVERLAY] == 0))


def _fits(alloc, r, req, row: int) -> torch.Tensor:
    """bool[P, N]: alloc[n, row] >= r[p, row] + req[n, row]."""
    return alloc[None, :, row] >= r[:, None, row] + req[None, :, row]


def _storage_fit(req, alloc, r) -> torch.Tensor:
    """Storage half of PodFitsResources: without overlay allocatable,
    overlay requests fall through to scratch space (predicates.go:590-605)."""
    no_overlay = alloc[:, Resource.OVERLAY] == 0
    scratch_req_no_overlay = r[:, Resource.SCRATCH] + r[:, Resource.OVERLAY]
    node_scratch_no_overlay = req[:, Resource.OVERLAY] + req[:, Resource.SCRATCH]
    scratch_ok_no_overlay = (
        alloc[None, :, Resource.SCRATCH]
        >= scratch_req_no_overlay[:, None] + node_scratch_no_overlay[None, :])
    scratch_ok_overlay = (
        _fits(alloc, r, req, Resource.SCRATCH)
        & _fits(alloc, r, req, Resource.OVERLAY))
    return torch.where(no_overlay[None, :], scratch_ok_no_overlay,
                       scratch_ok_overlay)


def fits_resources_static(state: ClusterState, requests: torch.Tensor,
                          dyn_gpu: bool, dyn_storage: bool) -> torch.Tensor:
    """The assignment-independent remainder of PodFitsResources: resource
    columns no pod of the batch requests never change through the scan, so
    their compares hold against the batch-start ledger."""
    req = state.requested
    alloc = state.allocatable
    ok = torch.ones((requests.shape[0], alloc.shape[0]), dtype=torch.bool,
                    device=alloc.device)
    if not dyn_gpu:
        ok &= _fits(alloc, requests, req, Resource.GPU)
    if not dyn_storage:
        ok &= _storage_fit(req, alloc, requests)
    return _requests_all_zero(requests)[:, None] | ok


def fits_resources_dyn(allocatable: torch.Tensor, requests: torch.Tensor,
                       requested: torch.Tensor, dyn_gpu: bool = True,
                       dyn_storage: bool = True) -> torch.Tensor:
    """The in-scan half of PodFitsResources against the running ledger
    `requested`: the pod count, cpu and memory always; gpu/storage only when
    the batch requests them (`dyn_*`)."""
    req = requested
    alloc = allocatable
    pods_ok = req[:, Resource.PODS] + 1.0 <= alloc[:, Resource.PODS]
    r = requests
    basic = _fits(alloc, r, req, Resource.CPU) & _fits(alloc, r, req, Resource.MEMORY)
    if dyn_gpu:
        basic &= _fits(alloc, r, req, Resource.GPU)
    if dyn_storage:
        basic &= _storage_fit(req, alloc, r)
    return pods_ok[None, :] & (_requests_all_zero(r)[:, None] | basic)


def fits_host_ports(port_count: torch.Tensor,
                    port_onehot: torch.Tensor) -> torch.Tensor:
    """PodFitsHostPorts (predicates.go:859): bool[P, N], no host port the
    pod wants is in use on the node, port_count f32[N, UP] @ port_onehot
    f32[P, UP] == 0 (integer counts: the product is exact)."""
    return torch.matmul(port_onehot, port_count.T) == 0


def fits_host(state: ClusterState, batch: PodBatch) -> torch.Tensor:
    """PodFitsHost (predicates.go:698): spec.nodeName pins the node."""
    unset = batch.node_name_lo == 0
    match = ((state.name_lo[None, :] == batch.node_name_lo[:, None])
             & (state.name_hi[None, :] == batch.node_name_hi[:, None]))
    return unset[:, None] | match


def _rows_where(rows: torch.Tensor, n_nodes: int, fn) -> torch.Tensor:
    """bool[P, N], True except on the pod rows selected by `rows`, which
    take `fn(index)`. For predicates that hold everywhere for pods without
    the feature, so the (P x ... x N) product runs only for pods that have
    it."""
    out = torch.ones((rows.shape[0], n_nodes), dtype=torch.bool,
                     device=rows.device)
    idx = torch.nonzero(rows).flatten()
    if idx.numel():
        out[idx] = fn(idx)
    return out


def node_affinity_ok(state: ClusterState, batch: PodBatch) -> torch.Tensor:
    """The required-node-affinity half of PodMatchNodeSelector: OR over
    terms, each an AND over interned requirements (count equality); dead
    terms never hold; pods without a required NodeSelector match all."""
    def rows(idx):
        term_sat = torch.matmul(batch.naff_onehot[idx], state.req_member.T)
        term_ok = ((term_sat >= batch.naff_count[idx, :, None])
                   & batch.naff_ok[idx, :, None])
        return term_ok.any(dim=1)
    return _rows_where(batch.naff_has, state.valid.shape[0], rows)


def match_node_selector(state: ClusterState, batch: PodBatch) -> torch.Tensor:
    """PodMatchNodeSelector (predicates.go:686): the map-form nodeSelector
    AND any required node affinity."""
    satisfied = torch.matmul(batch.sel_onehot, state.sel_member.T)
    return (satisfied >= batch.sel_count[:, None]) & node_affinity_ok(state, batch)


def tolerated_universe(state: ClusterState, batch: PodBatch) -> torch.Tensor:
    """bool[P, UT]: universe taint u is tolerated by some toleration of the
    pod (an empty key matches every key; Equal compares values; Exists
    ignores them; an empty effect matches every effect)."""
    out = torch.zeros((batch.tol_op.shape[0], state.taint_u_key.shape[0]),
                      dtype=torch.bool, device=state.taint_u_key.device)
    for j in range(batch.tol_op.shape[1]):
        op = batch.tol_op[:, j, None]
        used = op != TolOp.NONE
        eff = batch.tol_effect[:, j, None]
        eff_ok = (eff == Effect.NONE) | (eff == state.taint_u_effect[None, :])
        key = batch.tol_key[:, j, None]
        key_ok = (key == 0) | (key == state.taint_u_key[None, :])
        value_ok = (op == TolOp.EXISTS) | (
            (batch.tol_val_lo[:, j, None] == state.taint_u_val_lo[None, :])
            & (batch.tol_val_hi[:, j, None] == state.taint_u_val_hi[None, :]))
        out |= used & eff_ok & key_ok & value_ok
    return out


def untolerated(state: ClusterState, batch: PodBatch) -> torch.Tensor:
    """f32[P, UT]: 1 where the universe taint is not tolerated."""
    return 1.0 - tolerated_universe(state, batch).to(torch.float32)


def tolerates_node_taints(state: ClusterState, batch: PodBatch) -> torch.Tensor:
    """PodToleratesNodeTaints (predicates.go:1241): every NoSchedule /
    NoExecute taint must be tolerated."""
    violations = torch.matmul(untolerated(state, batch), state.taint_hard_member.T)
    return violations == 0.0


def count_untolerated_prefer_taints(state: ClusterState,
                                    batch: PodBatch) -> torch.Tensor:
    """f32[P, N]: untolerated PreferNoSchedule taints per node, the map half
    of the TaintToleration priority (priorities/taint_toleration.go:29).
    The plain mirror of JAX's matmul: nothing on the scheduling path calls
    it; the solver, the plain scan and the kernels count from the 64-bit
    words (`ops.assign_scan.norm_counts`), which the tests hold against
    it."""
    return torch.matmul(untolerated(state, batch), state.taint_prefer_member.T)


def _bits_clear(state: ClusterState, bits: int) -> torch.Tensor:
    return ((state.conditions & bits) == 0)[None, :]


def node_schedulable(state: ClusterState, batch: PodBatch) -> torch.Tensor:
    """spec.unschedulable exclusion, applied regardless of policy."""
    return _bits_clear(state, Condition.UNSCHEDULABLE)


def check_node_condition(state: ClusterState, batch: PodBatch) -> torch.Tensor:
    """CheckNodeCondition (predicates.go:1306)."""
    return _bits_clear(state, Condition.NOT_READY | Condition.NETWORK_UNAVAILABLE
                       | Condition.OUT_OF_DISK)


def check_memory_pressure(state: ClusterState, batch: PodBatch) -> torch.Tensor:
    """CheckNodeMemoryPressure (predicates.go:1274): rejects only BestEffort
    pods."""
    pressure = (state.conditions & Condition.MEMORY_PRESSURE) != 0
    return ~(pressure[None, :] & batch.best_effort[:, None])


def check_disk_pressure(state: ClusterState, batch: PodBatch) -> torch.Tensor:
    """CheckNodeDiskPressure (predicates.go:1296)."""
    return _bits_clear(state, Condition.DISK_PRESSURE)


def volume_zone(state: ClusterState, batch: PodBatch) -> torch.Tensor:
    """NoVolumeZoneConflict (predicates.go:395): nodes with zone/region
    labels must match every bound PV's zone/region terms; unlabeled nodes
    pass. A resolution failure fails every node when any valid zoned node
    exists."""
    unconstrained = ((state.topology[:, TOPO_ZONE] < 0)
                     & (state.topology[:, TOPO_REGION] < 0))
    any_zoned = (state.valid & ~unconstrained).any()

    def rows(idx):
        satisfied = torch.matmul(batch.vz_onehot[idx], state.sel_member.T)
        fail = batch.vz_fail[idx, None]
        ok = unconstrained[None, :] | ((satisfied >= batch.vz_count[idx, None])
                                       & ~fail)
        return ok & ~(fail & any_zoned)
    return _rows_where((batch.vz_count > 0) | batch.vz_fail,
                       state.valid.shape[0], rows)


def volume_node(state: ClusterState, batch: PodBatch) -> torch.Tensor:
    """NoVolumeNodeConflict (predicates.go:1345): every bound PV's
    node-affinity selector must match the node."""
    def rows(idx):
        satisfied = torch.matmul(batch.vs_onehot[idx], state.volsel_member.T)
        return (satisfied >= batch.vs_count[idx, None]) & ~batch.vs_fail[idx, None]
    return _rows_where((batch.vs_count > 0) | batch.vs_fail,
                       state.valid.shape[0], rows)
