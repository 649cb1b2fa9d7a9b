"""Priority (scoring) functions over a batch: f32[P, N] scores.

The reference computes integer scores with int64 division; these use f32
with explicit floor/trunc, nudged by FLOOR_EPS, in the same order of
operations as the reference package, so scores agree bit for bit on
integer-valued inputs. The CUDA assignment scan (ops/assign_scan.py)
repeats this arithmetic with round-to-nearest intrinsics.
"""

from __future__ import annotations

import torch

from kubernetes_tpu_torch.state.cluster_state import ClusterState
from kubernetes_tpu_torch.state.layout import MAX_PRIORITY, Resource
from kubernetes_tpu_torch.state.pod_batch import PodBatch

# When the true quotient is an exact integer, f32 rounding can land epsilon
# below it and floor() would lose a whole point; FLOOR_EPS (far below the
# quotient granularity 10/capacity for any realistic node) restores parity.
FLOOR_EPS = 1e-6


def _unused_score(requested: torch.Tensor, capacity: torch.Tensor) -> torch.Tensor:
    """calculateUnusedScore (least_requested.go:40): ((cap-req)*10)/cap with
    int64 truncation; 0 when cap == 0 or req > cap."""
    safe_cap = torch.where(capacity == 0, 1.0, capacity)
    score = torch.floor((capacity - requested) * MAX_PRIORITY / safe_cap + FLOOR_EPS)
    return torch.where((capacity == 0) | (requested > capacity), 0.0, score)


def least_requested(allocatable: torch.Tensor, nonzero_requests: torch.Tensor,
                    nonzero_ledger: torch.Tensor) -> torch.Tensor:
    """LeastRequestedPriorityMap over the non-zero scoring requests:
    f32[P, N] for pods `nonzero_requests[P, 2]` against the ledger."""
    total_cpu = nonzero_ledger[None, :, 0] + nonzero_requests[:, None, 0]
    total_mem = nonzero_ledger[None, :, 1] + nonzero_requests[:, None, 1]
    cpu_score = _unused_score(total_cpu, allocatable[None, :, Resource.CPU])
    mem_score = _unused_score(total_mem, allocatable[None, :, Resource.MEMORY])
    return torch.floor((cpu_score + mem_score) / 2.0 + FLOOR_EPS)


def balanced_allocation(allocatable: torch.Tensor, nonzero_requests: torch.Tensor,
                        nonzero_ledger: torch.Tensor) -> torch.Tensor:
    """BalancedResourceAllocation: favor nodes whose cpu and memory
    utilization fractions are closest; 0 if either fraction reaches 1."""
    cap_cpu = allocatable[None, :, Resource.CPU]
    cap_mem = allocatable[None, :, Resource.MEMORY]
    safe_cpu = torch.where(cap_cpu == 0, 1.0, cap_cpu)
    safe_mem = torch.where(cap_mem == 0, 1.0, cap_mem)
    cpu_frac = (nonzero_ledger[None, :, 0] + nonzero_requests[:, None, 0]) / safe_cpu
    mem_frac = (nonzero_ledger[None, :, 1] + nonzero_requests[:, None, 1]) / safe_mem
    diff = torch.abs(cpu_frac - mem_frac)
    score = torch.trunc((1.0 - diff) * MAX_PRIORITY + FLOOR_EPS)
    bad = (cpu_frac >= 1.0) | (mem_frac >= 1.0) | (cap_cpu == 0) | (cap_mem == 0)
    return torch.where(bad, 0.0, score)


def taint_toleration_from_counts(counts: torch.Tensor,
                                 feasible: torch.Tensor) -> torch.Tensor:
    """The reduce half of TaintToleration (taint_toleration.go:73-96) over
    the last axis: (1 - count/max)*MaxPriority truncated, with the max over
    the `feasible` nodes (the reference reduces over the filtered node
    list); all MaxPriority when that max is 0."""
    counts = torch.where(feasible, counts.to(torch.float32), 0.0)
    max_count = counts.max(dim=-1, keepdim=True).values
    return torch.where(
        max_count > 0,
        torch.trunc((1.0 - counts / torch.clamp(max_count, min=1.0)) * MAX_PRIORITY
                    + FLOOR_EPS),
        float(MAX_PRIORITY))


def node_affinity_counts(state: ClusterState, batch: PodBatch) -> torch.Tensor:
    """The map half of NodeAffinityPriority (node_affinity.go
    CalculateNodeAffinityPriorityMap): f32[P, N], per node the total weight
    of the pod's preferred terms whose every requirement the node meets,
    `pref_onehot[P, TP, UR] @ req_member[N, UR].T >= pref_count`. The plain
    mirror of JAX's matmul: nothing on the scheduling path calls it; the
    solver, the plain scan and the kernels count from the 64-bit words
    (`ops.assign_scan.norm_counts`), which the tests hold against it."""
    term_sat = torch.matmul(batch.pref_onehot, state.req_member.T)   # [P, TP, N]
    matches = ((term_sat >= batch.pref_count[:, :, None])
               & (batch.pref_weight[:, :, None] > 0))
    return torch.where(matches, batch.pref_weight[:, :, None], 0.0).sum(dim=1)


def normalized_from_counts(counts: torch.Tensor,
                           feasible: torch.Tensor) -> torch.Tensor:
    """NormalizeReduce (node_affinity.go CalculateNodeAffinityPriorityReduce)
    over the last axis: trunc(MaxPriority * count / max) with the max over
    the `feasible` nodes; all 0 when that max is 0."""
    counts = torch.where(feasible, counts.to(torch.float32), 0.0)
    max_count = counts.max(dim=-1, keepdim=True).values
    return torch.where(
        max_count > 0,
        torch.trunc(counts * MAX_PRIORITY / torch.clamp(max_count, min=1.0)
                    + FLOOR_EPS),
        0.0)


def node_prefer_avoid(state: ClusterState, batch: PodBatch) -> torch.Tensor:
    """CalculateNodePreferAvoidPodsPriorityMap: 0 on nodes whose
    preferAvoidPods annotation names the pod's RC/RS controller,
    MaxPriority elsewhere."""
    hit = torch.matmul(batch.avoid_onehot, state.avoid_member.T)
    return torch.where(hit > 0, 0.0, float(MAX_PRIORITY))
