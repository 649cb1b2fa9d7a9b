"""Scheduler policy: which predicates/priorities run, with what weights.

The default sets are the reference's default algorithm provider
(algorithmprovider/defaults/defaults.go:118-235). The policy is frozen and
hashable. Argument-carrying registrations (labelsPresence, serviceAffinity,
labelPreference, serviceAntiAffinity) are declared here; the solver of
this package raises on a policy that activates them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace

from kubernetes_tpu_torch.state.layout import VolType

# MaxPDVolumeCount's default limits (defaults.go:120-155)
DEFAULT_MAX_EBS_VOLUMES = 39
DEFAULT_MAX_GCE_PD_VOLUMES = 16
DEFAULT_MAX_AZURE_DISK_VOLUMES = 16
DEFAULT_PREDICATES: tuple[str, ...] = (
    "NoVolumeZoneConflict",
    "MaxEBSVolumeCount",
    "MaxGCEPDVolumeCount",
    "MaxAzureDiskVolumeCount",
    "MatchInterPodAffinity",
    "NoDiskConflict",
    "GeneralPredicates",
    "PodToleratesNodeTaints",
    "CheckNodeMemoryPressure",
    "CheckNodeDiskPressure",
    "CheckNodeCondition",
    "NoVolumeNodeConflict",
)

DEFAULT_PRIORITIES: tuple[tuple[str, int], ...] = (
    ("SelectorSpreadPriority", 1),
    ("InterPodAffinityPriority", 1),
    ("LeastRequestedPriority", 1),
    ("BalancedResourceAllocation", 1),
    ("NodePreferAvoidPodsPriority", 10000),
    ("NodeAffinityPriority", 1),
    ("TaintTolerationPriority", 1),
)

KNOWN_PREDICATES = frozenset({
    "GeneralPredicates", "PodFitsResources", "PodFitsHost", "PodFitsHostPorts",
    "MatchNodeSelector", "PodToleratesNodeTaints", "CheckNodeMemoryPressure",
    "CheckNodeDiskPressure", "CheckNodeCondition", "MatchInterPodAffinity",
    "PodFitsPorts", "HostName",
    "NoDiskConflict", "MaxEBSVolumeCount", "MaxGCEPDVolumeCount",
    "MaxAzureDiskVolumeCount", "NoVolumeZoneConflict", "NoVolumeNodeConflict",
})

KNOWN_PRIORITIES = frozenset({
    "LeastRequestedPriority", "MostRequestedPriority",
    "BalancedResourceAllocation", "TaintTolerationPriority", "EqualPriority",
    "NodeAffinityPriority", "InterPodAffinityPriority",
    "SelectorSpreadPriority", "ServiceSpreadingPriority",
    "NodePreferAvoidPodsPriority", "ImageLocalityPriority",
})


@dataclass(frozen=True)
class Policy:
    predicates: tuple[str, ...] = DEFAULT_PREDICATES
    priorities: tuple[tuple[str, int], ...] = DEFAULT_PRIORITIES
    # HardPodAffinitySymmetricWeight: the score granted per existing pod
    # whose *required* affinity term matches the incoming pod, in
    # InterPodAffinityPriority's symmetric pass
    hard_pod_affinity_weight: int = 1
    # MaxPDVolumeCount's limits (`with_env_overrides` applies the
    # KUBE_MAX_PD_VOLS override)
    max_ebs_volumes: int = DEFAULT_MAX_EBS_VOLUMES
    max_gce_pd_volumes: int = DEFAULT_MAX_GCE_PD_VOLUMES
    max_azure_disk_volumes: int = DEFAULT_MAX_AZURE_DISK_VOLUMES
    # (name, (labels...), presence) — CheckNodeLabelPresence instances
    label_presence_predicates: tuple = ()
    # (name, (labels...)) — ServiceAffinity instances
    service_affinity_predicates: tuple = ()
    # (name, label, presence) — NodeLabelPriority instances
    label_priorities: tuple = ()
    # (name, label) — ServiceAntiAffinityPriority instances
    service_anti_priorities: tuple = ()

    def __post_init__(self):
        arg_preds = ({n for n, _, _ in self.label_presence_predicates}
                     | {n for n, _ in self.service_affinity_predicates})
        unknown = set(self.predicates) - KNOWN_PREDICATES - arg_preds
        if unknown:
            raise ValueError(f"unknown predicates: {sorted(unknown)}")
        arg_prios = ({n for n, _, _ in self.label_priorities}
                     | {n for n, _ in self.service_anti_priorities})
        unknown = {n for n, _ in self.priorities} - KNOWN_PRIORITIES - arg_prios
        if unknown:
            raise ValueError(f"unknown priorities: {sorted(unknown)}")
        for n, w in self.priorities:
            if w <= 0:
                raise ValueError(f"priority {n} must have a positive weight, got {w}")

    def has_predicate(self, *names: str) -> bool:
        return any(n in self.predicates for n in names)

    def attach_maxes(self) -> tuple[tuple[int, int], ...]:
        """((VolType, limit), ...) of the MaxPDVolumeCount predicates in the
        policy."""
        out = []
        if "MaxEBSVolumeCount" in self.predicates:
            out.append((VolType.EBS, self.max_ebs_volumes))
        if "MaxGCEPDVolumeCount" in self.predicates:
            out.append((VolType.GCE, self.max_gce_pd_volumes))
        if "MaxAzureDiskVolumeCount" in self.predicates:
            out.append((VolType.AZURE, self.max_azure_disk_volumes))
        return tuple(out)

    def with_env_overrides(self) -> "Policy":
        """KUBE_MAX_PD_VOLS (defaults.go getMaxVols), a positive integer,
        as every attach limit, as the reference's predicate factories read
        it; the policy as it is without one."""
        try:
            limit = int(os.environ.get("KUBE_MAX_PD_VOLS", ""))
        except ValueError:
            return self
        if limit <= 0:
            return self
        return replace(self, max_ebs_volumes=limit, max_gce_pd_volumes=limit,
                       max_azure_disk_volumes=limit)

    def weight(self, name: str) -> int:
        for n, w in self.priorities:
            if n == name:
                return w
        return 0


DEFAULT_POLICY = Policy()


def active_label_priorities(policy: Policy) -> tuple:
    """((label, presence, weight), ...) for configured NodeLabel priorities."""
    weights = dict(policy.priorities)
    return tuple((label, presence, weights[name])
                 for name, label, presence in policy.label_priorities
                 if weights.get(name))


def active_service_anti(policy: Policy) -> tuple:
    """((label, weight), ...) for configured ServiceAntiAffinity priorities."""
    weights = dict(policy.priorities)
    return tuple((label, weights[name])
                 for name, label in policy.service_anti_priorities
                 if weights.get(name))


def active_label_presence(policy: Policy) -> tuple:
    """(((labels...), presence), ...) for configured CheckNodeLabelPresence
    instances."""
    return tuple((labels, presence)
                 for name, labels, presence in policy.label_presence_predicates
                 if name in policy.predicates)
