"""Scheduler policy: which predicates/priorities run, with what weights.

The default sets are the reference's default algorithm provider
(algorithmprovider/defaults/defaults.go:118-235). The policy is frozen and
hashable. Argument-carrying registrations (labelsPresence, serviceAffinity,
labelPreference, serviceAntiAffinity) are declared here; the solver of
this package raises on a policy that activates them.
"""

from __future__ import annotations

from dataclasses import dataclass

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
