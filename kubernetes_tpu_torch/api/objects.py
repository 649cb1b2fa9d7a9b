"""Typed API objects: the v1 `Node` / `Pod` subset the encoders read, the
workload objects SelectorSpread looks pods up in (Service,
ReplicationController, ReplicaSet, StatefulSet), and the PodGroup whose
minMember is a gang's quorum.

Parsed from the same Kubernetes-JSON dict shape the reference package
accepts, so one fixture dict feeds both packages. Only the fields the
encoders read are modeled; the rest of a v1 object is ignored.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    owner_references: list[dict[str, Any]] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ObjectMeta":
        return cls(
            name=d.get("name", ""),
            namespace=d.get("namespace", "default"),
            labels=dict(d.get("labels") or {}),
            annotations=dict(d.get("annotations") or {}),
            owner_references=list(d.get("ownerReferences") or []),
        )


@dataclass
class Container:
    name: str = ""
    image: str = ""
    requests: dict[str, str] = field(default_factory=dict)
    limits: dict[str, str] = field(default_factory=dict)
    host_ports: list[int] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Container":
        res = d.get("resources") or {}
        return cls(
            name=d.get("name", ""),
            image=d.get("image", ""),
            requests={k: str(v) for k, v in (res.get("requests") or {}).items()},
            limits={k: str(v) for k, v in (res.get("limits") or {}).items()},
            host_ports=[int(p.get("hostPort", 0)) for p in d.get("ports") or []
                        if int(p.get("hostPort", 0))],
        )


@dataclass
class Toleration:
    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # "" tolerates all effects

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Toleration":
        return cls(
            key=d.get("key", "") or "",
            operator=d.get("operator", "Equal") or "Equal",
            value=d.get("value", "") or "",
            effect=d.get("effect", "") or "",
        )


@dataclass
class Taint:
    key: str = ""
    value: str = ""
    effect: str = "NoSchedule"  # NoSchedule | PreferNoSchedule | NoExecute

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Taint":
        return cls(key=d.get("key", ""), value=d.get("value", "") or "",
                   effect=d.get("effect", "NoSchedule"))


@dataclass
class PodSpec:
    node_name: str = ""
    node_selector: dict[str, str] = field(default_factory=dict)
    containers: list[Container] = field(default_factory=list)
    tolerations: list[Toleration] = field(default_factory=list)
    affinity: dict[str, Any] = field(default_factory=dict)  # raw v1 Affinity
    volumes: list[dict[str, Any]] = field(default_factory=list)  # raw v1 Volume
    priority: int = 0

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "PodSpec":
        return cls(
            node_name=d.get("nodeName", "") or "",
            node_selector=dict(d.get("nodeSelector") or {}),
            containers=[Container.from_dict(c) for c in d.get("containers") or []],
            tolerations=[Toleration.from_dict(t) for t in d.get("tolerations") or []],
            affinity=dict(d.get("affinity") or {}),
            volumes=list(d.get("volumes") or []),
            priority=int(d.get("priority", 0) or 0),
        )


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Pod":
        return cls(metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
                   spec=PodSpec.from_dict(d.get("spec") or {}))

    def is_best_effort(self) -> bool:
        """BestEffort QoS: no container has any request or limit."""
        return not any(c.requests or c.limits for c in self.spec.containers)

    def host_ports(self) -> list[int]:
        """Requested host ports (port 0 excluded)."""
        return [p for c in self.spec.containers for p in c.host_ports]


def parse_node_affinity(affinity: dict) -> tuple[list | None, list]:
    """Split a raw v1 Affinity dict into node-affinity parts.

    Returns `(required_terms, preferred)`: `required_terms` is None when no
    requiredDuringSchedulingIgnoredDuringExecution NodeSelector is present
    (matches all nodes), else the list of nodeSelectorTerms (each a list of
    matchExpressions dicts; an empty list matches no node). `preferred` is a
    list of `(weight, matchExpressions)` tuples."""
    na = (affinity or {}).get("nodeAffinity") or {}
    required = na.get("requiredDuringSchedulingIgnoredDuringExecution")
    req_terms = None
    if required is not None:
        req_terms = [t.get("matchExpressions") or []
                     for t in required.get("nodeSelectorTerms") or []]
    preferred = [(int(p.get("weight", 0)),
                  (p.get("preference") or {}).get("matchExpressions") or [])
                 for p in na.get(
                     "preferredDuringSchedulingIgnoredDuringExecution") or []]
    return req_terms, preferred


@dataclass
class NodeCondition:
    type: str = ""
    status: str = "Unknown"  # True | False | Unknown

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "NodeCondition":
        return cls(type=d.get("type", ""), status=d.get("status", "Unknown"))


@dataclass
class NodeSpec:
    unschedulable: bool = False
    taints: list[Taint] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "NodeSpec":
        return cls(unschedulable=bool(d.get("unschedulable", False)),
                   taints=[Taint.from_dict(t) for t in d.get("taints") or []])


@dataclass
class NodeStatus:
    capacity: dict[str, str] = field(default_factory=dict)
    allocatable: dict[str, str] = field(default_factory=dict)
    conditions: list[NodeCondition] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "NodeStatus":
        return cls(
            capacity={k: str(v) for k, v in (d.get("capacity") or {}).items()},
            allocatable={k: str(v) for k, v in (d.get("allocatable") or {}).items()},
            conditions=[NodeCondition.from_dict(c)
                        for c in d.get("conditions") or []],
        )

    def effective_allocatable(self) -> dict[str, str]:
        """allocatable falls back to capacity when unset."""
        return self.allocatable or self.capacity


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)

    @property
    def key(self) -> str:
        return self.metadata.name

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Node":
        return cls(metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
                   spec=NodeSpec.from_dict(d.get("spec") or {}),
                   status=NodeStatus.from_dict(d.get("status") or {}))


@dataclass
class _Workload:
    """A workload object as SelectorSpread reads it: metadata and the raw
    spec. `selector` is spec.selector: a map for Services and RCs
    (selector_spreading.go:68), a LabelSelector dict for ReplicaSets and
    StatefulSets (:73, :80)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: dict[str, Any] = field(default_factory=dict)

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    @property
    def selector(self) -> dict[str, Any]:
        return dict(self.spec.get("selector") or {})

    @classmethod
    def from_dict(cls, d: dict[str, Any]):
        return cls(metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
                   spec=dict(d.get("spec") or {}))


@dataclass
class Service(_Workload):
    @property
    def selector(self) -> dict[str, str] | None:
        """None when absent, which selects nothing; a non-nil empty map
        selects everything (service_expansion.go:45-50)."""
        sel = self.spec.get("selector")
        return None if sel is None else dict(sel)


@dataclass
class ReplicationController(_Workload):
    pass


@dataclass
class ReplicaSet(_Workload):
    pass


@dataclass
class StatefulSet(_Workload):
    pass


@dataclass
class PodGroup(_Workload):
    """Gang-scheduling group: spec.minMember pods must place together or
    none do (the reference package's PodGroup; the scheduler reads its
    quorum only)."""

    @property
    def min_member(self) -> int:
        m = self.spec.get("minMember")
        return 1 if m is None else int(m)
