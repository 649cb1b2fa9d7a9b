"""EncodeContext: the lister lookups the pod encoder needs.

The analog of the reference's PluginFactoryArgs (factory/plugins.go): the
predicate and priority factories receive the PVC and PV lookups and the
Service, ReplicationController, ReplicaSet and StatefulSet listers; here
one context object carries the same lookups into encoding. Every field has
an empty default, so encoding without a context resolves no claim and sees
no workload objects; `Scheduler` builds one over its own listers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable


def _none(*_a, **_k):
    return None


def _empty(*_a, **_k):
    return []


@dataclass
class EncodeContext:
    get_pvc: Callable = _none          # (namespace, name) -> PVC | None
    get_pv: Callable = _none           # (name) -> PV | None
    # the PersistentLocalVolumes feature gate of NoVolumeNodeConflict
    # (alpha, off by default)
    local_volumes_enabled: bool = False
    get_services: Callable = _empty    # (namespace) -> [Service]
    get_rcs: Callable = _empty         # (namespace) -> [ReplicationController]
    get_rss: Callable = _empty         # (namespace) -> [ReplicaSet]
    get_sss: Callable = _empty         # (namespace) -> [StatefulSet]
    list_pods: Callable = _empty       # (namespace) -> [Pod]
    # True when a ServiceAntiAffinity priority is configured: per-pod
    # service totals depend on the live pod list, so rows must not be
    # cached. The solver of this package refuses that priority.
    service_anti: bool = False


EMPTY_CONTEXT = EncodeContext()
