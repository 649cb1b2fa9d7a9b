"""Host-side spreading analysis: the controller selectors of a pod.

Mirrors the lister-driven half of SelectorSpreadPriority
(selector_spreading.go:61-89 getSelectors) and the first-service lookup of
ServiceAntiAffinityPriority (:190-250). Everything resolves to interned
pod-selector ids: the pod's controller selectors become ONE universe entry
with match-any union semantics, so per-node counts never count a pod twice
when it matches two selectors (selector_spreading.go:123-131).
"""

from __future__ import annotations

from kubernetes_tpu_torch.api.objects import Pod
from kubernetes_tpu_torch.state.context import EncodeContext
from kubernetes_tpu_torch.state.podaffinity import (
    PARSE_ERROR,
    canonical_selector,
    map_selector,
    selector_matches,
    union_selector,
)


def pod_controller_selectors(pod: Pod, ctx: EncodeContext) -> tuple[list, list]:
    """Canonical selectors of the Services, and of the RCs, RSs and
    StatefulSets, that match the pod, in lister order (getSelectors,
    selector_spreading.go:61; the Services alone are the
    ServiceSpreadingPriority variant, defaults.go:97-104).

    Lister semantics: nil selectors match nothing, a non-nil empty map
    matches everything (service_expansion.go:45-50); the RC/RS/SS listers
    error out for label-less pods (ignored by getSelectors), the Service
    lister does not."""
    ns = pod.metadata.namespace
    labels = pod.metadata.labels
    services = []
    for svc in ctx.get_services(ns):
        sel = svc.selector
        if sel is not None:
            canon = map_selector(sel)
            if selector_matches(canon, labels):
                services.append(canon)
    controllers = []
    if not labels:
        return services, controllers
    for rc in ctx.get_rcs(ns):
        sel = rc.selector
        if sel:
            canon = map_selector(sel)
            if selector_matches(canon, labels):
                controllers.append(canon)
    for workload in (*ctx.get_rss(ns), *ctx.get_sss(ns)):
        canon = canonical_selector(workload.selector or None)
        if canon != PARSE_ERROR and canon != () \
                and selector_matches(canon, labels):
            controllers.append(canon)
    return services, controllers


def spreading_entries(pod: Pod, ctx: EncodeContext, table):
    """(spread_q, spread_svc_q, svcanti_q, svcanti_total) of one pod, with
    one pass over the listers, interned in the reference encoder's order
    (kubernetes_tpu/state/spreading.py `spread_entry`, its services-only
    variant, then `first_service_entry`):
    - spread_q: the pod-selector-universe id of the union of every
      matching selector, -1 when none matches (the score is then a uniform
      MaxPriority, selector_spreading.go:157-167);
    - spread_svc_q: the same over the Services alone;
    - svcanti_q, svcanti_total: ServiceAntiAffinityPriority's first
      matching Service (selector_spreading.go:228) interned for the pod's
      namespace, and the bound pods of that namespace it matches (the
      scheduler cache's pod lister holds bound pods only)."""
    services, controllers = pod_controller_selectors(pod, ctx)
    if not services and not controllers:
        return -1, -1, -1, 0.0
    ns = pod.metadata.namespace
    ns_key = frozenset([ns])
    spread_q = table.intern_podsel(ns_key, union_selector(services + controllers))
    if not services:
        return spread_q, -1, -1, 0.0
    spread_svc_q = table.intern_podsel(ns_key, union_selector(services))
    first = services[0]
    total = sum(1 for p in ctx.list_pods(ns)
                if p.spec.node_name and selector_matches(first, p.metadata.labels))
    return spread_q, spread_svc_q, table.intern_podsel(ns_key, first), float(total)
