"""Pod-affinity host code: selector canonicalization and matching, and the
parsing of a pod's PodAffinityTerms.

Selectors are canonicalized on the host and interned into the pod-selector
universe (cluster_state.NodeTable.intern_podsel); pods are matched against
universe entries when they are encoded or accounted, and the device only
sees integer ids, match rows and per-node counts.

Semantics mirrored:
- `metav1.LabelSelectorAsSelector`: a nil selector matches no pods, an
  empty one every pod; matchLabels entries become In requirements; only
  In/NotIn/Exists/DoesNotExist are legal operators.
- `labels.SelectorFromSet` for the map-style selectors of Services and
  ReplicationControllers.
- `PodMatchesTermsNamespaceAndSelector`: namespace membership AND a
  selector match.
- `GetNamespacesFromPodAffinityTerm`: an empty namespace list means the
  namespace of the pod *carrying* the term.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from kubernetes_tpu_torch.api.objects import Pod
from kubernetes_tpu_torch.state.cluster_state import match_requirement

# Canonical selector forms:
#   NOTHING          - nil selector, matches no pods
#   PARSE_ERROR      - invalid selector
#   ()               - empty selector, matches everything
#   ((key, op, values), ...) - conjunction of requirements
#   (UNION, (canon, ...))    - disjunction (SelectorSpread's match-any over
#                              controller selectors, selector_spreading.go:123)
NOTHING = "<nothing>"
PARSE_ERROR = "<error>"
UNION = "<union>"

_SEL_OPS = ("In", "NotIn", "Exists", "DoesNotExist")


def canonical_selector(selector: dict | None):
    """Canonicalize a metav1.LabelSelector dict."""
    if selector is None:
        return NOTHING
    reqs = []
    for k in sorted(selector.get("matchLabels") or {}):
        reqs.append((k, "In", (selector["matchLabels"][k],)))
    for e in selector.get("matchExpressions") or []:
        op = e.get("operator", "")
        values = tuple(sorted(e.get("values") or ()))
        if op not in _SEL_OPS:
            return PARSE_ERROR
        if op in ("In", "NotIn") and not values:
            return PARSE_ERROR
        if op in ("Exists", "DoesNotExist") and values:
            return PARSE_ERROR
        reqs.append((e.get("key", ""), op, values))
    return tuple(sorted(reqs))


def union_selector(canons) -> tuple:
    """Canonical match-any disjunction over selector canons."""
    return (UNION, tuple(sorted(set(canons), key=repr)))


def map_selector(selector: dict) -> tuple:
    """Canonicalize a map-style selector (Service and RC spec.selector)."""
    return tuple(sorted((k, "In", (v,)) for k, v in selector.items()))


def selector_matches(canon, labels: dict[str, str]) -> bool:
    if canon == NOTHING or canon == PARSE_ERROR:
        return False
    if len(canon) == 2 and canon[0] == UNION:
        return any(selector_matches(c, labels) for c in canon[1])
    return all(match_requirement(labels, k, op, values)
               for k, op, values in canon)


@dataclass(frozen=True)
class ParsedTerm:
    """One PodAffinityTerm with namespaces resolved against its carrier."""

    selector: Any                 # canonical selector form
    namespaces: frozenset[str]
    topology_key: str             # "" = empty (meaning depends on term kind)
    weight: int = 0               # preferred terms only


def _parse_term(term: dict, carrier_namespace: str, weight: int = 0) -> ParsedTerm:
    return ParsedTerm(
        selector=canonical_selector(term.get("labelSelector")),
        namespaces=frozenset(term.get("namespaces") or [carrier_namespace]),
        topology_key=term.get("topologyKey", "") or "",
        weight=weight,
    )


@dataclass
class PodAffinityTerms:
    """All four term lists of one pod, parsed."""

    aff_req: list[ParsedTerm]
    anti_req: list[ParsedTerm]
    aff_pref: list[ParsedTerm]
    anti_pref: list[ParsedTerm]


def parse_pod_affinity(affinity: dict | None,
                       carrier_namespace: str) -> PodAffinityTerms:
    """The four PodAffinityTerm lists of a raw v1 Affinity dict
    (getPodAffinityTerms / getPodAntiAffinityTerms)."""
    aff = (affinity or {}).get("podAffinity") or {}
    anti = (affinity or {}).get("podAntiAffinity") or {}

    def required(src):
        return [_parse_term(t, carrier_namespace) for t in
                src.get("requiredDuringSchedulingIgnoredDuringExecution") or []]

    def preferred(src):
        return [_parse_term(p.get("podAffinityTerm") or {}, carrier_namespace,
                            weight=int(p.get("weight", 0))) for p in
                src.get("preferredDuringSchedulingIgnoredDuringExecution") or []]

    return PodAffinityTerms(aff_req=required(aff), anti_req=required(anti),
                            aff_pref=preferred(aff), anti_pref=preferred(anti))


def pod_matches_entry(pod: Pod, ns_key: frozenset, canon) -> bool:
    """PodMatchesTermsNamespaceAndSelector for a universe entry."""
    return (pod.metadata.namespace in ns_key
            and selector_matches(canon, pod.metadata.labels))
