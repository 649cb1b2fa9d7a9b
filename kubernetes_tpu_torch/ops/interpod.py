"""Inter-pod (anti-)affinity as plain tensor ops (kubernetes_tpu/ops/interpod.py).

Re-expresses InterPodAffinityMatches and CalculateInterPodAffinityPriority
over interned universes:

- selectors -> the pod-selector universe UQ; `podsel_count[n, q]` counts
  the accounted pods on node n that selector q matches, `total_q[q]` those
  anywhere;
- the existing pods' terms -> the carried-term universe UE with per-entry
  attributes (selector id, topology code, signed weight, kind, poison);
  `term_count[n, e]` counts the carriers of term e on node n;
- topology domains -> per-slot domain ids in `topology[N, K]`; the domain
  aggregates `dom_*[K, D, U]` turn "a matching pod in my topology domain"
  into a gather instead of an N x N comparison.

The hostname slot (0) reads the node-level counts directly (its domains
are per node). An empty topologyKey on a preferred term means any default
failure domain, computed exactly by inclusion-exclusion over the virtual
(zone, region) slot: union = host count (nodes with neither label) + zone
+ region - zone-region.

The ledger is carried through the assignment scan (`ledger_add`), so pod
k sees the placements of pods 0..k-1. SelectorSpread reads the
pod-selector half only. These are the plain versions the CPU tests hold
against the JAX package, and the card holds kernel 2's interpod build
(csrc/assign_scan.cu) against. Every count is an integer-valued f32 far
below 2^24, so the one-hot products and sums are exact in any order.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from kubernetes_tpu_torch.ops.priorities import FLOOR_EPS
from kubernetes_tpu_torch.state.layout import (
    MAX_PRIORITY,
    TKEY_DEFAULT_UNION,
    TKEY_INVALID,
    TOPO_HOSTNAME,
    TOPO_REGION,
    TOPO_ZONE,
    TOPO_ZONE_REGION,
    TermKind,
)


@dataclass
class AffinityLedger:
    """The scan-carried affinity state. The carried-term fields are None
    when only the pod-selector consumers (SelectorSpread) run."""

    podsel_count: torch.Tensor   # f32[N, UQ]
    total_q: torch.Tensor        # f32[UQ]
    term_count: torch.Tensor | None = None   # f32[N, UE]
    dom_podsel: torch.Tensor | None = None   # f32[K, D, UQ]
    dom_term: torch.Tensor | None = None     # f32[K, D, UE]
    total_e: torch.Tensor | None = None      # f32[UE]


def topology_onehot(topology: torch.Tensor, domain_universe: int) -> torch.Tensor:
    """f32[K, N, D]: one-hot of each node's domain id per topology slot; the
    -1 (no label) sentinel, and an id past the universe, give a zero row."""
    ids = topology.to(torch.int64)
    onehot = (ids[..., None] == torch.arange(domain_universe,
                                             device=topology.device))
    return onehot.to(torch.float32).permute(1, 0, 2)


def domain_aggregates(topology: torch.Tensor, counts: torch.Tensor,
                      domain_universe: int) -> torch.Tensor:
    """f32[K, D, U]: per-domain sums of the per-node counts (nodes without
    a domain in a slot are left out of it)."""
    onehot = topology_onehot(topology, domain_universe)      # [K, N, D]
    return torch.einsum("knd,nu->kdu", onehot, counts)


def make_ledger(podsel_count: torch.Tensor, term_count: torch.Tensor | None = None,
                topology: torch.Tensor | None = None,
                domain_universe: int = 0) -> AffinityLedger:
    """The ledger as of batch start, from the accounted state's counts
    (copied: `ledger_add` updates the ledger in place). With `term_count`
    (and the nodes' `topology`), the carried-term half and the domain
    aggregates too."""
    if term_count is None:
        return AffinityLedger(podsel_count=podsel_count.clone(),
                              total_q=podsel_count.sum(0))
    return AffinityLedger(
        podsel_count=podsel_count.clone(), total_q=podsel_count.sum(0),
        term_count=term_count.clone(),
        dom_podsel=domain_aggregates(topology, podsel_count, domain_universe),
        dom_term=domain_aggregates(topology, term_count, domain_universe),
        total_e=term_count.sum(0))


def _slot_counts(topo_onehot: torch.Tensor, node_counts: torch.Tensor,
                 dom_counts: torch.Tensor) -> torch.Tensor:
    """f32[K, N, U]: for every topology slot k, the matches in node n's
    k-domain; slot 0 (hostname) is the node-level counts."""
    out = torch.einsum("knd,kdu->knu", topo_onehot, dom_counts)
    out[TOPO_HOSTNAME] = node_counts
    return out


def _union_counts(topology: torch.Tensor, slot_counts: torch.Tensor,
                  node_counts: torch.Tensor) -> torch.Tensor:
    """f32[N, U]: matches in the union of the default failure domains."""
    has_zone = (topology[:, TOPO_ZONE] >= 0)[:, None]
    has_region = (topology[:, TOPO_REGION] >= 0)[:, None]
    host_part = node_counts * (~has_zone) * (~has_region)
    return (host_part + slot_counts[TOPO_ZONE] + slot_counts[TOPO_REGION]
            - slot_counts[TOPO_ZONE_REGION])


def _counts_by_tkey(tkey: torch.Tensor, slot_counts: torch.Tensor,
                    union: torch.Tensor) -> torch.Tensor:
    """f32[N, U]: each entry's count at its topology code (tkey i32[U]):
    TKEY_INVALID selects 0, TKEY_DEFAULT_UNION the union."""
    out = torch.where(tkey[None, :] == TKEY_DEFAULT_UNION, union, 0.0)
    for k in range(slot_counts.shape[0]):
        out = out + torch.where(tkey[None, :] == k, slot_counts[k], 0.0)
    return out


def _scalar_count(q, tkey, slots: torch.Tensor,
                  union_all: torch.Tensor) -> torch.Tensor:
    """f32[N]: the count of one own-term slot (q >= 0, tkey: scalar
    tensors) from the [K, N, U] stack of `_slot_counts`."""
    qi = q.long()
    out = torch.where(tkey == TKEY_DEFAULT_UNION, union_all[:, qi], 0.0)
    for k in range(slots.shape[0]):
        out = out + torch.where(tkey == k, slots[k, :, qi], 0.0)
    return out


def _match_e(state, pod) -> torch.Tensor:
    """f32[UE]: which carried terms select the pod."""
    term_q = state.term_q
    return torch.where(term_q >= 0,
                       pod.pod_matches_q[torch.clamp(term_q, min=0).long()], 0.0)


def _carried_counts(state, ledger: AffinityLedger,
                    topo_onehot: torch.Tensor) -> torch.Tensor:
    """f32[N, UE]: each carried term's carriers at its topology code."""
    slot_e = _slot_counts(topo_onehot, ledger.term_count, ledger.dom_term)
    union_e = _union_counts(state.topology, slot_e, ledger.term_count)
    return _counts_by_tkey(state.term_tkey, slot_e, union_e)


def _own_counts(state, ledger: AffinityLedger, topo_onehot: torch.Tensor):
    """The pod-selector slot stack and union the pod's own terms read."""
    slot_q = _slot_counts(topo_onehot, ledger.podsel_count, ledger.dom_podsel)
    return slot_q, _union_counts(state.topology, slot_q, ledger.podsel_count)


def interpod_feasible(state, pod, ledger: AffinityLedger,
                      topo_onehot: torch.Tensor) -> torch.Tensor:
    """bool[N]: InterPodAffinityMatches for one pod against every node.
    `state` carries topology and the term attributes, `pod` one pod's
    rows (pod_matches_q, paff_q/paff_tkey, panti_q/panti_tkey,
    ipaff_fail)."""
    n = state.topology.shape[0]
    # the existing pods' required anti-affinity
    match_e = _match_e(state, pod)
    anti = state.term_kind == TermKind.ANTI_REQ
    active = anti & (match_e > 0)
    # a carried required anti term with an unparseable selector rejects
    # every pod while a carrier exists
    poisoned = (anti & state.term_poison & (ledger.total_e > 0)).any()
    cnt_e = _carried_counts(state, ledger, topo_onehot)
    # an empty topologyKey on a required anti term rejects every node while
    # a carrier exists
    invalid_term = (state.term_tkey == TKEY_INVALID) & (ledger.total_e > 0)
    violations = torch.where(active[None, :], cnt_e + invalid_term[None, :],
                             0.0).sum(1)
    ok = (violations == 0) & ~poisoned

    slot_q, union_q = _own_counts(state, ledger, topo_onehot)
    # the pod's own required affinity: a matching pod in the node's domain,
    # or none anywhere and the pod matches its own term (the first pod of a
    # collection)
    for t in range(pod.paff_q.shape[0]):
        q = pod.paff_q[t]
        qc = torch.clamp(q, min=0)
        cnt = _scalar_count(qc, pod.paff_tkey[t], slot_q, union_q)
        exists = ledger.total_q[qc.long()] > 0
        self_match = pod.pod_matches_q[qc.long()] > 0
        term_ok = (cnt > 0) | (~exists & self_match)
        ok = ok & ((q < 0) | term_ok)
    # the pod's own required anti-affinity
    for t in range(pod.panti_q.shape[0]):
        q = pod.panti_q[t]
        cnt = _scalar_count(torch.clamp(q, min=0), pod.panti_tkey[t], slot_q,
                            union_q)
        ok = ok & ((q < 0) | (cnt == 0))
    return ok & ~pod.ipaff_fail & torch.ones((n,), dtype=torch.bool,
                                             device=ok.device)


def interpod_counts(state, pod, ledger: AffinityLedger, hard_weight: float,
                    topo_onehot: torch.Tensor) -> torch.Tensor:
    """f32[N]: the weighted counts of CalculateInterPodAffinityPriority,
    the pod's own preferred terms (ppref_q, ppref_tkey, ppref_w) plus the
    symmetric contributions of the existing pods' terms (required affinity
    weighted by hard_weight)."""
    slot_q, union_q = _own_counts(state, ledger, topo_onehot)
    counts = torch.zeros((state.topology.shape[0],), dtype=torch.float32,
                         device=state.topology.device)
    for t in range(pod.ppref_q.shape[0]):
        q = pod.ppref_q[t]
        cnt = _scalar_count(torch.clamp(q, min=0), pod.ppref_tkey[t], slot_q,
                            union_q)
        counts = counts + torch.where(q >= 0, pod.ppref_w[t] * cnt, 0.0)
    eff_w = state.term_weight + hard_weight * (
        state.term_kind == TermKind.AFF_REQ).to(torch.float32)
    cnt_e = _carried_counts(state, ledger, topo_onehot)
    return counts + (cnt_e * (_match_e(state, pod) * eff_w)[None, :]).sum(1)


def interpod_score(counts: torch.Tensor, feasible: torch.Tensor) -> torch.Tensor:
    """fScore = MaxPriority * (c - min) / (max - min), min and max over the
    feasible nodes and clamped through 0, truncated; 0 when max == min."""
    masked = torch.where(feasible, counts, 0.0)
    max_c = torch.clamp(masked.max(), min=0.0)
    min_c = torch.clamp(masked.min(), max=0.0)
    spread = max_c - min_c
    score = torch.trunc(MAX_PRIORITY * (counts - min_c)
                        / torch.clamp(spread, min=1.0) + FLOOR_EPS)
    return torch.where(spread > 0, score, 0.0)


def ledger_add(ledger: AffinityLedger, q_row: torch.Tensor, node,
               add: torch.Tensor, e_row: torch.Tensor | None = None,
               topology: torch.Tensor | None = None) -> None:
    """Account an assignment (add is 1.0 or 0.0) of a pod with match row
    q_row f32[UQ] on `node`, in place; with the carried-term half, its
    carried-term row e_row f32[UE] too, and both rows into the domain
    aggregates of the node's non-hostname domains (`topology` i32[N, K])."""
    row = add * q_row
    ledger.podsel_count[node] += row
    ledger.total_q += row
    if ledger.term_count is None:
        return
    e = add * e_row
    ledger.term_count[node] += e
    ledger.total_e += e
    doms = topology[node].long()                             # i32[K]
    k_idx = torch.arange(doms.shape[0], device=doms.device)
    d_universe = ledger.dom_podsel.shape[1]
    mask = (doms >= 0) & (doms < d_universe) & (k_idx != TOPO_HOSTNAME)
    d_idx = torch.clamp(doms, 0, d_universe - 1)
    dmask = mask.to(torch.float32)[:, None]
    ledger.dom_podsel.index_put_((k_idx, d_idx), dmask * row[None, :],
                                 accumulate=True)
    ledger.dom_term.index_put_((k_idx, d_idx), dmask * e[None, :],
                               accumulate=True)
