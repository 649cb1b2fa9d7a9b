"""SelectorSpread as plain tensor ops (kubernetes_tpu/ops/spread.py).

Re-expresses CalculateSpreadPriority (selector_spreading.go:100-188) over
the interned pod-selector universe: the pod carries ONE union entry id
(match-any over its controller selectors, state/spreading.py), the
per-node matching-pod counts are the scan's AffinityLedger, and the zone
aggregation rides the GetZoneKey topology slot (layout.TOPO_SPREAD_ZONE).
Both reductions run over the *feasible* nodes (PrioritizeNodes receives
the filtered node list, generic_scheduler.go:121).

This is the plain version the CPU tests hold against the JAX package and
the card holds the spread build of kernel 2 (csrc/assign_scan.cu) against.
Every operation is its own tensor op in the reference's order, so nothing
is contracted into a multiply-add.
"""

from __future__ import annotations

import torch

from kubernetes_tpu_torch.ops.interpod import AffinityLedger, topology_onehot
from kubernetes_tpu_torch.ops.priorities import FLOOR_EPS
from kubernetes_tpu_torch.state.layout import MAX_PRIORITY, TOPO_SPREAD_ZONE

# zoneWeighting (selector_spreading.go:36)
ZONE_WEIGHT = 2.0 / 3.0


def selector_spread(topology: torch.Tensor, spread_q, ledger: AffinityLedger,
                    feasible: torch.Tensor, domain_universe: int,
                    topo_onehot: torch.Tensor | None = None) -> torch.Tensor:
    """f32[N] SelectorSpread scores of one pod. spread_q is an i32 scalar
    tensor, -1 when no controller matches the pod: every node then scores
    MaxPriority (selector_spreading.go:157)."""
    qc = torch.clamp(spread_q, min=0).long()
    counts = ledger.podsel_count[:, qc]                    # f32[N]
    masked = torch.where(feasible, counts, 0.0)
    max_node = masked.max()

    dom = topology[:, TOPO_SPREAD_ZONE]
    has_zone = dom >= 0
    onehot = (topology_onehot(topology, domain_universe)
              if topo_onehot is None else topo_onehot)[TOPO_SPREAD_ZONE]
    # integer counts far below 2^24: the products are exact in any order
    zc = onehot.T @ masked                                 # f32[D]
    zc_node = onehot @ zc                                  # f32[N]
    have_zones = (feasible & has_zone).any()
    max_zone = zc.max()

    node_score = torch.where(
        max_node > 0,
        MAX_PRIORITY * (max_node - counts) / torch.clamp(max_node, min=1.0),
        float(MAX_PRIORITY))
    # maxCountByZone == 0 with haveZones is 0/0 in the reference; as in the
    # JAX package, all zones equally empty score MaxPriority
    zone_score = torch.where(
        max_zone > 0,
        MAX_PRIORITY * (max_zone - zc_node) / torch.clamp(max_zone, min=1.0),
        float(MAX_PRIORITY))
    blended = torch.where(
        have_zones & has_zone,
        node_score * (1.0 - ZONE_WEIGHT) + ZONE_WEIGHT * zone_score,
        node_score)
    score = torch.trunc(blended + FLOOR_EPS)
    return torch.where(spread_q < 0, float(MAX_PRIORITY), score)
