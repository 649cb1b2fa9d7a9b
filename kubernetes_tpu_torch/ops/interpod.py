"""The pod-selector half of the reference package's AffinityLedger
(kubernetes_tpu/ops/interpod.py).

Pod selectors intern into the universe UQ (state.cluster_state.NodeTable);
`podsel_count[n, q]` counts the accounted pods on node n that selector q
matches, and `total_q[q]` those anywhere. The ledger is carried through
the assignment scan, so pod k sees the placements of pods 0..k-1 (the
reference's serial assume semantics). SelectorSpread reads it here; the
carried-term half (term counts, domain aggregates) comes with the
inter-pod slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class AffinityLedger:
    podsel_count: torch.Tensor   # f32[N, UQ]
    total_q: torch.Tensor        # f32[UQ]


def topology_onehot(topology: torch.Tensor, domain_universe: int) -> torch.Tensor:
    """f32[K, N, D]: one-hot of each node's domain id per topology slot; the
    -1 (no label) sentinel, and an id past the universe, give a zero row."""
    ids = topology.to(torch.int64)
    onehot = (ids[..., None] == torch.arange(domain_universe,
                                             device=topology.device))
    return onehot.to(torch.float32).permute(1, 0, 2)


def make_ledger(podsel_count: torch.Tensor) -> AffinityLedger:
    """The ledger as of batch start, from the accounted state's counts
    (copied: `ledger_add` updates the ledger in place)."""
    return AffinityLedger(podsel_count=podsel_count.clone(),
                          total_q=podsel_count.sum(0))


def ledger_add(ledger: AffinityLedger, q_row: torch.Tensor, node,
               add: torch.Tensor) -> None:
    """Account an assignment (add is 1.0 or 0.0) of a pod with match row
    q_row f32[UQ] on `node`, in place."""
    row = add * q_row
    ledger.podsel_count[node] += row
    ledger.total_q += row
