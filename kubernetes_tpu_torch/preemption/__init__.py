"""Pod priority and preemption, the host half of the pass (the device half
is ops/preemption.py, kernel 3).

`build_victim_table` assembles the VictimTable from the StateDB's
accounted pods: the S lowest-priority pods a node, ascending by
(priority, pod key), so a device verdict (node, k) names the first k slots
still evictable for the preemptor, and `resolve_victims` turns it back
into pod keys. The reference's PDB read from a store (`pdb_evictable`) and
its nominated-node holds (`NominatedNodes`) come with the apiserver-driven
driver; until then an `evictable` callable stands in for the PDB check.
"""

from __future__ import annotations

from kubernetes_tpu_torch.preemption.victims import (
    build_victim_table,
    resolve_victims,
)

__all__ = ["build_victim_table", "resolve_victims"]
