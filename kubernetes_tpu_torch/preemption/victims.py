"""VictimTable assembly and verdict resolution, this package's copy of
kubernetes_tpu/preemption/victims.py.

The device pass sees victims only as tensors (priorities, request rows,
evictable bits) in a fixed slot order, and this module owns that order:
slots are the S lowest-priority accounted pods of each node, ascending by
(priority, pod key), so a verdict "evict k victims on node n" names the
first k slots still evictable for that preemptor. No pod identity crosses
to the device.
"""

from __future__ import annotations

import numpy as np

from kubernetes_tpu_torch.ops.preemption import INT32_MAX, VictimTable
from kubernetes_tpu_torch.state.layout import Resource


def build_victim_table(statedb, *, evictable=None, exclude=()):
    """The VictimTable (numpy arrays; `state.convert.victims_from_numpy`
    carries it to a device) and the host identity map, from the StateDB's
    accounted (bound or batch-placed) pods, each with its priority
    (spec.priority) and the requests it was accounted with.

    `evictable(pod)` stands in for the PodDisruptionBudget check (every
    pod is evictable without it); the pods whose keys are in `exclude`
    (victims an earlier verdict claimed) take no slot. Returns (victims,
    slots):
    - victims: ops.preemption.VictimTable of prio i32[N, S] (INT32_MAX on
      empty slots), req f32[N, S, R] and ok bool[N, S] (False on empty
      slots), or None when no slot is evictable (the caller then runs the
      batch without the pass);
    - slots: node row -> [(pod key, priority, evictable)] in slot order,
      for `resolve_victims`.

    Only the S = caps.victim_slots lowest-priority pods of a node are
    candidates: a node that needs deeper eviction reports no set."""
    caps = statedb.caps
    n, s = caps.num_nodes, caps.victim_slots
    prio = np.full((n, s), INT32_MAX, np.int32)
    req = np.zeros((n, s, Resource.COUNT), np.float32)
    ok = np.zeros((n, s), bool)
    slots: dict[int, list] = {}

    row_of = statedb.table.row_of
    per_node: dict[int, list] = {}
    # an accounted pod: (node name, j, requests f32[K, R], ..., pod)
    for key, acc in statedb._accounted.items():
        row = row_of.get(acc[0])
        if row is None or key in exclude:
            continue
        pod = acc[6]
        per_node.setdefault(row, []).append(
            (int(pod.spec.priority), key, acc[2][acc[1]], pod))

    any_candidate = False
    for row, entries in per_node.items():
        entries.sort(key=lambda e: (e[0], e[1]))
        slot_list = []
        for i, (p, key, requests, pod) in enumerate(entries[:s]):
            ev = True if evictable is None else bool(evictable(pod))
            prio[row, i] = p
            req[row, i] = requests
            ok[row, i] = ev
            any_candidate = any_candidate or ev
            slot_list.append((key, p, ev))
        slots[row] = slot_list

    if not any_candidate:
        return None, slots
    return VictimTable(prio=prio, req=req, ok=ok), slots


def resolve_victims(slots: dict, node_row: int, k: int,
                    preemptor_priority: int, taken: set) -> list[str] | None:
    """The device's victim set of a (node, k) verdict: the first k slots on
    the node that are evictable, of a priority strictly below the
    preemptor's, and not claimed by an earlier preemptor (`taken`, which
    this call extends). Returns the pod keys, or None if the table can no
    longer supply k victims (the caller drops the verdict; the pod retries
    next batch)."""
    chosen: list[str] = []
    for key, p, ev in slots.get(node_row, ()):
        if len(chosen) == k:
            break
        if not ev or key in taken or p >= preemptor_priority:
            continue
        chosen.append(key)
    if len(chosen) < k:
        return None
    taken.update(chosen)
    return chosen
