"""Gang scheduling: all-or-nothing placement of pod groups.

A multi-host job is useless until every member lands, so its pods place
atomically or not at all. In this package:

- `state/pod_batch.py` holds per-pod gang_id / gang_min columns; the
  encoder leaves them zero (a cached row cannot carry a batch-local group
  id) and `write_gang_columns` fills them after encoding;
- `ops/solver.py` runs the gang build of the assignment scan
  (`BatchFlags.gang`): a group that leaves the scan below quorum restores
  the ledger and the round-robin counter it entered with, and every member
  of such a group comes back unassigned;
- `scheduler/driver.py` batches a group whole, with its members sorted by
  key, and releases a group it can never place together (larger than a
  batch, or below quorum) for individual scheduling.

Pods opt in with the `scheduling.ktpu.io/group-name` annotation; the
group's quorum is the largest `scheduling.ktpu.io/group-min` annotation
seen on a member, else 1 (the reference package's convention).
"""

from __future__ import annotations

# group membership: pods carrying the same group-name annotation in one
# namespace form a gang
GROUP_NAME_ANNOTATION = "scheduling.ktpu.io/group-name"
# quorum override carried on pods when no PodGroup exists
GROUP_MIN_ANNOTATION = "scheduling.ktpu.io/group-min"


def pod_group_key(pod) -> str | None:
    """\"namespace/groupname\" for a gang-annotated pod, else None."""
    name = pod.metadata.annotations.get(GROUP_NAME_ANNOTATION)
    if not name:
        return None
    return f"{pod.metadata.namespace}/{name}"


def annotation_min(obj) -> int | None:
    """The group-min annotation as an int, None when absent or invalid."""
    raw = obj.metadata.annotations.get(GROUP_MIN_ANNOTATION)
    if raw is None:
        return None
    try:
        value = int(raw)
    except (TypeError, ValueError):
        return None
    return value if value >= 1 else None
