"""Scheduler: the batch driver of the main path, without an apiserver.

`add_nodes` registers nodes in the StateDB; `schedule(pods)` places the
pods in `caps.batch_pods` chunks. Each chunk is encoded through the
EncodeCache into one reused pair of host blobs (the unused tail rows reset
to the padding row), its gates are read from those blobs, the blobs are
uploaded and sliced back into a PodBatch on the device, solved, read back,
and committed to the StateDB from the f32 blob (`batches` gives the
chunks, `prepare_chunk` one chunk's solver operands). The round-robin counter
chains from batch to batch, so a sequence of `schedule` calls makes the
decisions one long serial schedule would. `add_pod`, `remove_pod` and
`remove_node` keep the StateDB in step for pods bound and deleted, and
nodes dropped, outside `schedule`. Host ports are accounted like requests:
a bound pod's ports through `add_pod`, a placed pod's from its batch row
at commit, and a batch with a host-port, GPU, scratch or overlay request
runs the scan's EXT variant (the main or gang build), whose host-port
counts the StateDB adopts. Volumes too: `add_pv`, `add_pvc` and their
removals keep the PVs and claims a pod's claim-backed volumes resolve
through, for the encoder and for the StateDB's accounting of bound pods
(`local_volumes_enabled` turns on NoVolumeNodeConflict's feature gate, as
the reference's PersistentLocalVolumes); a batch whose pods mount disks or
attachable volumes runs the EXT variant too, whose conflict and attach
counts the StateDB adopts, and VolumeZone and VolumeNode hold in Phase A.
The policy's attach limits take KUBE_MAX_PD_VOLS (`with_env_overrides`),
read when the Scheduler is made.

SelectorSpread reads the workload objects: `add_service`,
`remove_service`, `add_controller` and `remove_controller` keep in-memory
listers by namespace behind the encoder's EncodeContext, whose pod lister
is the StateDB's bound pods; each call bumps the encode cache's
`generation`, so no row encoded against the old objects is served. A pod's
spreading entries and pod-affinity terms intern into the pod-selector
universe while a chunk is encoded, which moves `pod_row_epoch`: the chunk
is then encoded again against the final universe, so earlier rows gain
the new match columns (a carried term interned on the way changes no
earlier row: a pod's carried-term row holds its own terms only). Bound
pods with pod-affinity terms are accounted through `add_pod` like any
other.

Gang members (pods with the group-name annotation) are batched by group,
as the reference driver admits them (kubernetes_tpu/scheduler/driver.py
`_admit_gang`): a group's quorum is its PodGroup's minMember
(`add_pod_group`), else the largest group-min annotation on a member,
else 1. A group of at least its quorum enters one batch whole, its members
sorted by key, where its quorum-th member stands in the given order (where
the reference's queue receives the group); if it does not fit the batch
being filled, that batch is closed and the group opens the next one. Each
group gets a batch-local id, written into the blobs after encoding, and
the solver settles it all or nothing: every member of a reverted group
comes back None and nothing of it is committed. A batch of groups that
also needs SelectorSpread or inter-pod affinity (a Service selects its
pods, or any accounted pod carries a pod-affinity term) is settled in the
build those gates pick, and the StateDB adopts the pod-selector and
carried-term ledgers the scan gave back with the group. A group larger than a
batch, or below its quorum, is released: its members are scheduled
individually where they stand (the reference's treatment after its
quorum timeout; a call is given all the pods there are, so a group below
quorum counts one timeout). `gang_placed`, `gang_reverted` and
`gang_timeouts` count groups.

Pods with a priority raise the solver's preempt gate. With
`enable_preemption` (the default) such a chunk is solved with a
VictimTable built from the StateDB (preemption.build_victim_table: the
`evictable` callable stands in for the PodDisruptionBudget check), and the
pass's verdicts for the pods left unplaced are resolved into victim pod
keys: `preemptions` maps each such pod's key to (node name, victim keys)
for the last `schedule` call, with one set of claimed victims across the
call (a later chunk's table leaves them out). A gang group that did not
reach its quorum is all or nothing, as the reference driver's
(kubernetes_tpu/scheduler/driver.py `_apply_batch`): its verdicts are
resolved only when every unplaced member has one. The driver evicts
nothing: removing the victims stays the caller's `remove_pod`, after which
the preemptors schedule again. Eviction through an apiserver, nominated
node holds and the rebind, like watching an apiserver and binding, are
host-plane work for a later slice of the port.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from kubernetes_tpu_torch.api.objects import (
    Node,
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
    PodGroup,
    ReplicaSet,
    ReplicationController,
    Service,
    StatefulSet,
)
from kubernetes_tpu_torch.gang import (
    GROUP_NAME_ANNOTATION,
    annotation_min,
    pod_group_key,
)
from kubernetes_tpu_torch.models.policy import DEFAULT_POLICY, Policy
from kubernetes_tpu_torch.ops.solver import schedule_batch
from kubernetes_tpu_torch.preemption import build_victim_table, resolve_victims
from kubernetes_tpu_torch.state.context import EncodeContext
from kubernetes_tpu_torch.state.convert import (
    host_blobs,
    upload_blobs,
    victims_from_numpy,
)
from kubernetes_tpu_torch.state.encode_cache import EncodeCache
from kubernetes_tpu_torch.state.layout import Capacities
from kubernetes_tpu_torch.state.pod_batch import (
    blob_widths,
    packed_batch_flags,
    padding_row,
    unpack_batch,
    write_gang_columns,
)
from kubernetes_tpu_torch.state.statedb import StateDB

_WORKLOAD_KINDS = (Service, ReplicationController, ReplicaSet, StatefulSet)
_NONE: dict = {}   # a namespace without objects of a kind (never written)


class Scheduler:
    def __init__(self, caps: Capacities | None = None,
                 policy: Policy = DEFAULT_POLICY, device=None,
                 enable_preemption: bool = True, evictable=None,
                 local_volumes_enabled: bool = False):
        self.caps = caps or Capacities()
        self.policy = policy.with_env_overrides()   # KUBE_MAX_PD_VOLS
        self.enable_preemption = enable_preemption
        self.evictable = evictable   # pod -> bool, the PDB check's stand-in
        # pod key -> (node name, victim pod keys) of the last schedule call
        self.preemptions: dict[str, tuple[str, list[str]]] = {}
        self._claimed: set[str] = set()   # victims named in this call
        self.statedb = StateDB(self.caps, device)
        self.device = self.statedb.device
        # kind -> namespace -> name -> object
        self._workloads: dict[type, dict[str, dict[str, object]]] = {
            kind: {} for kind in _WORKLOAD_KINDS}
        self._pvs: dict[str, PersistentVolume] = {}
        self._pvcs: dict[tuple[str, str], PersistentVolumeClaim] = {}

        def lister(kind):
            return lambda ns: self._workloads[kind].get(ns, _NONE).values()

        ctx = EncodeContext(
            get_pvc=lambda ns, name: self._pvcs.get((ns, name)),
            get_pv=self._pvs.get,
            local_volumes_enabled=local_volumes_enabled,
            get_services=lister(Service),
            get_rcs=lister(ReplicationController),
            get_rss=lister(ReplicaSet), get_sss=lister(StatefulSet),
            list_pods=self.statedb.bound_pods)
        self.statedb.ctx = ctx   # a bound pod's claims resolve through it
        self.encode_cache = EncodeCache(self.caps, self.statedb.table, ctx)
        f_width, i_width = blob_widths(self.caps)
        # one host pair, reused by every batch: written only after the
        # previous batch's readback has synchronized the upload's stream
        self._blobs = host_blobs(self.caps.batch_pods, f_width, i_width,
                                 self.device)
        self._host_blobs = (self._blobs[0].numpy(), self._blobs[1].numpy())
        self.rr = 0  # round-robin counter: an int, then the device's i64 scalar
        self.last_result = None  # SolverResult of the latest batch
        self.pod_groups: dict[str, int] = {}   # group key -> minMember
        # groups placed (at least their quorum), reverted by the solver, and
        # released below their quorum
        self.gang_placed = 0
        self.gang_reverted = 0
        self.gang_timeouts = 0
        # per batch: host seconds to encode + upload, and to solve through
        # to the assignments on the host
        self.encode_seconds: list[float] = []
        self.solve_seconds: list[float] = []

    def add_nodes(self, nodes: Sequence[Node]) -> None:
        for node in nodes:
            self.statedb.upsert_node(node)

    def remove_node(self, name: str) -> None:
        self.statedb.remove_node(name)

    def add_pod(self, pod: Pod, node_name: str | None = None) -> bool:
        """Account a pod bound outside `schedule` (StateDB.add_pod)."""
        return self.statedb.add_pod(pod, node_name)

    def remove_pod(self, pod_key: str) -> None:
        """Forget a deleted pod: its requests leave its node's row."""
        self.statedb.remove_pod(pod_key)

    def add_pv(self, pv: PersistentVolume) -> None:
        """Add (or replace) a PersistentVolume. A pod's claims resolve when
        it is encoded or accounted: pods with claim-backed volumes are never
        served from the encode cache."""
        self._pvs[pv.metadata.name] = pv

    def remove_pv(self, pv: PersistentVolume) -> None:
        self._pvs.pop(pv.metadata.name, None)

    def add_pvc(self, pvc: PersistentVolumeClaim) -> None:
        """Add (or replace) a PersistentVolumeClaim."""
        self._pvcs[(pvc.metadata.namespace, pvc.metadata.name)] = pvc

    def remove_pvc(self, pvc: PersistentVolumeClaim) -> None:
        self._pvcs.pop((pvc.metadata.namespace, pvc.metadata.name), None)

    def add_service(self, service: Service) -> None:
        self._put_workload(service, True)

    def remove_service(self, service: Service) -> None:
        self._put_workload(service, False)

    def add_controller(self, controller) -> None:
        """Add (or replace) a ReplicationController, ReplicaSet or
        StatefulSet."""
        self._put_workload(controller, True)

    def remove_controller(self, controller) -> None:
        self._put_workload(controller, False)

    def add_pod_group(self, group: PodGroup) -> None:
        """Add (or replace) a PodGroup: its minMember is the quorum of the
        pods annotated with its name in its namespace."""
        self.pod_groups[group.key] = max(1, group.min_member)

    def remove_pod_group(self, group: PodGroup) -> None:
        self.pod_groups.pop(group.key, None)

    def _put_workload(self, obj, present: bool) -> None:
        if type(obj) not in _WORKLOAD_KINDS:
            raise TypeError(f"not a Service or controller: {type(obj).__name__}")
        by_name = self._workloads[type(obj)].setdefault(obj.metadata.namespace, {})
        if present:
            by_name[obj.metadata.name] = obj
        else:
            by_name.pop(obj.metadata.name, None)
        # cached rows carry spreading entries of the old objects
        self.encode_cache.generation += 1

    def schedule(self, pods: Sequence[Pod]) -> dict[str, str | None]:
        """Place `pods` in order, gang groups whole. Returns {pod key: node
        name, or None when no node fits or the pod's group was reverted}."""
        out: dict[str, str | None] = {}
        self.preemptions = {}
        self._claimed = set()
        for chunk, gang_id, gang_min in self.batches(pods):
            out.update(self._schedule_chunk(chunk, gang_id, gang_min))
        return out

    def batches(self, pods: Sequence[Pod]):
        """(pods, gang_id, gang_min) of each batch `schedule(pods)` solves,
        in order (gang_id and gang_min None for a call without groups)."""
        step = self.caps.batch_pods
        if any(GROUP_NAME_ANNOTATION in pod.metadata.annotations for pod in pods):
            return self._gang_batches(pods)
        # no group: fixed slices, without a pass over each pod
        return ((pods[start:start + step], None, None)
                for start in range(0, len(pods), step))

    def _gang_quorum(self, gkey: str, members: Sequence[Pod]) -> int:
        """The PodGroup's minMember, else the largest group-min annotation
        on a member, else 1."""
        if gkey in self.pod_groups:
            return self.pod_groups[gkey]
        hints = [m for m in map(annotation_min, members) if m is not None]
        return max([1, *hints])

    def _gang_batches(self, pods: Sequence[Pod]):
        """(pods, gang_id, gang_min) of each batch: groups whole at their
        quorum-th member, released groups' members where they stand."""
        step = self.caps.batch_pods
        groups: dict[str, list[Pod]] = {}
        for pod in pods:
            gkey = pod_group_key(pod)
            if gkey is not None:
                groups.setdefault(gkey, []).append(pod)
        # group key -> (quorum, members sorted by key) for the groups
        # admitted whole
        admitted = {}
        for gkey, members in groups.items():
            quorum = self._gang_quorum(gkey, members)
            if len(members) < quorum:
                self.gang_timeouts += 1
            elif len(members) <= step:
                admitted[gkey] = (quorum, sorted(members, key=lambda m: m.key))
        chunk: list[Pod] = []
        gang_id: list[int] = []
        gang_min: list[int] = []
        n_groups = 0   # groups in the chunk: the next one's id is n_groups + 1
        seen: dict[str, int] = {}
        for pod in pods:
            gkey = pod_group_key(pod)
            if gkey not in admitted:
                unit, quorum = [pod], 0
            else:
                seen[gkey] = seen.get(gkey, 0) + 1
                quorum, unit = admitted[gkey]
                if seen[gkey] != quorum:
                    continue   # the group enters at its quorum-th member
            if len(chunk) + len(unit) > step:
                yield chunk, gang_id, gang_min
                chunk, gang_id, gang_min, n_groups = [], [], [], 0
            n_groups += bool(quorum)
            seq = n_groups if quorum else 0
            chunk.extend(unit)
            gang_id.extend([seq] * len(unit))
            gang_min.extend([quorum] * len(unit))
        if chunk:
            yield chunk, gang_id, gang_min

    def prepare_chunk(self, pods: Sequence[Pod], gang_id=None, gang_min=None,
                      claimed=frozenset()) -> tuple:
        """(state, batch, flags, victims, slots): one batch's solver operands
        as `schedule` makes them. The pods are encoded through the cache
        into the reused host blobs, the gates read from the blobs, the
        VictimTable built from the StateDB when the preempt gate is up
        (without the `claimed` pod keys; victims and slots None otherwise),
        the StateDB flushed and the blobs uploaded and sliced."""
        fblob, iblob = self._host_blobs
        n = len(pods)
        table = self.statedb.table
        epoch = table.pod_row_epoch
        encode = self.encode_cache.encode_packed_into
        for i, pod in enumerate(pods):
            encode(fblob, iblob, i, pod)
        if table.pod_row_epoch != epoch:
            # a pod interned a pod-selector entry (a spreading entry or an
            # affinity term's selector): rows encoded before it
            # lack its match column. Encode every row again against the
            # final universe (the epoch is in the cache key, so no stale
            # row is served, and nothing new is interned this time)
            for i, pod in enumerate(pods):
                encode(fblob, iblob, i, pod)
        if n < self.caps.batch_pods:
            # a reused blob's tail must read as padding, not as the
            # previous batch's pods (zeros would be live ids: -1 = unused)
            fblob[n:], iblob[n:] = padding_row(self.caps)
        if gang_id is not None:
            # after every encode: a class row carries no batch-local group
            write_gang_columns(fblob, iblob, gang_id, gang_min, self.caps)
        flags = packed_batch_flags(fblob, iblob, n, table, self.caps)
        victims = slots = None
        if self.enable_preemption and flags.preempt:
            host, slots = build_victim_table(self.statedb, evictable=self.evictable,
                                             exclude=claimed)
            if host is not None:
                victims = victims_from_numpy(host, self.device)
        state = self.statedb.flush()
        batch = unpack_batch(*upload_blobs(*self._blobs, self.device), self.caps)
        return state, batch, flags, victims, slots

    def _schedule_chunk(self, pods: Sequence[Pod], gang_id=None,
                        gang_min=None) -> dict[str, str | None]:
        t0 = time.perf_counter()
        n = len(pods)
        table = self.statedb.table
        state, batch, flags, victims, slots = self.prepare_chunk(
            pods, gang_id, gang_min, self._claimed)
        t1 = time.perf_counter()
        result = schedule_batch(state, batch, self.rr, self.policy, flags,
                                self.caps, spread_zones=table.spread_zones,
                                victims=victims)
        if victims is None:
            assignments = result.assignments.cpu().numpy()
        else:   # the verdicts ride the same readback
            assignments, pnode, pcount = torch.stack(
                (result.assignments, result.preempt_node,
                 result.victim_count)).cpu().numpy()
        t2 = time.perf_counter()
        name_of = self.statedb.table.name_of
        placed = [name_of[row] if row >= 0 else None
                  for row in assignments[:n].tolist()]
        hit = np.flatnonzero(assignments[:n] >= 0).tolist()
        self.statedb.commit_batch(result, self._host_blobs[0], zip(
            map(pods.__getitem__, hit), map(placed.__getitem__, hit), hit))
        self.rr = result.rr_end
        self.last_result = result
        if result.gang_placed is not None:
            placed_groups, reverted_groups = torch.stack(
                (result.gang_placed, result.gang_reverted)).tolist()
            self.gang_placed += placed_groups
            self.gang_reverted += reverted_groups
        if victims is not None:
            self._resolve_preemptions(pods, assignments[:n], pnode[:n],
                                      pcount[:n], slots, gang_id, gang_min)
        self.encode_seconds.append(t1 - t0)
        self.solve_seconds.append(t2 - t1)
        return dict(zip((pod.key for pod in pods), placed))

    def _resolve_preemptions(self, pods, rows, pnode, pcount, slots, gang_id,
                             gang_min) -> None:
        """Turn a chunk's verdicts into `preemptions` entries: a group below
        its quorum only when every unplaced member has a verdict (members
        resolved in order until one cannot be), then every other unplaced
        pod with a verdict."""
        name_of = self.statedb.table.name_of

        def resolve(i: int) -> bool:
            node = name_of[int(pnode[i])]
            if node is None:
                return False   # the node left since the solve
            keys = resolve_victims(slots, int(pnode[i]), int(pcount[i]),
                                   int(pods[i].spec.priority), self._claimed)
            if keys is None:
                return False
            self.preemptions[pods[i].key] = (node, keys)
            return True

        handled: set[int] = set()
        if gang_id is not None:
            start = 0
            while start < len(pods):
                gid, end = gang_id[start], start + 1
                while end < len(pods) and gang_id[end] == gid:
                    end += 1
                members = range(start, end)
                start = end
                if gid <= 0 or sum(rows[i] >= 0 for i in members) >= gang_min[members[0]]:
                    continue   # no group, or placed: stragglers go one by one
                handled.update(members)
                unplaced = [i for i in members if rows[i] < 0]
                if unplaced and all(pnode[i] >= 0 for i in unplaced):
                    for i in unplaced:
                        if not resolve(i):
                            break
        for i in np.flatnonzero((rows < 0) & (pnode >= 0)).tolist():
            if i not in handled:
                resolve(i)
