"""Cluster state: a structure-of-arrays tensor database over the node axis.

The whole cluster is a handful of padded arrays with the node axis
outermost, so predicates and priorities evaluate as masked tensor ops over
every node at once. The irregular, string-keyed parts of matching (selector
terms, taints) are interned into small universes on the host; the device
carries membership matrices (`sel_member[n, u] = 1` iff node n's labels
satisfy term u), so (pods x nodes) matching is a one-hot product.

Host-side bookkeeping (name -> row, universe interning, label source data
for membership refills) lives in `NodeTable`. The encoders fill host numpy
arrays in the reference package's dtypes (uint32 hashes and condition
bits); `state.convert.state_from_numpy` turns them into tensors on a device.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, fields
from functools import lru_cache
from typing import Iterable

import numpy as np
import torch

from kubernetes_tpu_torch.api.objects import Node, Pod
from kubernetes_tpu_torch.api.quantity import parse_quantity
from kubernetes_tpu_torch.state.layout import (
    DEFAULT_NONZERO_CPU_MILLI,
    DEFAULT_NONZERO_MEM_MIB,
    FIRST_CUSTOM_TOPO,
    MEM_UNIT,
    TKEY_DEFAULT_UNION,
    TKEY_INVALID,
    TOPO_HOSTNAME,
    TOPO_SPREAD_ZONE,
    TOPO_ZONE_REGION,
    TOPOLOGY_KEYS,
    Capacities,
    CapacityError,
    Condition,
    Effect,
    ReqOp,
    Resource,
    TermKind,
    VolType,
)
from kubernetes_tpu_torch.utils.hashing import hash32, hash_lanes

AVOID_PODS_ANNOTATION = "scheduler.alpha.kubernetes.io/preferAvoidPods"

# ClusterState fields whose dim 0 is the node axis; the rest are universe
# attributes (small, replicated).
NODE_AXIS_FIELDS = (
    "valid", "allocatable", "requested", "nonzero_requested", "port_count",
    "sel_member", "req_member", "taint_hard_member", "taint_prefer_member",
    "conditions", "name_lo", "name_hi", "topology", "vol_any", "vol_rw",
    "attach_count", "img_size", "avoid_member", "volsel_member",
    "podsel_count", "term_count",
)


@dataclass
class ClusterState:
    """Padded cluster arrays, node axis first (same fields as the reference
    package's ClusterState). On the device: f32 matrices, bool `valid` and
    `term_poison`, int32 everything else (uint32 hashes bit-reinterpreted)."""

    valid: torch.Tensor             # bool[N] — row holds a live node
    allocatable: torch.Tensor       # f32[N, R]
    requested: torch.Tensor         # f32[N, R] — sum of requests of assigned pods
    nonzero_requested: torch.Tensor  # f32[N, 2] — (cpu, mem) with scoring defaults
    port_count: torch.Tensor        # f32[N, UP]
    sel_member: torch.Tensor        # f32[N, US] — node satisfies selector term u
    req_member: torch.Tensor        # f32[N, UR] — node satisfies requirement u
    taint_hard_member: torch.Tensor    # f32[N, UT] — NoSchedule/NoExecute taints
    taint_prefer_member: torch.Tensor  # f32[N, UT] — PreferNoSchedule taints
    taint_u_key: torch.Tensor       # i32[UT] hash32(key), 0 = empty slot
    taint_u_val_lo: torch.Tensor    # i32[UT] value hash lanes
    taint_u_val_hi: torch.Tensor    # i32[UT]
    taint_u_effect: torch.Tensor    # i32[UT] Effect codes
    conditions: torch.Tensor        # i32[N] Condition bitmask (0 == healthy)
    name_lo: torch.Tensor           # i32[N] node-name hash lanes
    name_hi: torch.Tensor           # i32[N]
    topology: torch.Tensor          # i32[N, TK] interned domain id, -1 = unknown
    vol_any: torch.Tensor           # f32[N, UV]
    vol_rw: torch.Tensor            # f32[N, UV]
    attach_count: torch.Tensor      # f32[N, UA]
    attach_type: torch.Tensor       # i32[UA]
    img_size: torch.Tensor          # f32[N, UI]
    avoid_member: torch.Tensor      # f32[N, UO] — node prefers to avoid sig u
    volsel_member: torch.Tensor     # f32[N, UVS] — node matches PV selector u
    podsel_count: torch.Tensor      # f32[N, UQ]
    term_count: torch.Tensor        # f32[N, UE]
    term_q: torch.Tensor            # i32[UE]
    term_tkey: torch.Tensor         # i32[UE]
    term_weight: torch.Tensor       # f32[UE]
    term_kind: torch.Tensor         # i32[UE]
    term_poison: torch.Tensor       # bool[UE]


STATE_FIELDS = tuple(f.name for f in fields(ClusterState))


def empty_state(caps: Capacities) -> ClusterState:
    """Host (numpy) state with every row empty."""
    n = caps.num_nodes
    return ClusterState(
        valid=np.zeros((n,), np.bool_),
        allocatable=np.zeros((n, Resource.COUNT), np.float32),
        requested=np.zeros((n, Resource.COUNT), np.float32),
        nonzero_requested=np.zeros((n, 2), np.float32),
        port_count=np.zeros((n, caps.port_universe), np.float32),
        sel_member=np.zeros((n, caps.selector_universe), np.float32),
        req_member=np.zeros((n, caps.req_universe), np.float32),
        taint_hard_member=np.zeros((n, caps.taint_universe), np.float32),
        taint_prefer_member=np.zeros((n, caps.taint_universe), np.float32),
        taint_u_key=np.zeros((caps.taint_universe,), np.uint32),
        taint_u_val_lo=np.zeros((caps.taint_universe,), np.uint32),
        taint_u_val_hi=np.zeros((caps.taint_universe,), np.uint32),
        taint_u_effect=np.zeros((caps.taint_universe,), np.int32),
        conditions=np.zeros((n,), np.uint32),
        name_lo=np.zeros((n,), np.uint32),
        name_hi=np.zeros((n,), np.uint32),
        topology=np.full((n, caps.topology_slots), -1, np.int32),
        vol_any=np.zeros((n, caps.volume_universe), np.float32),
        vol_rw=np.zeros((n, caps.volume_universe), np.float32),
        attach_count=np.zeros((n, caps.attach_universe), np.float32),
        attach_type=np.full((caps.attach_universe,), VolType.EMPTY, np.int32),
        img_size=np.zeros((n, caps.image_universe), np.float32),
        avoid_member=np.zeros((n, caps.avoid_universe), np.float32),
        volsel_member=np.zeros((n, caps.volsel_universe), np.float32),
        podsel_count=np.zeros((n, caps.podsel_universe), np.float32),
        term_count=np.zeros((n, caps.term_universe), np.float32),
        term_q=np.full((caps.term_universe,), -1, np.int32),
        term_tkey=np.zeros((caps.term_universe,), np.int32),
        term_weight=np.zeros((caps.term_universe,), np.float32),
        term_kind=np.zeros((caps.term_universe,), np.int32),
        term_poison=np.zeros((caps.term_universe,), np.bool_),
    )


def resource_rows(quantities: dict[str, str]) -> np.ndarray:
    """v1 resource map -> f32[R] in device units."""
    out = np.zeros((Resource.COUNT,), np.float32)
    for name, qty in quantities.items():
        entry = _resource_value(name, qty)
        if entry is not None:
            out[entry[0]] = entry[1]
    return out


@lru_cache(maxsize=65536)
def _resource_value(name: str, qty) -> tuple[int, float] | None:
    """(row, value in device units) of one resource quantity, None for an
    opaque resource the device does not model. Memoized: the exact
    Fraction arithmetic dominates encoding a pod, and a pod's requests are
    read twice (pod_requests, pod_nonzero_requests)."""
    entry = Resource.NAMES.get(name)
    if entry is None:
        return None
    row, kind = entry
    frac = parse_quantity(qty)
    if kind == "milli":
        return row, float(frac * 1000)
    if kind == "mem":
        return row, float(frac / MEM_UNIT)
    return row, float(frac)


def condition_mask(node: Node) -> int:
    mask = 0
    ready_seen = False
    for cond in node.status.conditions:
        if cond.type == "Ready":
            ready_seen = True
            if cond.status != "True":
                mask |= Condition.NOT_READY
        elif cond.type == "MemoryPressure" and cond.status == "True":
            mask |= Condition.MEMORY_PRESSURE
        elif cond.type == "DiskPressure" and cond.status == "True":
            mask |= Condition.DISK_PRESSURE
        elif cond.type == "NetworkUnavailable" and cond.status == "True":
            mask |= Condition.NETWORK_UNAVAILABLE
        elif cond.type == "OutOfDisk" and cond.status == "True":
            mask |= Condition.OUT_OF_DISK
    if not ready_seen and node.status.conditions:
        # conditions reported but no Ready condition: treat as not ready
        mask |= Condition.NOT_READY
    if node.spec.unschedulable:
        mask |= Condition.UNSCHEDULABLE
    return mask


_INT64_MAX = 2**63 - 1
_INT64_MIN = -(2**63)


def parse_int64(s: str) -> int | None:
    """Go strconv.ParseInt(s, 10, 64): optional sign + ASCII digits only,
    int64 range; None on failure (Gt/Lt requirements fail closed)."""
    body = s[1:] if s[:1] in "+-" else s
    if not body or not body.isascii() or not body.isdigit():
        return None
    v = int(s)
    if not (_INT64_MIN <= v <= _INT64_MAX):
        return None
    return v


def match_requirement(labels: dict[str, str], key: str, op: str,
                      values: tuple[str, ...]) -> bool:
    """One NodeSelectorRequirement against a label set
    (labels.Requirement.Matches semantics)."""
    has = key in labels
    if op == ReqOp.IN:
        return has and labels[key] in values
    if op == ReqOp.NOT_IN:
        return not has or labels[key] not in values
    if op == ReqOp.EXISTS:
        return has
    if op == ReqOp.DOES_NOT_EXIST:
        return not has
    if op in (ReqOp.GT, ReqOp.LT):
        if not has or len(values) != 1:
            return False
        lhs = parse_int64(labels[key])
        rhs = parse_int64(values[0])
        if lhs is None or rhs is None:
            return False
        return lhs > rhs if op == ReqOp.GT else lhs < rhs
    return False


def parse_avoid_signatures(annotations: dict[str, str]) -> list[tuple[str, str]]:
    """[(kind, uid)] from the node's preferAvoidPods annotation; parse
    failures yield no signatures."""
    raw = annotations.get(AVOID_PODS_ANNOTATION)
    if not raw:
        return []
    try:
        parsed = json.loads(raw)
    except ValueError:
        return []
    out = []
    for entry in (parsed or {}).get("preferAvoidPods") or []:
        ctrl = ((entry.get("podSignature") or {}).get("podController") or {})
        kind = ctrl.get("kind", "")
        uid = ctrl.get("uid", "")
        if kind and uid:
            out.append((kind, uid))
    return out


def pod_controller_ref(pod: Pod) -> tuple[str, str] | None:
    """(kind, uid) of the pod's controller owner if it is an RC or RS."""
    for ref in pod.metadata.owner_references:
        if ref.get("controller"):
            kind = ref.get("kind", "")
            if kind in ("ReplicationController", "ReplicaSet"):
                return (kind, ref.get("uid", ""))
            return None
    return None


class NodeTable:
    """Host-side index over the state: row assignment from a free list,
    universe interning (selector terms, requirements, taints, host ports,
    topology keys and domains, preferAvoidPods signatures, pod selectors,
    carried pod-affinity terms) and per-row label source data for
    membership and topology refills when a pod interns a new term or
    key."""

    def __init__(self, caps: Capacities):
        self.caps = caps
        self.row_of: dict[str, int] = {}
        self.name_of: list[str | None] = [None] * caps.num_nodes
        self.free = list(range(caps.num_nodes - 1, -1, -1))
        self.sel_terms: dict[tuple[str, str], int] = {}
        self.reqs: dict[tuple[str, str, tuple[str, ...]], int] = {}
        self.taints: dict[tuple[str, str, str], int] = {}
        self.ports: dict[int, int] = {}
        self.avoids: dict[tuple[str, str], int] = {}
        self.labels_of: list[dict[str, str] | None] = [None] * caps.num_nodes
        self.domains: list[dict] = [dict() for _ in range(caps.topology_slots)]
        self.topo_key_of: dict[str, int] = {k: i for i, k in enumerate(TOPOLOGY_KEYS)}
        # terms interned after nodes were encoded: columns awaiting refill
        self.pending_sel_refresh: list[tuple[int, str, str]] = []
        self.pending_req_refresh: list[tuple[int, str, str, tuple[str, ...]]] = []
        # pod-selector universe: (namespaces, canonical selector) -> qid
        self.podsels: dict[tuple, int] = {}
        self.podsel_attrs: list[tuple] = []          # qid -> (ns_key, canon)
        self.pending_podsel_refresh: list[int] = []  # qids awaiting pod refills
        # custom topology keys interned after nodes were encoded: slots
        # whose column awaits a refill
        self.pending_topo_refresh: list[int] = []
        # carried-term universe: (qid, tkey code, weight, kind, poison) -> eid
        self.terms: dict[tuple, int] = {}
        self.term_attrs: list[tuple] = []
        self.dirty_term_attrs = False    # term attributes not yet in the state
        # bumped when interning can invalidate encoded pod rows: a new
        # preferAvoidPods signature (rows encoded earlier lack its one-hot)
        # or a new pod-selector entry (their pod_matches_q rows may match
        # it). EncodeCache stamps its rows with it. A pod's spreading
        # entries intern while a batch is encoded, so the epoch can move
        # inside a batch: the driver then re-encodes the batch.
        self.pod_row_epoch = 0

    def assign_row(self, name: str) -> int:
        row = self.row_of.get(name)
        if row is None:
            if not self.free:
                raise CapacityError(
                    f"node capacity {self.caps.num_nodes} exhausted adding {name!r}")
            row = self.free.pop()
            self.row_of[name] = row
            self.name_of[row] = name
        return row

    def release_row(self, name: str) -> int:
        """Free a node's row. The free list is a stack, so the next
        `assign_row` reuses the row released last (the reference's order:
        the scan breaks ties by row, so reuse order is part of the
        schedule)."""
        row = self.row_of.pop(name)
        self.name_of[row] = None
        self.labels_of[row] = None
        self.free.append(row)
        return row

    def intern_sel_term(self, key: str, value: str) -> int:
        term = (key, value)
        tid = self.sel_terms.get(term)
        if tid is not None:
            return tid
        if len(self.sel_terms) >= self.caps.selector_universe:
            raise CapacityError(
                f"selector universe {self.caps.selector_universe} exhausted "
                f"interning {term!r}")
        tid = len(self.sel_terms)
        self.sel_terms[term] = tid
        self.pending_sel_refresh.append((tid, key, value))
        return tid

    def intern_requirement(self, key: str, op: str, values) -> int:
        """Values are canonicalized by sorting (In/NotIn set semantics)."""
        req = (key, op, tuple(sorted(values)))
        rid = self.reqs.get(req)
        if rid is not None:
            return rid
        if len(self.reqs) >= self.caps.req_universe:
            raise CapacityError(
                f"requirement universe {self.caps.req_universe} exhausted "
                f"interning {req!r}")
        rid = len(self.reqs)
        self.reqs[req] = rid
        self.pending_req_refresh.append((rid, *req))
        return rid

    def intern_taint(self, taint) -> int:
        key = (taint.key, taint.value, taint.effect)
        tid = self.taints.get(key)
        if tid is not None:
            return tid
        if len(self.taints) >= self.caps.taint_universe:
            raise CapacityError(
                f"taint universe {self.caps.taint_universe} exhausted "
                f"interning {key!r}")
        tid = len(self.taints)
        self.taints[key] = tid
        return tid

    def intern_port(self, port: int) -> int:
        pid = self.ports.get(port)
        if pid is not None:
            return pid
        if len(self.ports) >= self.caps.port_universe:
            raise CapacityError(
                f"port universe {self.caps.port_universe} exhausted "
                f"interning {port}")
        pid = len(self.ports)
        self.ports[port] = pid
        return pid

    def port_onehot(self, ports: Iterable[int]) -> np.ndarray:
        """f32[UP]: the pod's host ports, a port listed twice counted
        twice (the reference's layout)."""
        out = np.zeros((self.caps.port_universe,), np.float32)
        for port in ports:
            out[self.intern_port(port)] += 1.0
        return out

    @property
    def spread_zones(self) -> int:
        """Zone ids interned in the GetZoneKey slot so far: every node's
        id there is below it (or -1). Ids are never released, so it only
        grows, and it is at most the domain universe."""
        return len(self.domains[TOPO_SPREAD_ZONE])

    def intern_domain(self, key_idx: int, value) -> int:
        table = self.domains[key_idx]
        did = table.get(value)
        if did is None:
            did = len(table)
            # hostname-slot domains are per node (unbounded by design)
            if key_idx != TOPO_HOSTNAME and did >= self.caps.domain_universe:
                raise CapacityError(
                    f"domain universe {self.caps.domain_universe} exhausted "
                    f"for topology slot {key_idx} interning {value!r}")
            table[value] = did
        return did

    def intern_topo_key(self, key: str) -> int:
        """The topology slot of an affinity term's key; a new custom key
        takes the next slot from FIRST_CUSTOM_TOPO and queues a refill of
        its column."""
        slot = self.topo_key_of.get(key)
        if slot is not None:
            return slot
        slot = max(max(self.topo_key_of.values()) + 1, FIRST_CUSTOM_TOPO)
        if slot >= self.caps.topology_slots:
            raise CapacityError(
                f"topology slots {self.caps.topology_slots} exhausted "
                f"interning key {key!r}")
        self.topo_key_of[key] = slot
        self.pending_topo_refresh.append(slot)
        return slot

    def tkey_code(self, key: str, *, required: bool) -> int:
        """A term's topologyKey as a device code: a topology slot, or
        TKEY_INVALID (an empty key on a required term fails everywhere; a
        preferred term's key past the slots scores nothing), or
        TKEY_DEFAULT_UNION (an empty key on a preferred term matches any
        default failure domain)."""
        if not key:
            return TKEY_INVALID if required else TKEY_DEFAULT_UNION
        try:
            return self.intern_topo_key(key)
        except CapacityError:
            if required:
                raise
            return TKEY_INVALID

    def intern_term(self, qid: int, tkey_code: int, weight: float, kind: int,
                    poison: bool) -> int:
        entry = (qid, tkey_code, float(weight), int(kind), bool(poison))
        eid = self.terms.get(entry)
        if eid is not None:
            return eid
        if len(self.terms) >= self.caps.term_universe:
            raise CapacityError(
                f"carried-term universe {self.caps.term_universe} exhausted")
        eid = len(self.terms)
        self.terms[entry] = eid
        self.term_attrs.append(entry)
        self.dirty_term_attrs = True
        return eid

    def intern_avoid(self, sig: tuple[str, str]) -> int:
        oid = self.avoids.get(sig)
        if oid is not None:
            return oid
        if len(self.avoids) >= self.caps.avoid_universe:
            raise CapacityError(
                f"avoid universe {self.caps.avoid_universe} exhausted "
                f"interning {sig!r}")
        oid = len(self.avoids)
        self.avoids[sig] = oid
        self.pod_row_epoch += 1
        return oid

    def intern_podsel(self, ns_key: frozenset, canon) -> int:
        entry = (ns_key, canon)
        qid = self.podsels.get(entry)
        if qid is not None:
            return qid
        if len(self.podsels) >= self.caps.podsel_universe:
            raise CapacityError(
                f"pod-selector universe {self.caps.podsel_universe} exhausted")
        qid = len(self.podsels)
        self.podsels[entry] = qid
        self.podsel_attrs.append(entry)
        self.pending_podsel_refresh.append(qid)
        self.pod_row_epoch += 1
        return qid


def fill_node_row(state: ClusterState, table: NodeTable, row: int,
                  node: Node) -> None:
    """Encode one node into host row `row` (every field the reference
    encoder fills that this package's solver reads)."""
    state.valid[row] = True
    state.allocatable[row] = resource_rows(node.status.effective_allocatable())
    state.conditions[row] = condition_mask(node)
    state.name_lo[row], state.name_hi[row] = hash_lanes(node.metadata.name)

    labels = dict(node.metadata.labels)
    table.labels_of[row] = labels
    state.sel_member[row] = 0.0
    for (k, v), tid in table.sel_terms.items():
        if labels.get(k) == v:
            state.sel_member[row, tid] = 1.0
    state.req_member[row] = 0.0
    for (k, op, values), rid in table.reqs.items():
        if match_requirement(labels, k, op, values):
            state.req_member[row, rid] = 1.0

    state.taint_hard_member[row] = 0.0
    state.taint_prefer_member[row] = 0.0
    for t in node.spec.taints:
        tid = table.intern_taint(t)
        state.taint_u_key[tid] = hash32(t.key)
        state.taint_u_val_lo[tid], state.taint_u_val_hi[tid] = hash_lanes(t.value)
        effect = Effect.NAMES.get(t.effect, Effect.NONE)
        state.taint_u_effect[tid] = effect
        if effect in (Effect.NO_SCHEDULE, Effect.NO_EXECUTE):
            state.taint_hard_member[row, tid] = 1.0
        elif effect == Effect.PREFER_NO_SCHEDULE:
            state.taint_prefer_member[row, tid] = 1.0

    state.avoid_member[row] = 0.0
    for sig in parse_avoid_signatures(node.metadata.annotations):
        state.avoid_member[row, table.intern_avoid(sig)] = 1.0

    state.topology[row] = -1
    for key, slot in table.topo_key_of.items():
        val = labels.get(key)
        if slot == TOPO_HOSTNAME and val is None:
            val = node.metadata.name  # hostname domain defaults to node name
        if val is not None:
            state.topology[row, slot] = table.intern_domain(slot, val)
    z = labels.get(TOPOLOGY_KEYS[1])
    r = labels.get(TOPOLOGY_KEYS[2])
    if z is not None and r is not None:
        state.topology[row, TOPO_ZONE_REGION] = table.intern_domain(
            TOPO_ZONE_REGION, (z, r))
    if z is not None or r is not None:
        state.topology[row, TOPO_SPREAD_ZONE] = table.intern_domain(
            TOPO_SPREAD_ZONE, (r or "", z or ""))


def apply_pending_refreshes(state: ClusterState, table: NodeTable) -> list[int]:
    """Fill membership columns for selector terms / requirements, and
    topology columns for custom keys, interned after nodes were encoded,
    and write the carried-term attributes (term_q, term_tkey, term_weight,
    term_kind, term_poison) when terms were interned. Returns the node rows
    that changed (the device mirror re-uploads just those rows)."""
    rows: set[int] = set()
    for term_id, key, value in table.pending_sel_refresh:
        for row, labels in enumerate(table.labels_of):
            if labels is not None and labels.get(key) == value:
                state.sel_member[row, term_id] = 1.0
                rows.add(row)
    table.pending_sel_refresh.clear()
    for rid, key, op, values in table.pending_req_refresh:
        for row, labels in enumerate(table.labels_of):
            if labels is not None and match_requirement(labels, key, op, values):
                state.req_member[row, rid] = 1.0
                rows.add(row)
    table.pending_req_refresh.clear()
    if table.pending_topo_refresh:
        slot_key = {s: k for k, s in table.topo_key_of.items()}
        for slot in table.pending_topo_refresh:
            key = slot_key[slot]
            for row, labels in enumerate(table.labels_of):
                if labels is not None and key in labels:
                    state.topology[row, slot] = table.intern_domain(
                        slot, labels[key])
                    rows.add(row)
        table.pending_topo_refresh.clear()
    if table.dirty_term_attrs:
        for eid, (qid, tk, w, kind, poison) in enumerate(table.term_attrs):
            state.term_q[eid] = qid
            state.term_tkey[eid] = tk
            state.term_weight[eid] = w
            state.term_kind[eid] = kind
            state.term_poison[eid] = poison
        table.dirty_term_attrs = False
    return sorted(rows)


def fill_match_row(out: np.ndarray, table: NodeTable, pod: Pod) -> None:
    """Write into `out` f32[UQ] which pod-selector-universe entries this pod
    matches (PodMatchesTermsNamespaceAndSelector against every interned
    entry)."""
    out[:] = 0.0
    if table.podsel_attrs:
        from kubernetes_tpu_torch.state.podaffinity import pod_matches_entry

        for qid, (ns_key, canon) in enumerate(table.podsel_attrs):
            if pod_matches_entry(pod, ns_key, canon):
                out[qid] = 1.0


def pod_match_row(table: NodeTable, pod: Pod) -> np.ndarray:
    """f32[UQ]: `fill_match_row` into a new row."""
    out = np.empty((table.caps.podsel_universe,), np.float32)
    fill_match_row(out, table, pod)
    return out


def intern_pod_affinity_terms(table: NodeTable, pod: Pod):
    """Intern every pod-affinity term a pod carries into the pod-selector
    and carried-term universes. Returns (carried eids, parsed terms)."""
    from kubernetes_tpu_torch.state.podaffinity import PARSE_ERROR, parse_pod_affinity

    terms = parse_pod_affinity(pod.spec.affinity, pod.metadata.namespace)
    eids: list[int] = []
    for kind, lst, required in (
        (TermKind.ANTI_REQ, terms.anti_req, True),
        (TermKind.AFF_REQ, terms.aff_req, True),
        (TermKind.AFF_PREF, terms.aff_pref, False),
        (TermKind.ANTI_PREF, terms.anti_pref, False),
    ):
        for t in lst:
            qid = table.intern_podsel(t.namespaces, t.selector)
            tk = table.tkey_code(t.topology_key, required=required)
            if kind == TermKind.AFF_PREF:
                w = float(t.weight)
            elif kind == TermKind.ANTI_PREF:
                w = -float(t.weight)
            else:
                w = 0.0
            # a required anti term whose selector cannot be parsed rejects
            # every incoming pod while a carrier exists
            poison = kind == TermKind.ANTI_REQ and t.selector == PARSE_ERROR
            eids.append(table.intern_term(qid, tk, w, kind, poison))
    return eids, terms


def carried_term_row(table: NodeTable, eids) -> np.ndarray:
    """f32[UE]: a pod's carried-term multiplicities."""
    out = np.zeros((table.caps.term_universe,), np.float32)
    for e in eids:
        out[e] += 1.0
    return out


def pod_requests(pod: Pod) -> np.ndarray:
    """Sum of container requests in device units, +1 pod slot."""
    out = np.zeros((Resource.COUNT,), np.float32)
    for c in pod.spec.containers:
        out += resource_rows(c.requests)
    out[Resource.PODS] = 1.0
    return out


def pod_nonzero_requests(pod: Pod) -> np.ndarray:
    """(cpu_milli, mem_mib) with per-container defaults for scoring."""
    cpu = 0.0
    mem = 0.0
    for c in pod.spec.containers:
        c_rows = resource_rows(c.requests)
        cpu += c_rows[Resource.CPU] if c_rows[Resource.CPU] > 0 else DEFAULT_NONZERO_CPU_MILLI
        mem += c_rows[Resource.MEMORY] if c_rows[Resource.MEMORY] > 0 else DEFAULT_NONZERO_MEM_MIB
    return np.array([cpu, mem], np.float32)


def encode_nodes(nodes: Iterable[Node], caps: Capacities,
                 table: NodeTable | None = None
                 ) -> tuple[ClusterState, NodeTable]:
    """Full host encode of a node list. Pass an existing `table` to keep
    universe ids stable (pods encoded earlier stay valid)."""
    state = empty_state(caps)
    table = table or NodeTable(caps)
    for node in nodes:
        fill_node_row(state, table, table.assign_row(node.metadata.name), node)
    return state, table
