"""Pending-pod batch encoding: P pods -> padded arrays for one solver call.

Padding rows have valid=False and are never assigned. Selector terms and
node-affinity requirements intern into the cluster's universes
(cluster_state.NodeTable), producing one-hot rows that pair with the node
membership matrices, so encoding a pod can grow a universe: the state's
membership columns must be refilled (StateDB.flush) before the batch is
solved.

This package's solver covers the scheduler's main path, SelectorSpread,
inter-pod (anti-)affinity, gang groups, pod priority (the `priority`
column, which gates the preemption pass), host ports (`port_onehot`, the
pod's ports interned into the NodeTable's port universe) and gpu and
storage requests. The encoder rejects, with NotImplementedError, pods
whose features would change the result outside it (volumes). The
spreading columns (spread_q, spread_svc_q, svcanti_q, svcanti_total) are
read from the pod's namespace and labels and
the workload objects of an EncodeContext, and the inter-pod columns
(paff_*, panti_*, ppref_*, ipaff_fail, pod_carries_e) from its
podAffinity and podAntiAffinity, as the reference encodes them. A pod's
selectors and terms intern into the pod-selector and carried-term
universes, so encoding can grow them, and the match rows (pod_matches_q)
of rows encoded before a selector was interned miss its column
(`fill_batch_affinity`, and the driver's re-encode). Container images are
accepted and left unencoded (ImageLocality is not carried).

The driver moves a batch as two blobs (`pack_batch`, `pack_row`): one
f32[P, F] holding every float field's columns and one i32[P, I] holding
the integer fields, the uint32 hash lanes bitcast and the bools as 0/1, in
the reference package's column layout. `unpack_batch` slices them back into
a PodBatch on the device, and `packed_batch_flags` reads the batch gates
from the host blobs. `PackedRow` lets the encoder write one packed row in
place (the encode cache's miss path). The encoder leaves the gang columns
(gang_id, gang_min) zero, as the reference encoder does: a group id is
local to one batch, so the driver writes them into the blobs after
encoding (`write_gang_columns`).
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Sequence

import numpy as np
import torch

from kubernetes_tpu_torch.api.objects import Pod, parse_node_affinity
from kubernetes_tpu_torch.state.cluster_state import (
    ClusterState,
    NodeTable,
    apply_pending_refreshes,
    carried_term_row,
    encode_nodes,
    fill_match_row,
    intern_pod_affinity_terms,
    pod_controller_ref,
    pod_nonzero_requests,
    pod_requests,
)
from kubernetes_tpu_torch.state.context import EMPTY_CONTEXT, EncodeContext
from kubernetes_tpu_torch.state.layout import (
    TKEY_INVALID,
    Capacities,
    CapacityError,
    Effect,
    ReqOp,
    TolOp,
)
from kubernetes_tpu_torch.utils.hashing import hash32, hash_lanes

@dataclass
class PodBatch:
    """Padded batch arrays, pod axis first (same fields as the reference
    package's PodBatch)."""

    valid: torch.Tensor           # bool[P]
    requests: torch.Tensor        # f32[P, R]
    nonzero_requests: torch.Tensor  # f32[P, 2] (cpu, mem) scoring requests
    port_onehot: torch.Tensor     # f32[P, UP]
    sel_onehot: torch.Tensor      # f32[P, US] — required selector terms
    sel_count: torch.Tensor       # f32[P] — number of required terms
    tol_key: torch.Tensor         # i32[P, T] hash32(key), 0 = empty key (matches all)
    tol_val_lo: torch.Tensor      # i32[P, T] hash lanes of the toleration value
    tol_val_hi: torch.Tensor      # i32[P, T]
    tol_op: torch.Tensor          # i32[P, T] TolOp codes, NONE = unused slot
    tol_effect: torch.Tensor      # i32[P, T] Effect codes, NONE = all effects
    node_name_lo: torch.Tensor    # i32[P] spec.nodeName hash lanes, 0 = unset
    node_name_hi: torch.Tensor    # i32[P]
    best_effort: torch.Tensor     # bool[P] BestEffort QoS
    naff_has: torch.Tensor        # bool[P] — pod carries a required NodeSelector
    naff_onehot: torch.Tensor     # f32[P, AT, UR]
    naff_count: torch.Tensor      # f32[P, AT] — requirements in term t
    naff_ok: torch.Tensor         # bool[P, AT] — term is live (non-empty, parsed)
    pref_onehot: torch.Tensor     # f32[P, TP, UR]
    pref_count: torch.Tensor      # f32[P, TP]
    pref_weight: torch.Tensor     # f32[P, TP] — 0 for unused/invalid slots
    pod_matches_q: torch.Tensor   # f32[P, UQ]
    pod_carries_e: torch.Tensor   # f32[P, UE]
    paff_q: torch.Tensor          # i32[P, IA] -1 unused
    paff_tkey: torch.Tensor       # i32[P, IA]
    panti_q: torch.Tensor         # i32[P, IA]
    panti_tkey: torch.Tensor      # i32[P, IA]
    ipaff_fail: torch.Tensor      # bool[P]
    ppref_q: torch.Tensor         # i32[P, IP]
    ppref_tkey: torch.Tensor      # i32[P, IP]
    ppref_w: torch.Tensor         # f32[P, IP]
    vol_want_rw: torch.Tensor     # f32[P, UV]
    vol_want_ro: torch.Tensor     # f32[P, UV]
    att_onehot: torch.Tensor      # f32[P, UA]
    att_fail: torch.Tensor        # bool[P]
    vz_onehot: torch.Tensor       # f32[P, US] zone/region selector terms from PVs
    vz_count: torch.Tensor        # f32[P]
    vz_fail: torch.Tensor         # bool[P]
    vs_onehot: torch.Tensor       # f32[P, UVS] PV node-affinity selectors
    vs_count: torch.Tensor        # f32[P]
    vs_fail: torch.Tensor         # bool[P]
    spread_q: torch.Tensor        # i32[P] -1 none
    spread_svc_q: torch.Tensor    # i32[P]
    svcanti_q: torch.Tensor       # i32[P]
    svcanti_total: torch.Tensor   # f32[P]
    svcaff_onehot: torch.Tensor   # f32[P, UR]
    svcaff_count: torch.Tensor    # f32[P]
    svcaff_fail: torch.Tensor     # bool[P]
    img_onehot: torch.Tensor      # f32[P, UI]
    avoid_onehot: torch.Tensor    # f32[P, UO] controllerRef signature, if interned
    gang_id: torch.Tensor         # i32[P] 0 = none
    gang_min: torch.Tensor        # i32[P]
    priority: torch.Tensor        # i32[P]


BATCH_FIELDS = tuple(f.name for f in fields(PodBatch))


def empty_batch(caps: Capacities) -> PodBatch:
    """Host (numpy) batch with every row padding."""
    p = caps.batch_pods
    f32 = np.float32
    return PodBatch(
        valid=np.zeros((p,), np.bool_),
        requests=np.zeros((p, 6), f32),
        nonzero_requests=np.zeros((p, 2), f32),
        port_onehot=np.zeros((p, caps.port_universe), f32),
        sel_onehot=np.zeros((p, caps.selector_universe), f32),
        sel_count=np.zeros((p,), f32),
        tol_key=np.zeros((p, caps.toleration_slots), np.uint32),
        tol_val_lo=np.zeros((p, caps.toleration_slots), np.uint32),
        tol_val_hi=np.zeros((p, caps.toleration_slots), np.uint32),
        tol_op=np.zeros((p, caps.toleration_slots), np.int32),
        tol_effect=np.zeros((p, caps.toleration_slots), np.int32),
        node_name_lo=np.zeros((p,), np.uint32),
        node_name_hi=np.zeros((p,), np.uint32),
        best_effort=np.zeros((p,), np.bool_),
        naff_has=np.zeros((p,), np.bool_),
        naff_onehot=np.zeros((p, caps.affinity_terms, caps.req_universe), f32),
        naff_count=np.zeros((p, caps.affinity_terms), f32),
        naff_ok=np.zeros((p, caps.affinity_terms), np.bool_),
        pref_onehot=np.zeros((p, caps.pref_terms, caps.req_universe), f32),
        pref_count=np.zeros((p, caps.pref_terms), f32),
        pref_weight=np.zeros((p, caps.pref_terms), f32),
        pod_matches_q=np.zeros((p, caps.podsel_universe), f32),
        pod_carries_e=np.zeros((p, caps.term_universe), f32),
        paff_q=np.full((p, caps.interpod_slots), -1, np.int32),
        paff_tkey=np.zeros((p, caps.interpod_slots), np.int32),
        panti_q=np.full((p, caps.interpod_slots), -1, np.int32),
        panti_tkey=np.zeros((p, caps.interpod_slots), np.int32),
        ipaff_fail=np.zeros((p,), np.bool_),
        ppref_q=np.full((p, caps.interpod_pref_slots), -1, np.int32),
        ppref_tkey=np.zeros((p, caps.interpod_pref_slots), np.int32),
        ppref_w=np.zeros((p, caps.interpod_pref_slots), f32),
        vol_want_rw=np.zeros((p, caps.volume_universe), f32),
        vol_want_ro=np.zeros((p, caps.volume_universe), f32),
        att_onehot=np.zeros((p, caps.attach_universe), f32),
        att_fail=np.zeros((p,), np.bool_),
        vz_onehot=np.zeros((p, caps.selector_universe), f32),
        vz_count=np.zeros((p,), f32),
        vz_fail=np.zeros((p,), np.bool_),
        vs_onehot=np.zeros((p, caps.volsel_universe), f32),
        vs_count=np.zeros((p,), f32),
        vs_fail=np.zeros((p,), np.bool_),
        spread_q=np.full((p,), -1, np.int32),
        spread_svc_q=np.full((p,), -1, np.int32),
        svcanti_q=np.full((p,), -1, np.int32),
        svcanti_total=np.zeros((p,), f32),
        svcaff_onehot=np.zeros((p, caps.req_universe), f32),
        svcaff_count=np.zeros((p,), f32),
        svcaff_fail=np.zeros((p,), np.bool_),
        img_onehot=np.zeros((p, caps.image_universe), f32),
        avoid_onehot=np.zeros((p, caps.avoid_universe), f32),
        gang_id=np.zeros((p,), np.int32),
        gang_min=np.zeros((p,), np.int32),
        priority=np.zeros((p,), np.int32),
    )


def unsupported_feature(pod: Pod) -> str | None:
    """Name of the first feature of `pod` that this package's solver does
    not carry and that would change the result, else None."""
    if pod.spec.volumes:
        return "volumes"
    return None


def _valid_requirement(expr: dict) -> bool:
    """labels.NewRequirement validation: known operator; In/NotIn need >=1
    value; Exists/DoesNotExist need none; Gt/Lt need exactly one."""
    op = expr.get("operator", "")
    values = expr.get("values") or []
    if op in (ReqOp.IN, ReqOp.NOT_IN):
        return len(values) >= 1
    if op in (ReqOp.EXISTS, ReqOp.DOES_NOT_EXIST):
        return len(values) == 0
    if op in (ReqOp.GT, ReqOp.LT):
        return len(values) == 1
    return False


def _encode_node_affinity(batch: PodBatch, i: int, pod: Pod, caps: Capacities,
                          table: NodeTable) -> None:
    req_terms, preferred = parse_node_affinity(pod.spec.affinity)
    batch.naff_onehot[i] = 0.0
    batch.naff_count[i] = 0.0
    batch.naff_ok[i] = False
    batch.naff_has[i] = req_terms is not None
    if req_terms is not None:
        if len(req_terms) > caps.affinity_terms:
            raise CapacityError(
                f"pod {pod.key}: {len(req_terms)} nodeSelectorTerms > "
                f"{caps.affinity_terms} slots")
        # a parse error in ANY term makes the whole term list match nothing
        poisoned = any(not _valid_requirement(e) for exprs in req_terms
                       for e in exprs)
        if not poisoned:
            for t, exprs in enumerate(req_terms):
                if not exprs:
                    continue  # empty term matches no node
                # duplicate expressions collapse to one one-hot column
                rids = {table.intern_requirement(
                    e.get("key", ""), e["operator"], tuple(e.get("values") or ()))
                    for e in exprs}
                for rid in rids:
                    batch.naff_onehot[i, t, rid] = 1.0
                batch.naff_count[i, t] = float(len(rids))
                batch.naff_ok[i, t] = True

    batch.pref_onehot[i] = 0.0
    batch.pref_count[i] = 0.0
    batch.pref_weight[i] = 0.0
    if preferred:
        if len(preferred) > caps.pref_terms:
            raise CapacityError(
                f"pod {pod.key}: {len(preferred)} preferred terms > "
                f"{caps.pref_terms} slots")
        for t, (weight, exprs) in enumerate(preferred):
            # weight <= 0 and empty/invalid expressions never score
            if weight <= 0 or not exprs or any(not _valid_requirement(e)
                                               for e in exprs):
                continue
            rids = {table.intern_requirement(
                e.get("key", ""), e["operator"], tuple(e.get("values") or ()))
                for e in exprs}
            for rid in rids:
                batch.pref_onehot[i, t, rid] = 1.0
            batch.pref_count[i, t] = float(len(rids))
            batch.pref_weight[i, t] = float(weight)


def encode_pod_into(batch: PodBatch, i: int, pod: Pod, caps: Capacities,
                    table: NodeTable, ctx: EncodeContext | None = None) -> None:
    """Encode `pod` into host row `i` of `batch`, with the workload objects
    of `ctx` (none by default)."""
    feature = unsupported_feature(pod)
    if feature is not None:
        raise NotImplementedError(
            f"pod {pod.key}: {feature} is outside the solver this package "
            f"carries")
    batch.valid[i] = True
    batch.requests[i] = pod_requests(pod)
    batch.nonzero_requests[i] = pod_nonzero_requests(pod)
    batch.port_onehot[i] = table.port_onehot(pod.host_ports())

    batch.sel_onehot[i] = 0.0
    selector = pod.spec.node_selector
    for k, v in selector.items():
        batch.sel_onehot[i, table.intern_sel_term(k, v)] = 1.0
    batch.sel_count[i] = float(len(selector))

    tols = pod.spec.tolerations
    if len(tols) > caps.toleration_slots:
        raise CapacityError(f"pod {pod.key}: {len(tols)} tolerations > "
                            f"{caps.toleration_slots} slots")
    batch.tol_key[i] = 0
    batch.tol_val_lo[i] = 0
    batch.tol_val_hi[i] = 0
    batch.tol_op[i] = TolOp.NONE
    batch.tol_effect[i] = Effect.NONE
    for t, tol in enumerate(tols):
        batch.tol_key[i, t] = hash32(tol.key) if tol.key else 0
        batch.tol_val_lo[i, t], batch.tol_val_hi[i, t] = hash_lanes(tol.value)
        batch.tol_op[i, t] = TolOp.EXISTS if tol.operator == "Exists" else TolOp.EQUAL
        batch.tol_effect[i, t] = Effect.NAMES.get(tol.effect, Effect.NONE)

    if pod.spec.node_name:
        batch.node_name_lo[i], batch.node_name_hi[i] = hash_lanes(pod.spec.node_name)
    else:
        batch.node_name_lo[i] = 0
        batch.node_name_hi[i] = 0
    batch.best_effort[i] = pod.is_best_effort()
    batch.priority[i] = pod.spec.priority
    _encode_node_affinity(batch, i, pod, caps, table)
    _encode_interpod_affinity(batch, i, pod, caps, table)
    _encode_workloads(batch, i, pod, table, ctx or EMPTY_CONTEXT)
    fill_avoid_row(batch, i, pod, table)


def _encode_interpod_affinity(batch: PodBatch, i: int, pod: Pod,
                              caps: Capacities, table: NodeTable) -> None:
    """The pod's own pod-(anti-)affinity terms, its carried-term row and
    its match row against the selector universe as interned now (later
    pods of a batch may intern more: `fill_batch_affinity`). Unused slots
    keep the padding values, as in a fresh batch."""
    from kubernetes_tpu_torch.state.podaffinity import PARSE_ERROR

    aff = pod.spec.affinity or {}
    if not (aff.get("podAffinity") or aff.get("podAntiAffinity")):
        # no term (an encode-cache miss's common case): the row's columns
        # already hold the padding values unless it held a pod with terms;
        # every such pod carries at least one, interned in this table
        if table.terms and batch.pod_carries_e[i].any():
            _reset_interpod(batch, i)
        fill_match_row(batch.pod_matches_q[i], table, pod)
        return
    eids, terms = intern_pod_affinity_terms(table, pod)
    _reset_interpod(batch, i)
    # first: a row left half written by a capacity error below still reads
    # as holding terms
    batch.pod_carries_e[i] = carried_term_row(table, eids)
    fail = False
    for lst, q_arr, tk_arr in ((terms.aff_req, batch.paff_q, batch.paff_tkey),
                               (terms.anti_req, batch.panti_q, batch.panti_tkey)):
        if len(lst) > caps.interpod_slots:
            raise CapacityError(
                f"pod {pod.key}: {len(lst)} required pod-affinity terms > "
                f"{caps.interpod_slots} slots")
        for t_idx, t in enumerate(lst):
            tk = table.tkey_code(t.topology_key, required=True)
            if tk == TKEY_INVALID or t.selector == PARSE_ERROR:
                # an empty topologyKey or an unparseable selector on a
                # required term: the pod fits no node
                fail = True
                continue
            q_arr[i, t_idx] = table.intern_podsel(t.namespaces, t.selector)
            tk_arr[i, t_idx] = tk
    batch.ipaff_fail[i] = fail

    pref = ([(t, +1.0) for t in terms.aff_pref]
            + [(t, -1.0) for t in terms.anti_pref])
    pref = [(t, sign) for t, sign in pref if t.weight != 0]
    if len(pref) > caps.interpod_pref_slots:
        raise CapacityError(
            f"pod {pod.key}: {len(pref)} preferred pod-affinity terms > "
            f"{caps.interpod_pref_slots} slots")
    for t_idx, (t, sign) in enumerate(pref):
        batch.ppref_q[i, t_idx] = table.intern_podsel(t.namespaces, t.selector)
        batch.ppref_tkey[i, t_idx] = table.tkey_code(t.topology_key,
                                                     required=False)
        batch.ppref_w[i, t_idx] = sign * float(t.weight)

    fill_match_row(batch.pod_matches_q[i], table, pod)


def _reset_interpod(batch: PodBatch, i: int) -> None:
    """Row i's inter-pod columns to their padding values."""
    for q_arr, tk_arr in ((batch.paff_q, batch.paff_tkey),
                          (batch.panti_q, batch.panti_tkey),
                          (batch.ppref_q, batch.ppref_tkey)):
        q_arr[i] = -1
        tk_arr[i] = 0
    batch.ppref_w[i] = 0.0
    batch.ipaff_fail[i] = False
    batch.pod_carries_e[i] = 0.0


def _encode_workloads(batch: PodBatch, i: int, pod: Pod, table: NodeTable,
                      ctx: EncodeContext) -> None:
    """The spreading entries (state.spreading.spreading_entries)."""
    from kubernetes_tpu_torch.state.spreading import spreading_entries

    (batch.spread_q[i], batch.spread_svc_q[i], batch.svcanti_q[i],
     batch.svcanti_total[i]) = entries = spreading_entries(pod, ctx, table)
    # these entries were interned after pod_matches_q was filled; the pod
    # matches them by construction (they are built from selectors that
    # select it), and the in-batch ledger counts it through these columns
    for q in entries[:3]:
        if q >= 0:
            batch.pod_matches_q[i, q] = 1.0


def fill_avoid_row(batch: PodBatch, i: int, pod: Pod, table: NodeTable) -> None:
    """prefer-avoid row: lookup only. Signatures are interned by node
    annotations; a signature no node names cannot be avoided."""
    batch.avoid_onehot[i] = 0.0
    sig = pod_controller_ref(pod)
    if sig is not None:
        oid = table.avoids.get(sig)
        if oid is not None:
            batch.avoid_onehot[i, oid] = 1.0


def fill_batch_affinity(batch: PodBatch, pods: Sequence[Pod],
                        table: NodeTable) -> None:
    """Recompute the match and carried-term rows once the universes are
    final (entries interned by later pods of the batch)."""
    if not table.podsels and not table.terms:
        return  # no affinity anywhere: the rows are all zero
    for i, pod in enumerate(pods):
        eids, _ = intern_pod_affinity_terms(table, pod)
        fill_match_row(batch.pod_matches_q[i], table, pod)
        batch.pod_carries_e[i] = carried_term_row(table, eids)


def encode_pods(pods: Sequence[Pod], caps: Capacities, table: NodeTable,
                state: ClusterState | None = None,
                ctx: EncodeContext | None = None) -> PodBatch:
    """Encode a host batch against the cluster's universes, with the
    workload objects of `ctx`. When `state` is given, membership columns
    for newly interned terms are refilled."""
    if len(pods) > caps.batch_pods:
        raise CapacityError(f"{len(pods)} pods > batch capacity {caps.batch_pods}")
    batch = empty_batch(caps)
    for i, pod in enumerate(pods):
        encode_pod_into(batch, i, pod, caps, table, ctx)
    fill_batch_affinity(batch, pods, table)
    if state is not None:
        apply_pending_refreshes(state, table)
    return batch


def batch_flags(state: ClusterState, batch: PodBatch):
    """The batch-content gates (ops.solver.BatchFlags) of a batch on a
    device, read in one transfer. Padding rows are all-neutral, so every
    row may be read. Carried affinity terms show in `state.term_q`, and an
    interned PreferNoSchedule taint in `state.taint_u_effect`."""
    from kubernetes_tpu_torch.ops.solver import BatchFlags
    from kubernetes_tpu_torch.state.layout import Resource

    req = batch.requests
    bits = torch.stack([
        (state.term_q >= 0).any() | (batch.paff_q >= 0).any()
        | (batch.panti_q >= 0).any() | (batch.ppref_q >= 0).any()
        | batch.ipaff_fail.any(),
        (batch.spread_q >= 0).any() | (batch.spread_svc_q >= 0).any(),
        (batch.svcanti_q >= 0).any(),
        (batch.vol_want_rw != 0).any() | (batch.vol_want_ro != 0).any(),
        (batch.att_onehot != 0).any() | batch.att_fail.any(),
        (state.taint_u_effect == Effect.PREFER_NO_SCHEDULE).any(),
        (batch.pref_weight > 0).any(),
        (batch.port_onehot != 0).any(),
        (req[:, Resource.GPU] != 0).any(),
        (req[:, Resource.SCRATCH] != 0).any() | (req[:, Resource.OVERLAY] != 0).any(),
        (batch.gang_id > 0).any(),
        (batch.priority != 0).any(),
    ]).tolist()
    (ipa, spread, svcanti, vol, attach, tt, na, ports, gpu, storage, gang,
     preempt) = bits
    return BatchFlags(ipa=ipa, spread=spread, svcanti=svcanti, vol=vol,
                      attach=attach, tt=tt, na=na, ports=ports, gpu=gpu,
                      storage=storage, gang=gang, preempt=preempt)


def _batch_layout(caps: Capacities):
    """Blob column layout: field -> (blob, offset, width, trailing shape,
    host dtype), in PodBatch field order; and the two blob widths. Float
    fields go to the f32 blob, every other field to the i32 blob."""
    proto = empty_batch(caps)
    layout = {}
    offsets = {"f": 0, "i": 0}
    for name in BATCH_FIELDS:
        arr = getattr(proto, name)
        trailing = arr.shape[1:]
        width = int(np.prod(trailing)) if trailing else 1
        blob = "f" if arr.dtype == np.float32 else "i"
        layout[name] = (blob, offsets[blob], width, trailing, arr.dtype)
        offsets[blob] += width
    return layout, offsets["f"], offsets["i"]


_LAYOUTS: dict = {}
_PADDING: dict = {}


def _layout(caps: Capacities):
    lay = _LAYOUTS.get(caps)
    if lay is None:
        lay = _LAYOUTS[caps] = _batch_layout(caps)
    return lay


def blob_widths(caps: Capacities) -> tuple[int, int]:
    """(F, I): the widths of the f32 and i32 blobs."""
    _lay, f_width, i_width = _layout(caps)
    return f_width, i_width


def pack_batch(batch: PodBatch, caps: Capacities,
               out: tuple[np.ndarray, np.ndarray] | None = None):
    """Pack a host (numpy) PodBatch into (f32[P, F], i32[P, I]) blobs;
    `out` reuses a pair of buffers."""
    layout, f_width, i_width = _layout(caps)
    p = batch.valid.shape[0]
    if out is None:
        out = (np.empty((p, f_width), np.float32),
               np.empty((p, i_width), np.int32))
    fblob, iblob = out
    for name, (blob, off, width, _trailing, dtype) in layout.items():
        flat = np.asarray(getattr(batch, name)).reshape(p, width)
        if blob == "f":
            fblob[:, off:off + width] = flat
        elif dtype == np.uint32:
            iblob[:, off:off + width] = flat.view(np.int32)
        else:
            iblob[:, off:off + width] = flat
    return fblob, iblob


def pack_row(batch: PodBatch, i: int, caps: Capacities):
    """Row i of a host batch as (f32[F], i32[I]): the unit EncodeCache
    keeps, so a cache hit is two row copies."""
    layout, f_width, i_width = _layout(caps)
    frow = np.empty((f_width,), np.float32)
    irow = np.empty((i_width,), np.int32)
    for name, (blob, off, width, _trailing, dtype) in layout.items():
        flat = np.asarray(getattr(batch, name)[i]).reshape(width)
        if blob == "f":
            frow[off:off + width] = flat
        elif dtype == np.uint32:
            irow[off:off + width] = flat.view(np.int32)
        else:
            irow[off:off + width] = flat
    return frow, irow


class PackedRow:
    """One packed row (`f` f32[F], `i` i32[I]) under a one-row PodBatch
    (`batch`) whose float, int32 and uint32 fields are views of the row's
    columns, so encoding into row 0 of `batch` writes the packed row in
    place. The bool fields (a bool array cannot view int32 storage) are
    views of one bool array, copied into their columns by `pack()`. Fields
    the encoder does not write keep their padding values."""

    def __init__(self, caps: Capacities):
        layout, f_width, i_width = _layout(caps)
        proto = empty_batch(replace(caps, batch_pods=1))
        self.f = np.empty((f_width,), np.float32)
        self.i = np.empty((i_width,), np.int32)
        bool_cols = [np.arange(off, off + width)
                     for blob, off, width, _t, dtype in layout.values()
                     if dtype == np.bool_]
        self._bool_cols = np.concatenate(bool_cols)
        self._bools = np.empty((len(self._bool_cols),), np.bool_)
        views = {}
        at = 0
        for name, (blob, off, width, _trailing, dtype) in layout.items():
            pad = getattr(proto, name)
            if dtype == np.bool_:
                view = self._bools[at:at + width].reshape(pad.shape)
                at += width
            else:
                src = self.f if blob == "f" else self.i.view(dtype)
                view = src[off:off + width].reshape(pad.shape)
            view[...] = pad
            views[name] = view
        self.batch = PodBatch(**views)

    def pack(self) -> tuple[np.ndarray, np.ndarray]:
        """(f, i) with the bool fields written in: the row's own buffers,
        valid until the next encode into `batch`."""
        self.i[self._bool_cols] = self._bools
        return self.f, self.i


def padding_row(caps: Capacities):
    """The packed padding row (valid 0, -1 in the unused-id columns): what
    a batch's unused tail rows hold."""
    row = _PADDING.get(caps)
    if row is None:
        row = _PADDING[caps] = pack_row(empty_batch(caps), 0, caps)
    return row


def blob_col(fblob, iblob, name: str, caps: Capacities, n: int | None = None):
    """View of one field's columns in the blobs, [P(, ...)] (or the first n
    rows), in blob dtype: uint32 lanes as int32, bools as int32 0/1."""
    layout, _f, _i = _layout(caps)
    blob, off, width, trailing, _dtype = layout[name]
    src = fblob if blob == "f" else iblob
    rows = src if n is None else src[:n]
    col = rows[:, off:off + width]
    return col.reshape((col.shape[0], *trailing)) if trailing else col[:, 0]


def packed_batch_flags(fblob: np.ndarray, iblob: np.ndarray, n: int,
                       table: NodeTable, caps: Capacities):
    """`batch_flags` of the first n rows of host blobs, with the carried
    affinity terms and interned PreferNoSchedule taints read from the
    cluster's `table` (terms interned by this batch's pods count before
    any flush): no device transfer."""
    from kubernetes_tpu_torch.ops.solver import BatchFlags
    from kubernetes_tpu_torch.state.layout import Resource

    def col(name):
        return blob_col(fblob, iblob, name, caps, n)

    def any_(name):
        return bool(col(name).any())

    def any_id(name):  # i32 id columns, -1 = unused
        return bool((col(name) >= 0).any())

    req = col("requests")
    return BatchFlags(
        ipa=bool(table.terms) or any_id("paff_q")
        or any_id("panti_q") or any_id("ppref_q") or any_("ipaff_fail"),
        spread=any_id("spread_q") or any_id("spread_svc_q"),
        svcanti=any_id("svcanti_q"),
        vol=any_("vol_want_rw") or any_("vol_want_ro"),
        attach=any_("att_onehot") or any_("att_fail"),
        tt=any(effect == "PreferNoSchedule" for _k, _v, effect in table.taints),
        na=bool((col("pref_weight") > 0).any()),
        ports=any_("port_onehot"),
        gpu=bool(req[:, Resource.GPU].any()),
        storage=bool(req[:, Resource.SCRATCH].any()
                     or req[:, Resource.OVERLAY].any()),
        gang=bool((col("gang_id") > 0).any()),
        preempt=any_("priority"))


def write_gang_columns(fblob: np.ndarray, iblob: np.ndarray, gang_id,
                       gang_min, caps: Capacities) -> None:
    """Write the gang columns of the first len(gang_id) rows of host blobs
    (after encoding, which leaves them zero): each row's batch-local group
    id (0 = none) and its group's quorum."""
    n = len(gang_id)
    blob_col(fblob, iblob, "gang_id", caps, n)[:] = gang_id
    blob_col(fblob, iblob, "gang_min", caps, n)[:] = gang_min


# the batch fields the CUDA kernels take as operands (ops.static_mask,
# ops.assign_scan), which must be contiguous
KERNEL_OPERANDS = frozenset({"sel_onehot", "sel_count", "best_effort",
                             "node_name_lo", "node_name_hi", "requests",
                             "nonzero_requests"})


def unpack_batch(fblob: torch.Tensor, iblob: torch.Tensor,
                 caps: Capacities) -> PodBatch:
    """The PodBatch of two blobs on a device: column slices and reshapes
    (views of the blobs), `!= 0` for the bool fields, and contiguous copies
    of the kernels' operands (`KERNEL_OPERANDS`). Nothing is read back to
    the host."""
    layout, _f, _i = _layout(caps)
    p = fblob.shape[0]
    out = {}
    for name, (blob, off, width, trailing, dtype) in layout.items():
        src = fblob if blob == "f" else iblob
        col = src[:, off:off + width].reshape((p, *trailing))
        if dtype == np.bool_:
            col = col != 0
        out[name] = col.contiguous() if name in KERNEL_OPERANDS else col
    return PodBatch(**out)


def encode_cluster(nodes, pods, caps: Capacities,
                   ctx: EncodeContext | None = None):
    """One-shot host encoding of nodes + pending pods with a shared universe,
    in the reference encoder's order (pods first, then nodes) so universe
    ids agree with it. Returns (state, batch, table)."""
    table = NodeTable(caps)
    batch = encode_pods(pods, caps, table, ctx=ctx)
    state, _ = encode_nodes(nodes, caps, table=table)
    # nodes may have interned avoid signatures after the pods were encoded
    for i, pod in enumerate(pods):
        fill_avoid_row(batch, i, pod, table)
    apply_pending_refreshes(state, table)
    # no pod is accounted: the pod-selector counts are all zero already
    table.pending_podsel_refresh.clear()
    return state, batch, table
