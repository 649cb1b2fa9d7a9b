"""StateDB: host-canonical cluster state mirrored to one device.

The scheduler-cache role: node objects and accounted pods (bound, or
placed by a batch) aggregate into host numpy arrays (`host`), and
`flush()` hands the solver a device view, moving only what changed:
- the first flush uploads every field;
- later node changes, pod accounting and membership refills (a pod
  interning a new selector term) mark host rows dirty, and the next flush
  copies just those rows with one `index_copy_` per node-axis field;
- `mark_ledger_dirty` forces the next flush to re-upload the whole ledger;
- a batch's assignments come back as the solver's device-resident ledger,
  which `commit_batch` adopts as the device truth (batch-to-batch chaining
  never leaves the device) while it mirrors the same additions into the
  host arrays from the batch's f32 blob, so host and device agree without
  a transfer, and accounts each placed pod so `remove_pod` can undo it.

The host-port counts (`port_count`, read by PodFitsHostPorts) are
accounted the same way, from each pod's port row (a port listed twice
counts twice, as in the reference), and so are the volume ledgers: the
disk-conflict counts (`vol_any`, every mount of an atom, and `vol_rw`, the
read-write ones, read by NoDiskConflict) and the attach counts
(`attach_count`, read by MaxPDVolumeCount), a bound pod's claims resolved
through the StateDB's EncodeContext (`ctx`) with a broken claim skipped
(`permissive`, as the reference accounts it). The affinity ledgers too: the pod-selector counts
(`podsel_count`, read by SelectorSpread and inter-pod affinity) from each
pod's match row, and the carried-term counts (`term_count`, the existing
pods' pod-affinity terms) from its carried-term row. A selector entry
interned after pods were accounted starts with an empty column: `flush`
first counts the accounted pods it matches (`_refill_podsel`). A carried
term is interned when the first pod carrying it is encoded or accounted,
so its column needs no refill; `flush` uploads the term attributes
(`term_q`, `term_tkey`, `term_weight`, `term_kind`, `term_poison`) when
terms were interned, and the attach atoms' types (`attach_type`) when
atoms were. A batch whose program passed a ledger through (the
scan build did not carry it) leaves the device copy behind the host, so
its placed pods' rows are copied at the next flush.
"""

from __future__ import annotations

from itertools import compress, repeat
from typing import Iterable

import numpy as np
import torch

from kubernetes_tpu_torch.api.objects import Node, Pod
from kubernetes_tpu_torch.state.cluster_state import (
    NODE_AXIS_FIELDS,
    STATE_FIELDS,
    ClusterState,
    NodeTable,
    apply_pending_refreshes,
    carried_term_row,
    empty_state,
    fill_node_row,
    intern_pod_affinity_terms,
    pod_match_row,
    pod_nonzero_requests,
    pod_requests,
)
from kubernetes_tpu_torch.state.context import EMPTY_CONTEXT, EncodeContext
from kubernetes_tpu_torch.state.convert import state_from_numpy, to_device
from kubernetes_tpu_torch.state.layout import Capacities
from kubernetes_tpu_torch.state.pod_batch import blob_col
from kubernetes_tpu_torch.utils.device import resolve_device

_UNIVERSE_FIELDS = tuple(f for f in STATE_FIELDS if f not in NODE_AXIS_FIELDS)
_LEDGER_FIELDS = ("requested", "nonzero_requested", "port_count",
                  "podsel_count", "term_count", "vol_any", "vol_rw", "attach_count")


# What removing an accounted pod takes back from its node's row, in the
# columns of this package's ledgers: (node name, j, requests f32[K, R],
# nonzero f32[K, 2], match row f32[K, UQ], carried-term row f32[K, UE],
# the pod, port row f32[K, UP], conflict rows vol_any and vol_rw f32[K, UV],
# attach row f32[K, UA]), the pod's columns being row j of arrays it
# shares with the pods accounted beside it; the pod's namespace and labels
# refill entries interned after it. A plain tuple, so a batch's thousands
# of records cost one small object each.
AccountedPod = tuple[str, int, np.ndarray, np.ndarray, np.ndarray,
                     np.ndarray, Pod, np.ndarray, np.ndarray, np.ndarray,
                     np.ndarray]


class StateDB:
    def __init__(self, caps: Capacities, device=None,
                 ctx: EncodeContext | None = None):
        self.caps = caps
        self.device = resolve_device(device)
        # the claims and PVs a bound pod's volumes resolve through
        self.ctx = ctx or EMPTY_CONTEXT
        self.host: ClusterState = empty_state(caps)
        self.table = NodeTable(caps)
        self._accounted: dict[str, AccountedPod] = {}
        # pods accounted through add_pod (bound outside a batch), by
        # namespace: the pod lister the spreading encoder counts from
        self._bound: dict[str, dict[str, Pod]] = {}
        self._device: ClusterState | None = None
        self._dirty_rows: set[int] = set()
        self._dirty_ledger_all = False
        self.flush_rows_total = 0   # node rows copied to the device

    # ---- node lifecycle ----

    def upsert_node(self, node: Node) -> None:
        row = self.table.assign_row(node.metadata.name)
        fill_node_row(self.host, self.table, row, node)
        self._dirty_rows.add(row)

    def remove_node(self, name: str) -> None:
        """Drop a node: its row returns to the free list with every
        node-axis field zeroed (topology -1), and its pods are no longer
        accounted."""
        if name not in self.table.row_of:
            return
        row = self.table.release_row(name)
        for key in [k for k, v in self._accounted.items() if v[0] == name]:
            self._forget(key)
        for field in NODE_AXIS_FIELDS:
            getattr(self.host, field)[row] = -1 if field == "topology" else 0
        self._dirty_rows.add(row)

    def has_node(self, name: str) -> bool:
        return name in self.table.row_of

    # ---- pod accounting ----

    def _apply_pod(self, row: int, acc: AccountedPod, sign: int) -> None:
        (_name, j, requests, nonzero, match, carry, _pod, ports, vol_any,
         vol_rw, attach) = acc
        self.host.requested[row] += sign * requests[j]
        self.host.nonzero_requested[row] += sign * nonzero[j]
        self.host.port_count[row] += sign * ports[j]
        self.host.podsel_count[row] += sign * match[j]
        self.host.term_count[row] += sign * carry[j]
        self.host.vol_any[row] += sign * vol_any[j]
        self.host.vol_rw[row] += sign * vol_rw[j]
        self.host.attach_count[row] += sign * attach[j]
        self._dirty_rows.add(row)

    def _forget(self, key: str) -> AccountedPod | None:
        acc = self._accounted.pop(key, None)
        if acc is not None:
            self._bound.get(acc[6].metadata.namespace, {}).pop(key, None)
        return acc

    def bound_pods(self, namespace: str) -> list[Pod]:
        """The pods of `namespace` accounted through `add_pod`."""
        return list(self._bound.get(namespace, {}).values())

    def add_pod(self, pod: Pod, node_name: str | None = None) -> bool:
        """Account a bound pod against its node (`node_name`, else the
        pod's spec.nodeName). Returns False when the node is unknown; an
        already accounted pod is left as it is. Its volumes count into the
        conflict and attach ledgers, a claim that does not resolve
        skipped."""
        node_name = node_name or pod.spec.node_name
        row = self.table.row_of.get(node_name)
        if row is None:
            return False
        if pod.key in self._accounted:
            return True
        # terms first: the match row then covers the selectors they intern
        eids, _ = intern_pod_affinity_terms(self.table, pod)
        if pod.spec.volumes:
            vol_any, vol_rw = self.table.vol_rows(pod)
            attach = self.table.attach_row(pod, self.ctx, permissive=True)
        else:
            vol_any = vol_rw = np.zeros((self.caps.volume_universe,), np.float32)
            attach = np.zeros((self.caps.attach_universe,), np.float32)
        acc = (node_name, 0, pod_requests(pod)[None],
               pod_nonzero_requests(pod)[None],
               pod_match_row(self.table, pod)[None],
               carried_term_row(self.table, eids)[None], pod,
               self.table.port_onehot(pod.host_ports())[None], vol_any[None],
               vol_rw[None], attach[None])
        self._apply_pod(row, acc, +1)
        self._accounted[pod.key] = acc
        self._bound.setdefault(pod.metadata.namespace, {})[pod.key] = pod
        return True

    def remove_pod(self, pod_key: str) -> None:
        """Take an accounted pod's requests, host ports, volumes, selector
        matches and carried terms back from its node."""
        acc = self._forget(pod_key)
        if acc is None:
            return
        row = self.table.row_of.get(acc[0])
        if row is None:
            return  # node removed; its row was zeroed already
        self._apply_pod(row, acc, -1)

    def is_accounted(self, pod_key: str) -> bool:
        return pod_key in self._accounted

    @property
    def ledger_dirty(self) -> bool:
        """True when the next flush() copies host rows to the device: a
        batch still running on the device must be settled first, or its
        charges are overwritten."""
        return (bool(self._dirty_rows) or self._dirty_ledger_all
                or bool(self.table.pending_sel_refresh)
                or bool(self.table.pending_req_refresh)
                or bool(self.table.pending_podsel_refresh)
                or bool(self.table.pending_topo_refresh)
                or bool(self.table.pending_volsel_refresh))

    def mark_ledger_dirty(self) -> None:
        """Force the next flush() to re-upload the whole host ledger (the
        device ledger carries charges the host truth does not, e.g. a
        placement whose binding was rolled back; which rows is unknown)."""
        self._dirty_ledger_all = True

    # ---- device mirror ----

    def _refill_podsel(self) -> None:
        """Count the accounted pods into the columns of selector entries
        interned after they were accounted."""
        from kubernetes_tpu_torch.state.podaffinity import pod_matches_entry

        row_of = self.table.row_of
        for qid in self.table.pending_podsel_refresh:
            ns_key, canon = self.table.podsel_attrs[qid]
            for acc in self._accounted.values():
                name, j, match, pod = acc[0], acc[1], acc[4], acc[6]
                if match[j, qid]:
                    continue  # accounted after the intern: already counted
                if pod_matches_entry(pod, ns_key, canon):
                    row = row_of[name]
                    self.host.podsel_count[row, qid] += 1.0
                    match[j, qid] = 1.0
                    self._dirty_rows.add(row)
        self.table.pending_podsel_refresh.clear()

    def flush(self) -> ClusterState:
        """The device view, refreshed from the host where rows changed.
        Membership columns of terms and PV selectors, topology columns of
        custom keys and pod-selector counts of entries interned since the
        last flush are filled first; the universe attributes are uploaded
        with any row, and whenever carried terms or attach atoms were
        interned."""
        self._refill_podsel()
        attrs = self.table.dirty_term_attrs or self.table.dirty_attach_attrs
        self._dirty_rows.update(apply_pending_refreshes(self.host, self.table))
        if self._device is None:
            self._device = state_from_numpy(self.host, self.device)
            self.flush_rows_total += self.caps.num_nodes
        else:
            if self._dirty_rows:
                rows = np.fromiter(sorted(self._dirty_rows), np.int64)
                idx = torch.from_numpy(rows).to(self.device)
                for name in NODE_AXIS_FIELDS:
                    getattr(self._device, name).index_copy_(
                        0, idx, to_device(getattr(self.host, name)[rows],
                                          self.device))
                # universe attributes (taint hashes and effects, ...) are tiny
                for name in _UNIVERSE_FIELDS:
                    setattr(self._device, name,
                            to_device(getattr(self.host, name), self.device))
                self.flush_rows_total += len(rows)
            elif attrs:
                for name in _UNIVERSE_FIELDS:
                    setattr(self._device, name,
                            to_device(getattr(self.host, name), self.device))
            if self._dirty_ledger_all:
                for name in _LEDGER_FIELDS:
                    setattr(self._device, name,
                            to_device(getattr(self.host, name), self.device))
                self.flush_rows_total += self.caps.num_nodes
        self._dirty_rows.clear()
        self._dirty_ledger_all = False
        return self._device

    def adopt_result(self, result) -> None:
        """Chain the solver's post-batch ledgers as the device truth (no
        copy, no synchronization); a port, volume or affinity ledger the
        batch passed through (`new_port_count`, `new_vol_any`, `new_vol_rw`,
        `new_attach`, `new_podsel` or `new_term` None) stays as it was."""
        if self._device is None:
            raise RuntimeError("adopt_result before flush")
        self._device.requested = result.new_requested
        self._device.nonzero_requested = result.new_nonzero
        for name, new in (("port_count", result.new_port_count),
                          ("vol_any", result.new_vol_any),
                          ("vol_rw", result.new_vol_rw),
                          ("attach_count", result.new_attach)):
            if new is not None:
                setattr(self._device, name, new)
        if result.new_podsel is not None:
            self._device.podsel_count = result.new_podsel
        if result.new_term is not None:
            self._device.term_count = result.new_term

    def commit_batch(self, result, fblob: np.ndarray,
                     committed: Iterable[tuple[Pod, str, int]]) -> None:
        """Adopt the batch's device ledger, mirror its placements into the
        host arrays and account the placed pods.

        fblob: the f32 blob of the batch that was solved; committed:
        (pod, node name, batch row) of each placed pod, in batch order. The
        host row of each node gains the blob's `requests` and
        `nonzero_requests` columns of its pods, added in pod order as the
        scan added them, its `port_onehot` columns to the host-port counts,
        its `vol_want_rw` and `vol_want_ro` columns to the conflict counts
        (both to `vol_any`, the first to `vol_rw`), its `att_onehot` columns
        to the attach counts, its `pod_matches_q` columns to the
        pod-selector counts and its `pod_carries_e` columns to the
        carried-term counts.
        Pods already accounted, or on nodes removed since, are skipped."""
        self.adopt_result(result)
        committed = list(committed)
        if not committed:
            return
        row_of, accounted = self.table.row_of, self._accounted
        pods, names, idx = zip(*committed)
        keys = [pod.key for pod in pods]
        n = len(keys)
        idx = np.asarray(idx, np.int64)
        # membership by C-level passes (map), not a per-pod Python loop
        rows = np.fromiter(map(row_of.get, names, repeat(-1)), np.int64, n)
        live = ~np.fromiter(map(accounted.__contains__, keys), np.bool_, n)
        live &= rows >= 0
        if not live.all():
            keys = list(compress(keys, live))
            names = list(compress(names, live))
            rows, idx = rows[live], idx[live]
            if not keys:
                return
        req = blob_col(fblob, None, "requests", self.caps)[idx]
        nz = blob_col(fblob, None, "nonzero_requests", self.caps)[idx]
        match = blob_col(fblob, None, "pod_matches_q", self.caps)[idx]
        carry = blob_col(fblob, None, "pod_carries_e", self.caps)[idx]
        ports = blob_col(fblob, None, "port_onehot", self.caps)[idx]
        vol_rw = blob_col(fblob, None, "vol_want_rw", self.caps)[idx]
        vol_any = vol_rw + blob_col(fblob, None, "vol_want_ro", self.caps)[idx]
        attach = blob_col(fblob, None, "att_onehot", self.caps)[idx]
        np.add.at(self.host.requested, rows, req)
        np.add.at(self.host.nonzero_requested, rows, nz)
        for rows_of, ledger, device in (
                (ports, self.host.port_count, result.new_port_count),
                (vol_any, self.host.vol_any, result.new_vol_any),
                (vol_rw, self.host.vol_rw, result.new_vol_rw),
                (attach, self.host.attach_count, result.new_attach),
                (match, self.host.podsel_count, result.new_podsel),
                (carry, self.host.term_count, result.new_term)):
            if rows_of.any():
                hit, col = np.nonzero(rows_of)   # a few columns a pod
                np.add.at(ledger, (rows[hit], col), rows_of[hit, col])
                if device is None:
                    # the device ledger did not count these placements
                    self._dirty_rows.update(rows[hit].tolist())
        accounted.update(zip(keys, zip(names, range(len(keys)), repeat(req),
                                       repeat(nz), repeat(match), repeat(carry),
                                       compress(pods, live), repeat(ports),
                                       repeat(vol_any), repeat(vol_rw),
                                       repeat(attach))))
