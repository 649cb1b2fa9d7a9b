"""StateDB: host-canonical cluster state mirrored to one device.

The scheduler-cache role: node objects and accounted pods aggregate into
host numpy arrays (`host`), and `flush()` hands the solver a device view,
moving only what changed:
- the first flush uploads every field;
- later node changes and membership refills (a pod interning a new
  selector term) mark host rows dirty, and the next flush copies just
  those rows with one `index_copy_` per node-axis field;
- a batch's assignments come back as the solver's device-resident ledger,
  which `commit_batch` adopts as the device truth (batch-to-batch chaining
  never leaves the device) while it mirrors the same additions into the
  host arrays from the batch's encoded rows, so host and device agree
  without a transfer.
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetes_tpu_torch.api.objects import Node
from kubernetes_tpu_torch.state.cluster_state import (
    NODE_AXIS_FIELDS,
    STATE_FIELDS,
    ClusterState,
    NodeTable,
    apply_pending_refreshes,
    empty_state,
    fill_node_row,
)
from kubernetes_tpu_torch.state.convert import state_from_numpy, to_device
from kubernetes_tpu_torch.state.layout import Capacities
from kubernetes_tpu_torch.state.pod_batch import PodBatch
from kubernetes_tpu_torch.utils.device import resolve_device

_UNIVERSE_FIELDS = tuple(f for f in STATE_FIELDS if f not in NODE_AXIS_FIELDS)


class StateDB:
    def __init__(self, caps: Capacities, device=None):
        self.caps = caps
        self.device = resolve_device(device)
        self.host: ClusterState = empty_state(caps)
        self.table = NodeTable(caps)
        self._device: ClusterState | None = None
        self._dirty_rows: set[int] = set()
        self.flush_rows_total = 0   # node rows copied to the device

    def upsert_node(self, node: Node) -> None:
        row = self.table.assign_row(node.metadata.name)
        fill_node_row(self.host, self.table, row, node)
        self._dirty_rows.add(row)

    def flush(self) -> ClusterState:
        """The device view, refreshed from the host where rows changed.
        Membership columns of terms interned since the last flush are
        filled first."""
        self._dirty_rows.update(apply_pending_refreshes(self.host, self.table))
        if self._device is None:
            self._device = state_from_numpy(self.host, self.device)
            self.flush_rows_total += self.caps.num_nodes
        elif self._dirty_rows:
            rows = np.fromiter(sorted(self._dirty_rows), np.int64)
            idx = torch.from_numpy(rows).to(self.device)
            for name in NODE_AXIS_FIELDS:
                getattr(self._device, name).index_copy_(
                    0, idx, to_device(getattr(self.host, name)[rows], self.device))
            # universe attributes (taint hashes and effects, ...) are tiny
            for name in _UNIVERSE_FIELDS:
                setattr(self._device, name,
                        to_device(getattr(self.host, name), self.device))
            self.flush_rows_total += len(rows)
        self._dirty_rows.clear()
        return self._device

    def adopt_result(self, result) -> None:
        """Chain the solver's post-batch ledger as the device truth (no
        copy, no synchronization)."""
        if self._device is None:
            raise RuntimeError("adopt_result before flush")
        self._device.requested = result.new_requested
        self._device.nonzero_requested = result.new_nonzero

    def commit_batch(self, result, batch: PodBatch,
                     assignments: np.ndarray) -> None:
        """Adopt the batch's device ledger and mirror its assignments into
        the host arrays: host row `assignments[i]` gains the encoded
        requests of batch row i, added in pod order as the scan added them.

        batch: the host (numpy) batch that was solved; assignments: the
        solver's node rows on the host, -1 for unassigned rows."""
        self.adopt_result(result)
        idx = np.flatnonzero(assignments >= 0)
        rows = assignments[idx]
        np.add.at(self.host.requested, rows, batch.requests[idx])
        np.add.at(self.host.nonzero_requested, rows, batch.nonzero_requests[idx])
