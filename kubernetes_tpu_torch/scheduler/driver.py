"""Scheduler: the batch driver of the main path, without an apiserver.

`add_nodes` registers nodes in the StateDB; `schedule(pods)` encodes the
pods in `caps.batch_pods` chunks, solves each chunk on the device, commits
its ledger, and chains the round-robin counter from batch to batch, so a
sequence of `schedule` calls makes the decisions one long serial schedule
would. Watching an apiserver and binding are host-plane work for a later
slice of the port.
"""

from __future__ import annotations

import time
from typing import Sequence

from kubernetes_tpu_torch.api.objects import Node, Pod
from kubernetes_tpu_torch.models.policy import DEFAULT_POLICY, Policy
from kubernetes_tpu_torch.ops.solver import schedule_batch
from kubernetes_tpu_torch.state.convert import batch_from_numpy
from kubernetes_tpu_torch.state.layout import Capacities
from kubernetes_tpu_torch.state.pod_batch import encode_pods
from kubernetes_tpu_torch.state.statedb import StateDB


class Scheduler:
    def __init__(self, caps: Capacities | None = None,
                 policy: Policy = DEFAULT_POLICY, device=None):
        self.caps = caps or Capacities()
        self.policy = policy
        self.statedb = StateDB(self.caps, device)
        self.device = self.statedb.device
        self.rr = 0  # round-robin counter: an int, then the device's i64 scalar
        self.last_result = None  # SolverResult of the latest batch
        # per batch: host seconds to encode + upload, and to solve through
        # to the assignments on the host
        self.encode_seconds: list[float] = []
        self.solve_seconds: list[float] = []

    def add_nodes(self, nodes: Sequence[Node]) -> None:
        for node in nodes:
            self.statedb.upsert_node(node)

    def schedule(self, pods: Sequence[Pod]) -> dict[str, str | None]:
        """Place `pods` in order. Returns {pod key: node name, or None when
        no node fits}."""
        out: dict[str, str | None] = {}
        step = self.caps.batch_pods
        for start in range(0, len(pods), step):
            out.update(self._schedule_chunk(pods[start:start + step]))
        return out

    def _schedule_chunk(self, pods: Sequence[Pod]) -> dict[str, str | None]:
        t0 = time.perf_counter()
        host_batch = encode_pods(pods, self.caps, self.statedb.table)
        state = self.statedb.flush()
        batch = batch_from_numpy(host_batch, self.device)
        t1 = time.perf_counter()
        result = schedule_batch(state, batch, self.rr, self.policy)
        assignments = result.assignments.cpu().numpy()
        t2 = time.perf_counter()
        self.statedb.commit_batch(result, host_batch, assignments)
        self.rr = result.rr_end
        self.last_result = result
        self.encode_seconds.append(t1 - t0)
        self.solve_seconds.append(t2 - t1)
        name_of = self.statedb.table.name_of
        return {pod.key: (name_of[int(row)] if row >= 0 else None)
                for pod, row in zip(pods, assignments)}
