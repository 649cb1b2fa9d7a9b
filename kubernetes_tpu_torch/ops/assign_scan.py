"""Kernel 2: the serial assignment scan (Phase B of the batch solver).

Counterpart of the reference solver's `lax.scan` over the pods
(kubernetes_tpu/ops/solver.py `step` and `_select_host`), which has no
Pallas source: in eager PyTorch each pod would cost about fifteen launches,
so the whole scan is one CUDA launch of one thread-block cluster
(csrc/assign_scan.cu; its header gives the design and the bound).

`assign_scan` is the wrapper: on CUDA tensors it launches the kernel (and
counts the launch in `assign_scan.launches`), on CPU tensors it runs
`assign_scan_plain`, the same scan as a Python loop of tensor ops.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from kubernetes_tpu_torch.ops.predicates import fits_resources_dyn
from kubernetes_tpu_torch.ops.priorities import balanced_allocation, least_requested
from kubernetes_tpu_torch.utils.device import check_tensor

RR_MOD = 1 << 32


@dataclass
class ScanResult:
    assignments: torch.Tensor      # i32[P] node row, -1 = unassigned
    scores: torch.Tensor           # f32[P] winning score, 0 when unassigned
    feasible_counts: torch.Tensor  # i32[P] nodes that passed every predicate
    new_requested: torch.Tensor    # f32[N, R] ledger after the batch
    new_nonzero: torch.Tensor      # f32[N, 2]
    rr_end: torch.Tensor           # i64 scalar in [0, 2^32)


def _rr_tensor(rr_start, device) -> torch.Tensor:
    """rr as an i64 scalar tensor on `device`, reduced mod 2^32."""
    if isinstance(rr_start, torch.Tensor):
        return (rr_start.to(device=device, dtype=torch.int64) % RR_MOD).reshape(())
    return torch.tensor(int(rr_start) % RR_MOD, dtype=torch.int64, device=device)


def assign_scan_plain(masked_static, requests, nonzero_requests, allocatable,
                      requested, nonzero, rr_start, w_lr: float = 1.0,
                      w_ba: float = 1.0) -> ScanResult:
    """The scan as a loop over pods of N-wide tensor ops (the CPU path and
    the reference the kernel is held against on the card). Nothing leaves
    the device inside the loop."""
    p_count, n = masked_static.shape
    dev = masked_static.device
    req = requested.clone()
    nz = nonzero.clone()
    rr = _rr_tensor(rr_start, dev)
    assignments = torch.empty((p_count,), dtype=torch.int32, device=dev)
    scores = torch.empty((p_count,), dtype=torch.float32, device=dev)
    counts = torch.empty((p_count,), dtype=torch.int32, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    for p in range(p_count):
        ms = masked_static[p]
        feasible = (ms > float("-inf")) & fits_resources_dyn(
            allocatable, requests[p:p + 1], req, dyn_gpu=False,
            dyn_storage=False)[0]
        score = (ms + w_lr * least_requested(allocatable, nonzero_requests[p:p + 1], nz)[0]
                 + w_ba * balanced_allocation(allocatable, nonzero_requests[p:p + 1], nz)[0])
        masked = torch.where(feasible, score, neg_inf)
        best = masked.max()
        ties = feasible & (masked == best)
        cum = torch.cumsum(ties.to(torch.int64), 0)
        ntie = cum[-1]
        k = rr % torch.clamp(ntie, min=1)
        # cum steps exactly at tie positions: the first index reaching k+1
        # is the (k+1)-th tie in node order
        node = torch.argmax((cum >= k + 1).to(torch.int32))
        assigned = ntie > 0
        add = assigned.to(torch.float32)
        req[node] += add * requests[p]
        nz[node] += add * nonzero_requests[p]
        rr = (rr + assigned.to(torch.int64)) % RR_MOD
        assignments[p] = torch.where(assigned, node.to(torch.int32), -1)
        scores[p] = torch.where(assigned, best, 0.0)
        counts[p] = feasible.sum()
    return ScanResult(assignments, scores, counts, req, nz, rr)


_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
             + [ctypes.c_float] * 2 + [ctypes.c_void_p])
CLUSTER = 16        # blocks of the kernel's thread-block cluster
THREADS = 512       # threads of one block
RUNS = (1, 2, 4, 8)  # nodes per thread the kernel is built for


def node_run(n: int) -> int:
    """Nodes per thread: the smallest run with which the cluster holds n
    nodes; ValueError past the largest (CLUSTER * THREADS * 8 = 65,536)."""
    for run in RUNS:
        if CLUSTER * THREADS * run >= n:
            return run
    raise ValueError(f"assign_scan: {n} nodes > {CLUSTER * THREADS * RUNS[-1]}")


def assign_scan(masked_static, requests, nonzero_requests, allocatable,
                requested, nonzero, rr_start, w_lr: float = 1.0,
                w_ba: float = 1.0) -> ScanResult:
    """Phase B over one batch.

    masked_static f32[P, N] (static score where statically feasible and the
    pod valid, else -inf), requests f32[P, R], nonzero_requests f32[P, 2],
    allocatable f32[N, R], and the batch-start ledger requested f32[N, R] /
    nonzero f32[N, 2] (not modified). rr_start is an int or an i64 scalar
    tensor. Requests in the gpu and storage columns must be zero (the solver
    hoists those compares into Phase A)."""
    p, n = masked_static.shape
    r = requests.shape[1]
    dev = masked_static.device
    f32 = torch.float32
    for args in (("masked_static", masked_static, f32, (p, n)),
                 ("requests", requests, f32, (p, r)),
                 ("nonzero_requests", nonzero_requests, f32, (p, 2)),
                 ("allocatable", allocatable, f32, (n, r)),
                 ("requested", requested, f32, (n, r)),
                 ("nonzero", nonzero, f32, (n, 2))):
        check_tensor(*args, dev)
    if r != 6:
        raise ValueError(f"assign_scan: {r} resource columns, want 6")
    if dev.type == "cpu":
        return assign_scan_plain(masked_static, requests, nonzero_requests,
                                 allocatable, requested, nonzero, rr_start,
                                 w_lr, w_ba)
    if dev.type != "cuda":
        raise ValueError(f"assign_scan: unsupported device {dev}")
    run = node_run(n)
    from kubernetes_tpu_torch.native.build import load

    fn = load("assign_scan").ktpu_assign_scan
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    req = requested.clone()   # the kernel updates the ledger in place
    nz = nonzero.clone()
    rr = _rr_tensor(rr_start, dev).reshape(1).clone()
    assignments = torch.empty((p,), dtype=torch.int32, device=dev)
    scores = torch.empty((p,), dtype=f32, device=dev)
    counts = torch.empty((p,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(masked_static.data_ptr(), requests.data_ptr(),
                 nonzero_requests.data_ptr(), allocatable.data_ptr(),
                 req.data_ptr(), nz.data_ptr(), assignments.data_ptr(),
                 scores.data_ptr(), counts.data_ptr(), rr.data_ptr(),
                 p, n, run, float(w_lr), float(w_ba), stream)
    if err != 0:
        raise RuntimeError(f"assign_scan kernel launch failed: CUDA error {err}")
    assign_scan.launches += 1
    return ScanResult(assignments, scores, counts, req, nz, rr.reshape(()))


assign_scan.launches = 0
