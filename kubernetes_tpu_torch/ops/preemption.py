"""Kernel 3: the preemption pass, victim sets for the pods a batch left out.

Counterpart of kubernetes_tpu/ops/solver.py `_preemption_pass` (its scan
body `pstep`, :948) over a `VictimTable`: the S lowest-priority accounted
pods of every node, ascending by (priority, pod key), with their requests
and an evictable bit (the host builds it: kubernetes_tpu_torch/preemption).
For each pod that is valid and unplaced after the scan and the gang mask,
in batch order:

- its candidates on a node are the slots that are evictable, not taken by
  an earlier pod of the batch, and of a priority strictly below its own
  (compared as int32);
- for k = 0..S it checks PodFitsResources (pods, cpu, memory, gpu and the
  scratch/overlay fallthrough) against the post-scan ledger plus the
  batch's earlier bookings less `freed_cum[k - 1]`, the requests of the
  candidate slots among the first k slots summed in slot order; the
  node's k is the least that fits, at most its candidate count, on a
  statically feasible node;
- the pod's node minimizes (the highest priority among its first k
  candidates, INT32_MIN for k = 0; k; the node's index);
- the node's bookings gain the pod's requests less `freed_cum[k - 1]`, and
  its first k candidates are taken;
- a gang group's bookings revert where the batch leaves the group if one
  of its taking-part members found no set, and after the pass every
  verdict of such a group is masked out.

As in the reference, k counts slots of the table, not candidates: a slot
that is not a candidate (protected, or taken) ahead of a candidate frees
nothing at its k, so a node whose first slot is taken or protected
reports no set its later candidates would give
(`tests/test_torch_preemption.py` pins the port to the reference there).

`preemption_pass` is the wrapper: on CUDA tensors it launches
csrc/preemption.cu (its header gives the design and the bound) and counts
the launch in `preemption_pass.launches`; on CPU tensors it computes
`preemption_pass_plain`, a PyTorch loop of the reference's step over the
pods, which the card's run holds the kernel against.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from kubernetes_tpu_torch.ops.predicates import fits_resources_dyn
from kubernetes_tpu_torch.state.layout import Resource
from kubernetes_tpu_torch.utils.device import check_tensor

INT32_MIN = -(2**31)
INT32_MAX = 2**31 - 1
# the kernel keeps a slot set in one 32-bit word, and packs k into 8 bits
# and the node index into 24 of its 64-bit key
MAX_SLOTS = 32
MAX_NODES = 1 << 24


@dataclass
class VictimTable:
    """Per-node preemption candidates (kubernetes_tpu/ops/solver.py:268):
    slots ascending by (priority, pod key), INT32_MAX priority and `ok`
    False on empty slots, `ok` False where a PodDisruptionBudget protects
    the pod. Tensors on the solver's device, or numpy arrays from
    `preemption.build_victim_table` (`state.convert.victims_from_numpy`
    carries them across)."""

    prio: torch.Tensor   # i32[N, S]
    req: torch.Tensor    # f32[N, S, R] device units (state/layout.py)
    ok: torch.Tensor     # bool[N, S]


def participants(valid: torch.Tensor, assignments: torch.Tensor) -> torch.Tensor:
    """bool[P]: the pods the pass takes: valid and unplaced after the scan
    and the gang mask (a pod of a reverted group, or one a predicate other
    than the resource fit refused, takes part too)."""
    return valid & (assignments < 0)


def group_runs(gang_id: torch.Tensor):
    """(first bool[P], seg i64[P]): where each run of equal gang_id starts,
    and each row's run index (a boundary cumsum)."""
    first = torch.ones(gang_id.shape, dtype=torch.bool, device=gang_id.device)
    first[1:] = gang_id[1:] != gang_id[:-1]
    return first, torch.cumsum(first.to(torch.int64), 0) - 1


def gang_verdict_mask(gang_id: torch.Tensor, part: torch.Tensor,
                      preempt_node: torch.Tensor, victim_count: torch.Tensor):
    """Every verdict of a group one of whose taking-part members found no
    set, out (kubernetes_tpu/ops/solver.py:1017-1034)."""
    p = gang_id.shape[0]
    _first, seg = group_runs(gang_id)
    n_part = torch.zeros((p,), dtype=torch.int64, device=gang_id.device)
    n_found = torch.zeros_like(n_part)
    n_part.index_add_(0, seg, part.to(torch.int64))
    n_found.index_add_(0, seg, (part & (preempt_node >= 0)).to(torch.int64))
    bad = (gang_id > 0) & (n_found[seg] < n_part[seg])
    return (torch.where(bad, -1, preempt_node),
            torch.where(bad, 0, victim_count))


def preemption_pass_plain(allocatable, base_requested, masked_static, requests,
                          priority, part, gang_id, victims: VictimTable,
                          use_gang: bool, tally: dict | None = None):
    """The reference's scan, a pod at a time, in plain PyTorch (the CPU path
    and the kernel's reference on the card). Returns (preempt_node i32[P],
    victim_count i32[P]). `tally`, if given, gains "fits": the (pod, node,
    k) fit checks the function needs on these inputs (a statically
    feasible node's checks up to its k, or up to its candidate count where
    none fits), for the bound of the kernel's run."""
    n, s = victims.prio.shape
    dev = base_requested.device
    static_ok = masked_static > float("-inf")
    extra = torch.zeros_like(base_requested)
    taken = torch.zeros((n, s), dtype=torch.bool, device=dev)
    snap_e, snap_t = extra, taken
    cur, bad = 0, False
    p = requests.shape[0]
    out_node = torch.full((p,), -1, dtype=torch.int32, device=dev)
    out_k = torch.zeros((p,), dtype=torch.int32, device=dev)
    ks = torch.arange(s + 1, dtype=torch.float32, device=dev)
    alloc_k = allocatable.repeat(s + 1, 1)
    v_prio, v_ok = victims.prio, victims.ok
    for i, (gid, takes_part, prio_p) in enumerate(zip(
            gang_id.tolist(), part.tolist(), priority.tolist())):
        if gid != cur:
            # settle the group being left, open the one entered
            if cur > 0 and bad:
                extra, taken = snap_e, snap_t
            if gid > 0:
                snap_e, snap_t = extra, taken
            bad, cur = False, gid
        if not takes_part:
            continue
        req_p = requests[i]
        cand = v_ok & ~taken & (v_prio < prio_p)
        cand_f = cand.to(torch.float32)
        rank = torch.cumsum(cand_f, 1)
        count = rank[:, -1]
        # freed_cum[:, j]: the candidates' requests among slots 0..j, summed
        # left to right in f32 as the kernel sums them
        freed = cand_f[:, :, None] * victims.req
        freed_cum = torch.empty_like(freed)
        acc = freed[:, 0]
        freed_cum[:, 0] = acc
        for j in range(1, s):
            acc = acc + freed[:, j]
            freed_cum[:, j] = acc
        ledger = base_requested + extra
        adj = torch.cat([ledger[None], ledger[None] - freed_cum.permute(1, 0, 2)])
        fit_k = fits_resources_dyn(alloc_k, req_p[None],
                                   adj.reshape(-1, adj.shape[-1]))[0].reshape(s + 1, n)
        s_ok = static_ok[i]
        ok_k = fit_k & (ks[:, None] <= count[None, :]) & s_ok[None, :]
        feas = ok_k.any(0)
        k_n = ok_k.to(torch.int32).argmax(0).to(torch.int32)
        if tally is not None:
            needed = torch.where(feas, k_n, torch.minimum(count, ks[-1]).to(torch.int32))
            tally["fits"] = tally.get("fits", 0) + int((needed + 1)[s_ok].sum())
        if not bool(feas.any()):
            bad = bad or gid > 0
            continue
        chosen = cand & (rank <= k_n[:, None].to(torch.float32))
        top = torch.where(chosen, v_prio, INT32_MIN).amax(1)
        tp = torch.where(feas, top, INT32_MAX)
        m1 = feas & (tp == tp.min())
        kk = torch.where(m1, k_n, INT32_MAX)
        m2 = m1 & (kk == kk.min())
        node = int(m2.to(torch.int32).argmax())
        k_sel = int(k_n[node])
        freed_sel = freed_cum[node, k_sel - 1] if k_sel > 0 else torch.zeros_like(req_p)
        extra = extra.clone()
        extra[node] = extra[node] + (req_p - freed_sel)
        taken = taken.clone()
        taken[node] |= chosen[node]
        out_node[i], out_k[i] = node, k_sel
    if use_gang:
        return gang_verdict_mask(gang_id, part, out_node, out_k)
    return out_node, out_k


_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
THREADS = 128   # the kernel's block: one node a thread a round


def preemption_pass(allocatable, base_requested, masked_static, requests,
                    priority, part, gang_id, victims: VictimTable,
                    use_gang: bool):
    """(preempt_node i32[P], victim_count i32[P]): the node whose first k
    candidates the pod would evict, and k; (-1, 0) for a pod without a set
    or outside the pass.

    Node side: allocatable and base_requested f32[N, R] (the post-scan
    ledger), victims (prio i32[N, S], req f32[N, S, R], ok bool[N, S]).
    Pod side: masked_static f32[P, N] (-inf where the pod is invalid or the
    node statically infeasible), requests f32[P, R], priority i32[P], part
    bool[P] (`participants`), gang_id i32[P] (0 = no group). `use_gang`
    masks reverted groups' verdicts after the pass."""
    n, s = victims.prio.shape
    p, r = requests.shape
    dev = requests.device
    f32, i32 = torch.float32, torch.int32
    for args in (("allocatable", allocatable, f32, (n, r)),
                 ("base_requested", base_requested, f32, (n, r)),
                 ("masked_static", masked_static, f32, (p, n)),
                 ("requests", requests, f32, (p, r)),
                 ("priority", priority, i32, (p,)),
                 ("part", part, torch.bool, (p,)),
                 ("gang_id", gang_id, i32, (p,)),
                 ("victims.prio", victims.prio, i32, (n, s)),
                 ("victims.req", victims.req, f32, (n, s, r)),
                 ("victims.ok", victims.ok, torch.bool, (n, s))):
        check_tensor(*args, dev)
    if dev.type == "cpu":
        return preemption_pass_plain(allocatable, base_requested, masked_static,
                                     requests, priority, part, gang_id, victims,
                                     use_gang)
    if dev.type != "cuda":
        raise ValueError(f"preemption_pass: unsupported device {dev}")
    if r != Resource.COUNT or s > MAX_SLOTS or n >= MAX_NODES:
        raise ValueError(f"preemption_pass: R={r} (the kernel takes "
                         f"{Resource.COUNT}), S={s} (at most {MAX_SLOTS}), "
                         f"N={n} (below {MAX_NODES})")
    from kubernetes_tpu_torch.native.build import load

    fn = load("preemption").ktpu_preemption_pass
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = max(1, min(sms, -(-n // THREADS)))
    out_node = torch.full((p,), -1, dtype=i32, device=dev)
    out_k = torch.zeros((p,), dtype=i32, device=dev)
    # the exchange: one 64-bit key and one arrival count a pod; the undo
    # log of the open group's bookings, P entries a block of (node, taken
    # slots, extra row)
    keys = torch.full((p,), -1, dtype=torch.int64, device=dev)
    arrive = torch.zeros((p,), dtype=i32, device=dev)
    undo = torch.empty((blocks, max(p, 1), 2 + r), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(allocatable.data_ptr(), base_requested.data_ptr(),
                 masked_static.data_ptr(), requests.data_ptr(),
                 priority.data_ptr(), part.data_ptr(), gang_id.data_ptr(),
                 victims.prio.data_ptr(), victims.req.data_ptr(),
                 victims.ok.data_ptr(), out_node.data_ptr(), out_k.data_ptr(),
                 keys.data_ptr(), arrive.data_ptr(), undo.data_ptr(),
                 p, n, s, blocks, stream)
    if err != 0:
        raise RuntimeError(f"preemption kernel launch failed: CUDA error {err}")
    preemption_pass.launches += 1
    if use_gang:
        return gang_verdict_mask(gang_id, part, out_node, out_k)
    return out_node, out_k


preemption_pass.launches = 0
