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


CLUSTER = 16       # the kernel's blocks, one cluster
THREADS = 512      # a block's threads
MAX_ENTRIES = 8    # verdicts a node keeps, one a class
SMEM_LIMIT = 232448   # an H100's opt-in shared memory a block
STATIC_SMEM = 2048    # the kernel's static shared memory, rounded up
# the kernel's node columns in placement order, and their bytes a node
# (cache: a verdict entry)
COLUMNS = ("avail", "cache", "extra", "alloc", "base", "prio")
MUTABLE = ("avail", "cache", "extra")
# a meta row's tag word: the class tag, its verdicts' entry in bits 24..31;
# its last word: the gang_id changes so far, IN_GROUP where gang_id > 0
# (csrc/preemption.cu)
TAG = (1 << 24) - 1
CHANGES, IN_GROUP = (1 << 30) - 1, 1 << 30


@dataclass(frozen=True)
class PreemptionLayout:
    """Kernel 3's launch geometry and placement (csrc/preemption.cu
    `layout_for` computes the same and refuses a launch that differs)."""

    nodes_thread: int     # nodes a thread (2, 8, or more past 65,536 nodes)
    nodes_block: int      # THREADS * nodes_thread, one block's range
    entries: int          # verdicts a node (the class cache)
    shared: tuple         # columns in shared memory
    shared_bytes: int     # dynamic shared memory a block
    arena_bytes: int      # a block's mutable columns in device memory
    l2: tuple             # read-only columns read through L2

    @property
    def shared_mask(self) -> int:
        return sum(1 << COLUMNS.index(c) for c in self.shared)


def preemption_layout(n: int, s: int, r: int = Resource.COUNT,
                      smem_limit: int = SMEM_LIMIT) -> PreemptionLayout:
    """Where kernel 3 keeps each node column for N nodes and S slots on a
    card with `smem_limit` bytes of shared memory a block: in column
    order, each goes to shared memory while it fits in the limit less the
    kernel's static part (the cache with as many entries as fit, up to
    MAX_ENTRIES, at least one); a mutable column that does not fit goes to
    the block's arena in device memory, a read-only one is read from the
    caller's tensor through L2, as the slots' requests always are. Raises
    ValueError for what the kernel does not take (R other than
    Resource.COUNT, S outside 1..32, N outside 1..2^24 - 1)."""
    if r != Resource.COUNT or not 1 <= s <= MAX_SLOTS or not 1 <= n < MAX_NODES:
        raise ValueError(f"preemption_pass: R={r} (the kernel takes "
                         f"{Resource.COUNT}), S={s} (1 to {MAX_SLOTS}), "
                         f"N={n} (1 to {MAX_NODES - 1})")
    per_block = -(-n // CLUSTER)
    run = -(-per_block // THREADS)
    run = 2 if run <= 2 else 8 if run <= 8 else run
    nb = THREADS * run
    budget = smem_limit - STATIC_SMEM
    # (the priorities' shared rows: S rounded up to 16 ints, swizzled)
    sizes = {"avail": 4 * nb, "extra": 4 * r * nb, "alloc": 4 * r * nb,
             "base": 4 * r * nb, "prio": 4 * (-(-s // 16) * 16) * nb}
    used = arena = 0
    entries = MAX_ENTRIES
    shared = []
    for c in COLUMNS:
        if c == "cache":
            fit = (budget - used) // (8 * nb)
            entries = min(fit, MAX_ENTRIES) if fit >= 1 else MAX_ENTRIES
            sizes[c] = 8 * nb * entries
        if used + sizes[c] <= budget:
            shared.append(c)
            used += sizes[c]
        elif c in MUTABLE:
            arena += sizes[c]
    l2 = tuple(c for c in COLUMNS if c not in shared and c not in MUTABLE) + ("req",)
    return PreemptionLayout(nodes_thread=run, nodes_block=nb, entries=entries,
                            shared=tuple(shared), shared_bytes=used,
                            arena_bytes=arena, l2=l2)


def card_smem_limit(dev) -> int:
    """The card's opt-in shared memory a block (SMEM_LIMIT where PyTorch
    does not report it)."""
    props = torch.cuda.get_device_properties(dev)
    return int(getattr(props, "shared_memory_per_block_optin", SMEM_LIMIT))


def pass_schedule(requests, priority, part, gang_id,
                  entries: int = MAX_ENTRIES) -> torch.Tensor:
    """i32[M, 4]: the taking-part pods in batch order as kernel 3 walks
    them, {pod, priority, tag | entry << 24, changes | IN_GROUP where
    gang_id > 0}: the plain version of csrc/preemption.cu
    `schedule_kernel`. The tag is 1 + the first pod of the batch with the
    same request bits and priority, its verdicts' entry (tag - 1) %
    `entries`; `changes` counts the gang_id changes in pods 0..pod (gang_id
    0 before the batch), so a group boundary lies between two taking-part
    pods wherever it moved."""
    dev = part.device
    p = part.shape[0]
    classes = torch.cat([requests.contiguous().view(torch.int32), priority[:, None]], 1)
    inverse = torch.unique(classes, dim=0, return_inverse=True)[1]
    first = torch.full((p,), p, dtype=torch.int64, device=dev).scatter_reduce(
        0, inverse, torch.arange(p, device=dev), "amin")
    prev = torch.cat([torch.zeros((1,), dtype=gang_id.dtype, device=dev), gang_id[:-1]])
    changes = torch.cumsum((gang_id != prev).to(torch.int64), 0)
    idx = torch.nonzero(part).flatten()
    first = first[inverse[idx]]
    return torch.stack([idx, priority[idx].to(torch.int64), (first + 1) | (first % entries) << 24,
                        changes[idx] | (gang_id[idx] > 0).to(torch.int64) * IN_GROUP],
                       1).to(torch.int32)


_ARGTYPES = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 3
             + [ctypes.c_void_p])


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
    if p >= MAX_NODES:   # a class tag takes 24 bits
        raise ValueError(f"preemption_pass: P={p} (below {MAX_NODES})")
    limit = card_smem_limit(dev)
    lay = preemption_layout(n, s, r, limit)
    from kubernetes_tpu_torch.native.build import load

    fn = load("preemption").ktpu_preemption_pass
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    # (the kernel's schedule fills the outputs with -1 and 0 first)
    out_node = torch.empty((p,), dtype=i32, device=dev)
    out_k = torch.empty((p,), dtype=i32, device=dev)
    # the walk's pod rows and their number (the kernel's schedule), each
    # block's undo log of the open group's bookings, one entry a pod of
    # (node, avail word, extra row), and the blocks' arena
    meta = torch.empty((max(p, 1), 4), dtype=i32, device=dev)
    m_count = torch.empty((1,), dtype=i32, device=dev)
    undo = torch.empty((CLUSTER, max(p, 1), 8), dtype=f32, device=dev)
    arena = torch.empty((CLUSTER * max(lay.arena_bytes, 1),), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(allocatable.data_ptr(), base_requested.data_ptr(),
                 masked_static.data_ptr(), requests.data_ptr(), priority.data_ptr(),
                 part.data_ptr(), gang_id.data_ptr(), victims.prio.data_ptr(),
                 victims.req.data_ptr(), victims.ok.data_ptr(), out_node.data_ptr(),
                 out_k.data_ptr(), meta.data_ptr(), m_count.data_ptr(), undo.data_ptr(),
                 arena.data_ptr(), p, n, s, lay.nodes_thread, lay.entries,
                 lay.shared_mask, lay.shared_bytes, lay.arena_bytes, limit, stream)
    if err != 0:
        raise RuntimeError(f"preemption kernel launch failed: CUDA error {err}")
    preemption_pass.launches += 1
    if use_gang:
        return gang_verdict_mask(gang_id, part, out_node, out_k)
    return out_node, out_k


preemption_pass.launches = 0
