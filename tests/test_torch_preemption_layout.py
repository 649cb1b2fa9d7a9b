"""Kernel 3's placement and walk on the CPU: `preemption_layout` (the one
function the wrapper, chip_smoke.py and csrc/preemption.cu's `layout_for`
compute the launch geometry with) at the preemption cell's and the wide
check's sizes, at S = 32, at the largest N and at its refusals;
`pass_schedule` (the taking-part pods the kernel walks, their class tags
and group boundaries) against a loop over the batch; and a numpy model of
the kernel's walk (the compacted pods, the per-node verdict cache direct
mapped by class, evaluated again on a booking and cleared on a revert,
the undo log) held
against the plain pass and JAX `_preemption_pass`, with class churn past
the cache's entries and with gang reverts whose restored nodes must be
evaluated again."""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)
try:
    torch.set_num_interop_threads(1)
except RuntimeError:  # the interop pool already started in this process
    pass

from kubernetes_tpu.ops.solver import VictimTable as JVictimTable  # noqa: E402
from kubernetes_tpu.ops.solver import _preemption_pass  # noqa: E402

from kubernetes_tpu_torch.ops.preemption import (  # noqa: E402
    CHANGES,
    COLUMNS,
    IN_GROUP,
    MAX_ENTRIES,
    MAX_NODES,
    SMEM_LIMIT,
    STATIC_SMEM,
    TAG,
    THREADS,
    VictimTable,
    pass_schedule,
    preemption_layout,
    preemption_pass,
    preemption_pass_plain,
)
from kubernetes_tpu_torch.perf import harness  # noqa: E402
from tests.test_torch_preemption import _post_scan_inputs  # noqa: E402

R = 6
INT32_MIN = -(2**31)


# ---- the placement function ----

def test_layout_at_the_preemption_cell():
    """N = 16,384, S = 16: 2 nodes a thread, every column but the slots'
    requests in shared memory with all 8 verdicts, nothing in the arena."""
    lay = preemption_layout(16384, 16)
    assert (lay.nodes_thread, lay.nodes_block, lay.entries) == (2, 1024, MAX_ENTRIES)
    assert lay.shared == COLUMNS and lay.l2 == ("req",) and lay.arena_bytes == 0
    assert lay.shared_bytes == 1024 * (4 + 8 * 8 + 3 * 4 * R + 4 * 16) == 208896
    assert lay.shared_mask == (1 << len(COLUMNS)) - 1


def test_layout_at_the_wide_check():
    """N = 65,536, S = 16: 8 nodes a thread, the avail words and 6 verdicts
    shared, the bookings in the arena, the read-only columns through L2
    (the wide check in chip_smoke.py asserts this path)."""
    lay = preemption_layout(65536, 16)
    assert (lay.nodes_thread, lay.nodes_block, lay.entries) == (8, 4096, 6)
    assert lay.shared == ("avail", "cache")
    assert lay.l2 == ("alloc", "base", "prio", "req")
    assert lay.arena_bytes == 4 * R * 4096
    assert lay.shared_bytes == 4096 * (4 + 8 * 6) <= SMEM_LIMIT - STATIC_SMEM


def test_layout_at_32_slots():
    """S = 32 at N = 16,384: the slot priorities no longer fit beside the
    rest and are read through L2."""
    lay = preemption_layout(16384, 32)
    assert lay.entries == MAX_ENTRIES and "prio" in lay.l2
    assert lay.shared == ("avail", "cache", "extra", "alloc", "base")
    assert lay.shared_bytes == 1024 * (4 + 8 * 8 + 3 * 4 * R) <= SMEM_LIMIT - STATIC_SMEM


def test_layout_at_the_largest_n():
    """N = 2^24 - 1 (the key's node field): a run-time count of nodes a
    thread, every mutable column in the arena, nothing shared."""
    lay = preemption_layout(MAX_NODES - 1, 16)
    assert lay.nodes_thread * THREADS * 16 >= MAX_NODES - 1
    assert lay.nodes_thread not in (2, 8) and lay.shared == () and lay.shared_bytes == 0
    assert lay.arena_bytes == lay.nodes_block * (4 + 8 * MAX_ENTRIES + 4 * R)


@pytest.mark.parametrize("n, s, r", [(MAX_NODES, 16, R), (16384, 33, R), (16384, 0, R),
                                     (16384, 16, 5), (16384, 16, 7), (0, 16, R)])
def test_layout_refuses_what_the_kernel_does_not_take(n, s, r):
    with pytest.raises(ValueError):
        preemption_layout(n, s, r)


@pytest.mark.parametrize("n", [1, 8191, 16384, 16385, 40000, 65536, 65537, 250000])
def test_layout_fits_and_covers_the_nodes(n):
    """Every layout covers its nodes with 16 blocks, stays within the card's
    limit less the static part, and keeps at least one verdict a node."""
    for limit in (SMEM_LIMIT, 101376):
        lay = preemption_layout(n, 16, R, limit)
        assert 16 * lay.nodes_block >= n and lay.nodes_block == THREADS * lay.nodes_thread
        assert lay.shared_bytes <= limit - STATIC_SMEM and 1 <= lay.entries <= MAX_ENTRIES
        assert set(lay.shared) | set(lay.l2) >= {"alloc", "base", "prio"}


# ---- the walk's rows ----

def schedule_loop(requests, priority, part, gang_id, entries):
    """pass_schedule by a loop over the batch: the gang_id changes so far,
    and the first pod with the same request bits and priority."""
    rows, first, changes, cur = [], {}, 0, 0
    for i in range(len(part)):
        gid = int(gang_id[i])
        if gid != cur:
            changes, cur = changes + 1, gid
        key = (requests[i].tobytes(), int(priority[i]))
        first.setdefault(key, i)
        if part[i]:
            rows.append([i, int(priority[i]), first[key] + 1 | (first[key] % entries) << 24,
                         changes | (IN_GROUP if gid > 0 else 0)])
    return np.array(rows, np.int64).reshape(-1, 4)


@pytest.mark.parametrize("seed, entries", [(0, 8), (1, 3), (2, 6)])
def test_pass_schedule_equals_a_loop_over_the_batch(seed, entries):
    rng = np.random.RandomState(seed)
    p = 40
    req = np.zeros((p, R), np.float32)
    req[:, 1] = rng.choice([0.0, -0.0, 500.0, 1000.0], p)
    prio = rng.choice([0, 5, 1000], p).astype(np.int32)
    part = rng.rand(p) < 0.6
    gid = np.repeat(np.arange(p // 3 + 1), 3)[:p].astype(np.int32)
    gid[rng.rand(p) < 0.3] = 0
    got = pass_schedule(torch.from_numpy(req), torch.from_numpy(prio),
                        torch.from_numpy(part), torch.from_numpy(gid), entries).numpy()
    np.testing.assert_array_equal(got, schedule_loop(req, prio, part, gid, entries))


# ---- a model of the kernel's walk ----

def fits(a, r, led, all_zero):
    """csrc/preemption.cu `fits`, in f32."""
    f = np.float32
    if not led[0] + f(1.0) <= a[0]:
        return False
    if all_zero:
        return True
    basic = a[1] >= r[1] + led[1] and a[2] >= r[2] + led[2] and a[3] >= r[3] + led[3]
    if a[5] == 0:
        storage = a[4] >= (r[4] + r[5]) + (led[5] + led[4])
    else:
        storage = a[4] >= r[4] + led[4] and a[5] >= r[5] + led[5]
    return basic and storage


def eval_node(ops, node, prio_p, r):
    """csrc/preemption.cu `eval_node`: (k or -1, F_k, chosen slots, top)."""
    live = ops["avail"][node]
    s = ops["prio"].shape[1]
    cand = [bool((live >> j) & 1) and ops["prio"][node, j] < prio_p for j in range(s)]
    led = ops["base"][node] + ops["extra"][node]
    F = np.zeros(R, np.float32)
    all_zero = not r[1:].any()
    k = -1
    for kk in range(sum(cand) + 1):
        if kk > 0 and cand[kk - 1]:
            F = F + ops["req"][node, kk - 1]
        if fits(ops["alloc"][node], r, led - F if kk else led, all_zero):
            k = kk
            break
    chosen = [j for j in range(s) if cand[j]][:max(k, 0)]
    top = max((int(ops["prio"][node, j]) for j in chosen), default=INT32_MIN)
    return k, F, chosen, top


def kernel_model(args, entries, clear_on_revert=True, stats=None):
    """The kernel's walk: the taking-part pods of `pass_schedule`, each
    node's verdicts direct mapped by class tag, a verdict reused while its
    tag matches; a booked node's verdicts evaluated again at once (the
    next pod's class, this pod's and those its entries held), a node a
    revert restores (unless told not to) cleared. Returns the raw
    (preempt_node, victim_count)."""
    alloc, base, masked, req, prio, part, gid, victims = args
    s = victims.prio.shape[1]
    ok = victims.ok.numpy()
    ops = {"alloc": alloc.numpy(), "base": base.numpy(), "prio": victims.prio.numpy(),
           "req": victims.req.numpy(), "extra": np.zeros_like(base.numpy()),
           "avail": [int((ok[n] * (1 << np.arange(s))).sum()) for n in range(len(ok))]}
    n = len(ok)
    ms, rq = masked.numpy(), req.numpy()
    cache = [[None] * entries for _ in range(n)]
    out_node = np.full(len(part), -1, np.int32)
    out_k = np.zeros(len(part), np.int32)
    log, bad, in_group, changes = [], False, False, 0
    stats = {} if stats is None else stats
    rows = [[pod, p, z & TAG, w] for pod, p, z, w in
            pass_schedule(req, prio, part, gid, entries).tolist()]
    prio_np = prio.numpy()
    for i, (pod, prio_p, tag, word) in enumerate(rows):
        if word & CHANGES != changes:
            changes = word & CHANGES
            if in_group and bad:
                for node, avail, extra in reversed(log):
                    ops["avail"][node], ops["extra"][node] = avail, extra
                    if clear_on_revert:
                        cache[node] = [None] * entries
                    stats["restored"] = stats.get("restored", set()) | {node}
            log, bad, in_group = [], False, bool(word & IN_GROUP)
        e = (tag - 1) % entries
        best = None
        for node in range(n):
            if not ms[pod, node] > -np.inf:
                continue
            w = cache[node][e]
            if w is None or w[0] != tag:
                k, _F, _c, top = eval_node(ops, node, prio_p, rq[pod])
                w = cache[node][e] = (tag, k, top)
                stats["evals"] = stats.get("evals", 0) + 1
            if w[1] >= 0 and (best is None or (w[2], w[1], node) < best):
                best = (w[2], w[1], node)
        if best is None:
            bad = bad or in_group
            continue
        _top, k, node = best
        stats["picked"] = stats.get("picked", []) + [node]
        out_node[pod], out_k[pod] = node, k
        k2, F, chosen, _ = eval_node(ops, node, prio_p, rq[pod])
        assert k2 == k
        if in_group:
            log.append((node, ops["avail"][node], ops["extra"][node].copy()))
        ops["extra"][node] = ops["extra"][node] + (rq[pod] - F)
        ops["avail"][node] &= ~sum(1 << j for j in chosen)
        # the node's entries evaluated again at the booking: the next
        # pod's class where it maps, this pod's, else the class an entry
        # held (from its first pod's row)
        old, cache[node] = cache[node], [None] * entries
        nxt = rows[i + 1] if i + 1 < len(rows) else None
        for c in range(entries):
            if nxt is not None and c == (nxt[2] - 1) % entries:
                cls = (nxt[2], nxt[1], rq[nxt[0]])
            elif c == e:
                cls = (tag, prio_p, rq[pod])
            elif old[c] is not None:
                cls = (old[c][0], int(prio_np[old[c][0] - 1]), rq[old[c][0] - 1])
            else:
                continue
            k3, _F, _c, top = eval_node(ops, node, cls[1], cls[2])
            cache[node][c] = (cls[0], k3, top)
    return torch.from_numpy(out_node), torch.from_numpy(out_k)


def churned(args, rng, classes):
    """`args` with each pod's (cpu request, priority) drawn from `classes`
    distinct pairs."""
    alloc, base, masked, req, prio, part, gid, victims = args
    p = req.shape[0]
    pairs = [(c, q) for c in (0.0, 250.0, 500.0, 750.0, 1000.0, 2000.0) for q in range(8)]
    pick = rng.choice(len(pairs), classes, replace=False)[rng.randint(0, classes, p)]
    req = req.clone()
    req[:, 1] = torch.tensor([pairs[i][0] for i in pick])
    prio = torch.tensor([pairs[i][1] for i in pick], dtype=torch.int32)
    return alloc, base, masked, req, prio, part, gid, victims


@pytest.mark.parametrize("entries", [1, 2, 6, 8])
@pytest.mark.parametrize("gang", [False, True], ids=["plain", "gang"])
@pytest.mark.parametrize("classes", [3, 20])
def test_kernel_walk_equals_the_plain_pass(entries, gang, classes):
    """The model of the kernel's walk equals the plain pass (raw verdicts,
    and masked where the batch has groups) on random post-scan operands,
    with fewer and with more classes than the cache has entries."""
    rng = np.random.RandomState(entries * 7 + gang + classes)
    args = churned(_post_scan_inputs(rng, 48, 40, 8, gang), rng, classes)
    stats = {}
    got = kernel_model(args, entries, stats=stats)
    want = preemption_pass_plain(*args, False)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (got[0] >= 0).any()
    n_feasible = int((args[2][args[5]] > float("-inf")).sum())
    if classes <= entries:   # cached verdicts reused
        assert stats["evals"] < n_feasible
    if classes > entries:
        assert stats["evals"] > 48


def test_kernel_walk_equals_jax_on_the_gang_batch():
    """The model against JAX `_preemption_pass` itself, gang mask on."""
    from kubernetes_tpu_torch.ops.preemption import gang_verdict_mask

    rng = np.random.RandomState(5)
    args = _post_scan_inputs(rng, 40, 24, 8, True)
    alloc, base, masked, req, prio, part, gid, victims = args
    got = gang_verdict_mask(gid, part, *kernel_model(args, 2))

    def jax_pass(a, valid, rq, pr, g, ms, b, vp, vr, vo):
        state = SimpleNamespace(allocatable=a)
        batch = SimpleNamespace(valid=valid, requests=rq, priority=pr, gang_id=g)
        return _preemption_pass(state, batch, ms, jax.numpy.full((24,), -1), b,
                                JVictimTable(prio=vp, req=vr, ok=vo), True)

    want = jax.jit(jax_pass)(*(x.numpy() for x in (
        alloc, part, req, prio, gid, masked, base, victims.prio, victims.req, victims.ok)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_gang_revert_needs_the_restored_nodes_evaluated_again():
    """The preemption cell's gang variant at 256 nodes: a group reverts, a
    later pod picks a node the revert restored, and a walk that kept the
    restored nodes' verdicts would differ from the plain pass there (the
    card's gang check holds the kernel on the same kind of batch)."""
    inputs = harness.preemption_pass_inputs(
        *harness.preemption_cluster(256, "gang", device="cpu"))
    args = inputs.args()
    want = preemption_pass_plain(*args, False)
    stats = {}
    got = kernel_model(args, MAX_ENTRIES, stats=stats)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert stats["restored"]
    assert set(stats["picked"]) & stats["restored"]
    stale = kernel_model(args, MAX_ENTRIES, clear_on_revert=False)
    assert not all(torch.equal(a, b) for a, b in zip(stale, want))


def test_wrapper_on_cpu_takes_no_layout():
    """On CPU tensors the wrapper is the plain pass whatever the shapes the
    kernel would take (a 40-slot table), and counts no launch."""
    rng = np.random.RandomState(9)
    alloc, base, masked, req, prio, part, gid, victims = _post_scan_inputs(rng, 20, 8, 4)
    wide = VictimTable(prio=victims.prio.repeat(1, 10), req=victims.req.repeat(1, 10, 1),
                       ok=victims.ok.repeat(1, 10))
    launches = preemption_pass.launches
    args = (alloc, base, masked, req, prio, part, gid, wide)
    for a, b in zip(preemption_pass(*args, False), preemption_pass_plain(*args, False)):
        assert torch.equal(a, b)
    assert preemption_pass.launches == launches
