"""Kernel 2 at 8 nodes a thread (kubernetes_tpu_torch/csrc/assign_scan.cu,
the builds that `node_run` gives 8 nodes a thread, N > 32,768) on the CPU.
The kernel runs only on a card; here numpy models of what its 8-node
design rests on are held against the port's plain terms and the JAX
package:
- the cached LeastRequested and BalancedAllocation, once the fit is
  applied, are integers in {-1, 0..10} and 0..10, so a run of 8 (lr, ba)
  pairs packs into bytes (the f32 2^23 + k has k in its low bits) and
  unpacks to the same f32 bits;
- the row copy: a block's segment of a masked_static row as coalesced
  16-byte copies of its aligned chunks and 4-byte copies of the rest (a
  tail of N % 4, or the whole segment of a row that starts unaligned)
  tiles the row exactly once, into a swizzled slot, and reads nothing past
  it;
- a thread's two 16-byte reads of the swizzled slot give its run in order
  and leave no two lanes of a quarter warp on one bank;
- schedule_batch with gang groups at a node count in the 8-node range
  equals JAX schedule_batch."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)
try:
    torch.set_num_interop_threads(1)
except RuntimeError:  # the interop pool already started in this process
    pass

from kubernetes_tpu.api import objects as jobj  # noqa: E402
from kubernetes_tpu.models.policy import DEFAULT_POLICY as J_POLICY  # noqa: E402
from kubernetes_tpu.ops import priorities as jprio  # noqa: E402
from kubernetes_tpu.ops import solver as jsolver  # noqa: E402
from kubernetes_tpu.state import Capacities as JCaps  # noqa: E402
from kubernetes_tpu.state import encode_cluster as j_encode_cluster  # noqa: E402

from kubernetes_tpu_torch.api import objects as obj  # noqa: E402
from kubernetes_tpu_torch.ops.assign_scan import CLUSTER, THREADS, node_run  # noqa: E402
from kubernetes_tpu_torch.ops.predicates import fits_resources_dyn  # noqa: E402
from kubernetes_tpu_torch.ops.priorities import (  # noqa: E402
    balanced_allocation,
    least_requested,
)
from kubernetes_tpu_torch.ops.solver import schedule_batch  # noqa: E402
from kubernetes_tpu_torch.state import Capacities, encode_cluster  # noqa: E402
from kubernetes_tpu_torch.state.convert import (  # noqa: E402
    batch_from_numpy,
    rr_from_numpy,
    state_from_numpy,
)

RUN = 8
NB = THREADS * RUN            # nodes of one block at 8 nodes a thread
LR_BIAS = np.float32(2 ** 23 + 1)
BA_BIAS = np.float32(2 ** 23)
BIAS_BITS = np.uint32(0x4B000000)


# ---- the cached terms as bytes

def random_ledger(rng, n, p):
    """allocatable [n, 6], requested [n, 6], nonzero [n, 2], requests
    [p, 6], nonzero requests [p, 2]: zero capacities, nodes already over
    capacity, all-zero requests, and capacities and requests that put the
    unused share exactly on .5 and on whole points (the half-up and floor
    edges)."""
    alloc = np.zeros((n, 6), np.float32)
    alloc[:, 0] = rng.integers(0, 12, n)
    alloc[:, 1] = rng.choice([0, 1, 3, 7, 10, 100, 1000, 2000, 4000, 3999], n)
    alloc[:, 2] = rng.choice([0, 2, 10, 1024, 2048, 8192, 16384, 12345], n)
    frac = rng.choice([0.0, 0.05, 0.25, 0.5, 0.75, 0.95, 1.0, 1.3], (n, 1))
    requested = np.floor(alloc * frac).astype(np.float32)
    nonzero = requested[:, 1:3] + rng.choice([0, 50, 100, 250], (n, 2))
    alloc[:RUN, 1:3] = 4000.0
    reqs = np.zeros((p, 6), np.float32)
    reqs[:, 0] = 1
    reqs[:, 1] = rng.choice([0, 1, 50, 100, 250, 500, 1000], p)
    reqs[:, 2] = rng.choice([0, 1, 128, 256, 512, 1024], p)
    reqs[rng.random(p) < 0.2, 1:] = 0.0                     # all-zero requests
    nz_reqs = np.stack([np.where(reqs[:, 1] > 0, reqs[:, 1], 100),
                        np.where(reqs[:, 2] > 0, reqs[:, 2], 200)], 1)
    nz_reqs[:2] = 0.0     # nothing requested on an empty node: LeastRequested 10
    nonzero[:RUN] = 0.0
    return alloc, requested, nonzero.astype(np.float32), reqs, nz_reqs.astype(np.float32)


def fitted_terms(alloc, requested, nonzero, reqs, nz_reqs):
    """The terms the kernel caches, [p, n] each: LeastRequested, -1 where
    the pod does not fit, and BalancedAllocation, 0 there; from the plain
    functions the port's scan uses."""
    a, r, z = (torch.from_numpy(x) for x in (alloc, requested, nonzero))
    q, nzq = torch.from_numpy(reqs), torch.from_numpy(nz_reqs)
    fit = fits_resources_dyn(a, q, r, dyn_gpu=False, dyn_storage=False)
    lr = torch.where(fit, least_requested(a, nzq, z), -1.0)
    ba = torch.where(fit, balanced_allocation(a, nzq, z), 0.0)
    return lr.numpy(), ba.numpy()


def pack_run(terms, bias):
    """A run of 8 terms as bytes (term + bias, its f32 low byte) in two
    u32 words, byte j % 4 of word j // 4, as the kernel packs them."""
    b = (np.asarray(terms, np.float32) + bias).view(np.uint32) & np.uint32(0xFF)
    return [np.uint32(b[4 * w] | b[4 * w + 1] << 8 | b[4 * w + 2] << 16
                      | b[4 * w + 3] << 24) for w in range(2)]


def unpack_run(words, bias):
    """The kernel's unpacking: byte j, under 2^23's bits, as f32 less bias."""
    out = np.empty(RUN, np.float32)
    for j in range(RUN):
        byte = (words[j // 4] >> np.uint32(8 * (j % 4))) & np.uint32(0xFF)
        out[j] = (np.uint32(BIAS_BITS | byte).view(np.float32) - bias).astype(np.float32)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_terms_are_small_integers_and_pack_exactly(seed):
    rng = np.random.default_rng(seed)
    alloc, requested, nonzero, reqs, nz_reqs = random_ledger(rng, 4 * RUN * 16, 24)
    lr, ba = fitted_terms(alloc, requested, nonzero, reqs, nz_reqs)
    assert np.array_equal(lr, np.floor(lr)) and np.array_equal(ba, np.trunc(ba))
    assert set(np.unique(lr)) <= set(range(-1, 11))
    assert set(np.unique(ba)) <= set(range(0, 11))
    # the edges were reached: no fit, 0 and 10 of both terms
    assert {-1, 0, 10} <= set(np.unique(lr)) and {0, 10} <= set(np.unique(ba))
    for p in range(lr.shape[0]):
        for c0 in range(0, lr.shape[1], RUN):
            for terms, bias in ((lr[p, c0:c0 + RUN], LR_BIAS), (ba[p, c0:c0 + RUN], BA_BIAS)):
                got = unpack_run(pack_run(terms, bias), bias)
                assert np.array_equal(got.view(np.uint32), terms.view(np.uint32))


@pytest.mark.parametrize("seed", [3, 4])
def test_terms_equal_jax_priorities(seed):
    """The plain terms the packing is held against are JAX's, bit for bit."""
    rng = np.random.default_rng(seed)
    alloc, _requested, nonzero, _reqs, nz_reqs = random_ledger(rng, 256, 6)
    a, z = torch.from_numpy(alloc), torch.from_numpy(nonzero)
    for p in range(nz_reqs.shape[0]):
        nzq = torch.from_numpy(nz_reqs[p:p + 1])
        state = types.SimpleNamespace(allocatable=jnp.asarray(alloc),
                                      nonzero_requested=jnp.asarray(nonzero))
        pod = types.SimpleNamespace(nonzero_requests=jnp.asarray(nz_reqs[p]))
        for port, ref in ((least_requested, jprio.least_requested),
                          (balanced_allocation, jprio.balanced_allocation)):
            got = port(a, nzq, z)[0].numpy()
            want = np.asarray(ref(state, pod))
            assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_owner_byte_update_touches_one_byte():
    """The owner rewrites byte j of its packed word at a run-time shift and
    leaves the other seven terms as they were."""
    rng = np.random.default_rng(5)
    for _ in range(200):
        terms = rng.integers(-1, 11, RUN).astype(np.float32)
        words = pack_run(terms, LR_BIAS)
        j = int(rng.integers(0, RUN))
        new = np.float32(rng.integers(-1, 11))
        b = np.uint32((np.float32(new + LR_BIAS)).view(np.uint32) & 0xFF)
        sh = np.uint32(8 * (j % 4))
        w = words[j // 4]
        words[j // 4] = np.uint32((w & ~(np.uint32(0xFF) << sh)) | (b << sh))
        terms[j] = new
        assert np.array_equal(unpack_run(words, LR_BIAS), terms)


# ---- the row copy of one block and the run's read

def slot_at(i):
    """Where entry i of a block's row segment sits in its ring slot: 16-byte
    chunk c at c ^ ((c >> 3) & 1)."""
    return i ^ (((i >> 5) & 1) << 2)


def row_copies(addr, n, p, rank):
    """The copies block `rank` issues for row p of a [P, n] f32
    masked_static whose first element lies at byte `addr`, as the kernel's
    issue_row decides them: (thread, first node, entries, slot entry)
    arrays, 16-byte copies of 4 entries (chunk i // 4 by thread i // 4 %
    THREADS) and 4-byte copies of one (entry i by thread i % THREADS)."""
    lo = rank * NB
    length = max(min(n - lo, NB), 0)
    aligned = (addr + 4 * (p * n + lo)) % 16 == 0
    n16 = length & ~3 if aligned else 0
    wide = 4 * np.arange(NB // 4)
    wide = wide[wide < n16]
    one = np.arange(NB)
    one = one[(one >= n16) & (one < length)]
    i = np.concatenate([wide, one])
    thread = np.concatenate([wide // 4, one]) % THREADS
    count = np.concatenate([np.full(wide.size, 4), np.ones(one.size, int)])
    return thread, lo + i, count, slot_at(i)


def node_counts():
    rng = np.random.default_rng(6)
    lo, hi = CLUSTER * THREADS * 4 + 1, CLUSTER * THREADS * 8
    picks = [lo, lo + 1, lo + 2, lo + 3, 40000, 40001, 50002, 65535, hi]
    picks += [int(x) for x in rng.integers(lo, hi + 1, 8)]
    return sorted(set(picks))


@pytest.mark.parametrize("n", node_counts())
def test_row_copies_tile_the_row(n):
    assert node_run(n) == RUN
    for addr in (0, 4, 8, 12):      # a base at each 16-byte phase
        for p in (0, 1, 2, 3, 7):
            seen = np.zeros(n, np.int32)
            for rank in range(CLUSTER):
                _t, g, count, at = row_copies(addr, n, p, rank)
                wide = count == 4   # both ends of a 16-byte copy aligned
                assert ((addr + 4 * (p * n + g[wide])) % 16 == 0).all()
                assert (at[wide] % 4 == 0).all()
                assert (g >= rank * NB).all() and (g + count <= min((rank + 1) * NB, n)).all()
                cover = np.concatenate([g[wide, None] + np.arange(4), g[~wide, None]], None)
                slots = np.concatenate([at[wide, None] + np.arange(4), at[~wide, None]], None)
                np.add.at(seen, cover, 1)
                assert np.unique(slots).size == slots.size   # no slot entry written twice
            # every node of the row once, nothing past the row's end
            assert np.array_equal(seen, np.ones(n, np.int32))


def test_aligned_rows_copy_at_most_a_tail_of_4_byte_entries():
    for n in (40000, 40001, 50002, 65535, 65536):
        for rank in range(CLUSTER):
            ones = int((row_copies(0, n, 0, rank)[2] == 1).sum())
            assert ones == (n % 4 if rank * NB < n <= (rank + 1) * NB else 0)


def test_blocks_past_the_nodes_copy_nothing():
    n = 40000     # blocks 10-15 hold no node
    for rank in range(CLUSTER):
        assert (row_copies(0, n, 1, rank)[1].size == 0) == (rank * NB >= n)


def run_reads(lane, t):
    """The slot entries of thread t's two 16-byte reads, in issue order: the
    first chunk of the run 4 entries on in lanes 4-7 of each eight."""
    sw = ((lane >> 2) & 1) << 2
    return 8 * t + sw, 8 * t + 4 - sw


def test_run_read_returns_the_run_in_order():
    segment = np.arange(NB, dtype=np.float32)
    slot = np.empty(NB, np.float32)
    slot[[slot_at(i) for i in range(NB)]] = segment    # as the copies lay it out
    for t in range(THREADS):
        first, second = run_reads(t % 32, t)
        run = np.concatenate([slot[first:first + 4], slot[second:second + 4]])
        assert np.array_equal(run, segment[8 * t:8 * t + 8])


@pytest.mark.parametrize("swizzled", [True, False])
def test_run_read_has_no_bank_conflict(swizzled):
    """Eight lanes of a quarter warp share a 16-byte read's wavefront: the
    swizzled layout puts their 32 words on 32 banks; the plain one (the
    first chunk at word 8t) puts two on each of 16."""
    for warp in range(THREADS // 32):
        for issue in (0, 1):
            for q in range(4):
                banks = []
                for lane in range(8 * q, 8 * q + 8):
                    t = 32 * warp + lane
                    start = run_reads(lane, t)[issue] if swizzled else 8 * t + 4 * issue
                    banks += [(start + w) % 32 for w in range(4)]
                worst = max(banks.count(b) for b in set(banks))
                assert worst == (1 if swizzled else 2)


# ---- schedule_batch with gang groups in the 8-node range

N_RUN8, P_RUN8 = 33000, 16
GANG_ONLY = jsolver.BatchFlags(*(f == "gang" for f in (
    "ipa", "spread", "svcanti", "vol", "attach", "tt", "na", "ports", "gpu",
    "storage", "gang", "preempt")))


def mk_node(name, cpu, mem, pods):
    return {"metadata": {"name": name},
            "status": {"allocatable": {"cpu": cpu, "memory": mem, "pods": pods},
                       "conditions": [{"type": "Ready", "status": "True"}]}}


def mk_pod(name, cpu, mem):
    return {"metadata": {"name": name},
            "spec": {"containers": [{"name": "c", "resources": {
                "requests": {"cpu": cpu, "memory": mem}}}]}}


def test_schedule_batch_gang_at_8_nodes_a_thread_equals_jax():
    rng = np.random.default_rng(7)
    nodes = [mk_node(f"n{i}", str(int(rng.integers(1, 5))),
                     f"{int(rng.integers(1, 9))}Gi", str(int(rng.integers(1, 4))))
             for i in range(48)]
    pods = [mk_pod(f"p{k}", f"{int(rng.choice([100, 500, 1500]))}m",
                   f"{int(rng.choice([128, 1024, 4096]))}Mi") for k in range(P_RUN8)]
    # a group that fits, non-gang pods, a group whose quorum cannot be met
    gang_ids = [1, 1, 1, 1, 0, 0, 2, 2, 2, 2, 2, 2, 0, 3, 3, 3]
    gang_mins = [4, 4, 4, 4, 0, 0, 6, 6, 6, 6, 6, 6, 0, 3, 3, 3]
    pods[8] = mk_pod("big", "64", "1Gi")      # group 2 cannot place this member
    caps = Capacities(num_nodes=N_RUN8, batch_pods=P_RUN8)
    jcaps = JCaps(num_nodes=N_RUN8, batch_pods=P_RUN8)
    assert node_run(caps.num_nodes) == RUN
    state, batch, _ = encode_cluster([obj.Node.from_dict(d) for d in nodes],
                                     [obj.Pod.from_dict(d) for d in pods], caps)
    jstate, jbatch, _ = j_encode_cluster([jobj.Node.from_dict(d) for d in nodes],
                                         [jobj.Pod.from_dict(d) for d in pods], jcaps)
    for b in (batch, jbatch):
        b.gang_id[:] = np.asarray(gang_ids, np.int32)
        b.gang_min[:] = np.asarray(gang_mins, np.int32)
    rr = 5
    got = schedule_batch(state_from_numpy(state, "cpu"), batch_from_numpy(batch, "cpu"), rr)
    want = jax.jit(lambda s, b, r: jsolver.schedule_batch(
        s, b, r, J_POLICY, flags=GANG_ONLY))(jstate, jbatch, np.uint32(rr))
    for name in ("assignments", "scores", "feasible_counts", "new_requested",
                 "new_nonzero"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert int(got.rr_end) == rr_from_numpy(want.rr_end)
    assigned = got.assignments.numpy()
    assert (assigned[6:12] == -1).all() and (assigned[:4] >= 0).all()
