"""kubernetes_tpu_torch kernels' plain versions against the reference: the
fused static mask against the Pallas `fused_static_mask` (interpret mode)
and the composed XLA `_static_mask`, and the assignment scan against the
reference solver's scan on the same Phase-A input. Exact equality: every
value compared is a bool, an integer or an integer-valued float. Also the
wrappers' input checks and their CPU path (no launch counted)."""

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

from kubernetes_tpu.models.policy import DEFAULT_POLICY as J_POLICY  # noqa: E402
from kubernetes_tpu.ops import predicates as jpreds  # noqa: E402
from kubernetes_tpu.ops import solver as jsolver  # noqa: E402
from kubernetes_tpu.ops.pallas_kernels import fused_static_mask  # noqa: E402

from kubernetes_tpu_torch.models.policy import DEFAULT_POLICY  # noqa: E402
from kubernetes_tpu_torch.ops import predicates as preds  # noqa: E402
from kubernetes_tpu_torch.ops import solver  # noqa: E402
from kubernetes_tpu_torch.ops.assign_scan import (  # noqa: E402
    assign_scan,
    assign_scan_plain,
)
from kubernetes_tpu_torch.ops.static_mask import (  # noqa: E402
    node_bits,
    static_mask,
    static_mask_plain,
)
from kubernetes_tpu_torch.state.convert import (  # noqa: E402
    batch_from_numpy,
    state_from_numpy,
)
from tests.test_torch_state import encode_both, random_cluster  # noqa: E402


def _inputs(seed):
    rng = np.random.RandomState(seed)
    nodes, pods = random_cluster(rng, 48, 16)
    _, (jstate, jbatch, _) = encode_both(nodes, pods)
    return jstate, jbatch, state_from_numpy(jstate, "cpu"), batch_from_numpy(jbatch, "cpu")


def _mask_args(state, batch):
    return (batch.sel_onehot, batch.sel_count, preds.untolerated(state, batch),
            batch.best_effort, batch.node_name_lo, batch.node_name_hi,
            state.sel_member, state.taint_hard_member, node_bits(state),
            state.name_lo, state.name_hi)


@pytest.mark.parametrize("seed", range(3))
def test_static_mask_matches_pallas_and_composed(seed):
    jstate, jbatch, state, batch = _inputs(seed)
    untol = jax.vmap(lambda p: 1.0 - jpreds._tolerated_universe(jstate, p)
                     .astype(jnp.float32))(jbatch)
    want_fused = np.asarray(fused_static_mask(
        jstate, jbatch.sel_onehot, jbatch.sel_count, untol, jbatch.best_effort,
        jbatch.node_name_lo, jbatch.node_name_hi, interpret=True))
    got = static_mask_plain(*_mask_args(state, batch))
    np.testing.assert_array_equal(got.numpy(), want_fused)
    assert want_fused.any() and not want_fused.all()

    # fused kernel + the XLA remainder == the composed predicate chain
    want_composed = np.asarray(jax.vmap(
        lambda p: jsolver._static_mask(jstate, p, J_POLICY))(jbatch))
    rest = solver._static_rest(state, batch, DEFAULT_POLICY)
    np.testing.assert_array_equal((got & rest).numpy(), want_composed)
    # and the port's own predicate functions compose to the same mask
    composed = (state.valid[None, :] & preds.node_schedulable(state, batch)
                & preds.fits_host(state, batch)
                & preds.match_node_selector(state, batch)
                & preds.tolerates_node_taints(state, batch)
                & preds.check_node_condition(state, batch)
                & preds.check_memory_pressure(state, batch)
                & preds.check_disk_pressure(state, batch)
                & preds.volume_zone(state, batch) & preds.volume_node(state, batch))
    np.testing.assert_array_equal(composed.numpy(), want_composed)


def test_static_mask_wrapper_on_cpu_is_the_plain_version():
    _, _, state, batch = _inputs(11)
    before = static_mask.launches
    args = _mask_args(state, batch)
    assert torch.equal(static_mask(*args), static_mask_plain(*args))
    assert static_mask.launches == before


def test_static_mask_wrapper_checks_inputs():
    _, _, state, batch = _inputs(12)
    args = list(_mask_args(state, batch))
    bad = list(args)
    bad[0] = args[0].double()
    with pytest.raises(TypeError, match="sel_onehot"):
        static_mask(*bad)
    bad = list(args)
    bad[6] = args[6][:, :-1]
    with pytest.raises(ValueError, match="sel_member"):
        static_mask(*bad)
    bad = list(args)
    bad[1] = args[1].to("meta")
    with pytest.raises(ValueError, match="sel_count"):
        static_mask(*bad)
    bad = list(args)
    bad[2] = torch.zeros(args[2].shape[::-1]).T
    with pytest.raises(ValueError, match="contiguous"):
        static_mask(*bad)


def _phase_a(state, batch):
    flags = solver.BatchFlags(*([False] * 12))
    g = solver.check_supported(DEFAULT_POLICY, flags)
    return solver.masked_static_scores(state, batch, DEFAULT_POLICY, g,
                                       static_mask_plain)


@pytest.mark.parametrize("seed, rr", [(0, 0), (1, 7), (2, 2**32 - 2)])
def test_assign_scan_matches_reference_scan(seed, rr):
    jstate, jbatch, state, batch = _inputs(seed)
    flags = jsolver.BatchFlags(*([False] * 12))
    want = jsolver.schedule_batch(jstate, jbatch, np.uint32(rr), J_POLICY,
                                  flags=flags)
    masked = _phase_a(state, batch)
    got = assign_scan(masked, batch.requests, batch.nonzero_requests,
                      state.allocatable, state.requested,
                      state.nonzero_requested, rr)
    np.testing.assert_array_equal(got.assignments.numpy(),
                                  np.asarray(want.assignments))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    np.testing.assert_array_equal(got.feasible_counts.numpy(),
                                  np.asarray(want.feasible_counts))
    np.testing.assert_array_equal(got.new_requested.numpy(),
                                  np.asarray(want.new_requested))
    np.testing.assert_array_equal(got.new_nonzero.numpy(),
                                  np.asarray(want.new_nonzero))
    assert int(got.rr_end) == int(want.rr_end)
    assert (np.asarray(want.assignments) >= 0).any()


def test_assign_scan_wrapper_on_cpu_is_the_plain_version():
    _, _, state, batch = _inputs(13)
    masked = _phase_a(state, batch)
    args = (masked, batch.requests, batch.nonzero_requests, state.allocatable,
            state.requested, state.nonzero_requested, torch.tensor(5))
    before = assign_scan.launches
    a, b = assign_scan(*args), assign_scan_plain(*args)
    for name in ("assignments", "scores", "feasible_counts", "new_requested",
                 "new_nonzero", "rr_end"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert assign_scan.launches == before
    # the batch-start ledger is not modified
    assert torch.equal(state.requested, state_from_numpy(
        _inputs(13)[0], "cpu").requested)
    with pytest.raises(ValueError, match="nonzero_requests"):
        assign_scan(masked, batch.requests, batch.requests, state.allocatable,
                    state.requested, state.nonzero_requested, 0)


@pytest.mark.parametrize("n", [1, 1000, 1024, 3000, 16384, 65536])
def test_assign_scan_partition_keeps_node_order(n):
    """The wrapper's side of the node partition only: it takes the smallest
    run of nodes per thread with which the cluster holds n nodes, and hands
    the ledger back as [n, F]. The partition itself (block ranges, thread
    runs, -inf padding, the kernel's ledger write-back) runs only on the
    card, where chip_smoke.py holds the kernel exactly against
    assign_scan_plain at an n for every run."""
    from kubernetes_tpu_torch.ops.assign_scan import CLUSTER, RUNS, THREADS, node_run

    run = node_run(n)
    assert run in RUNS and CLUSTER * THREADS * run >= n
    assert run == RUNS[0] or CLUSTER * THREADS * (run // 2) < n

    rng = np.random.RandomState(n % 1000)
    alloc = torch.from_numpy(rng.randint(1, 9, (n, 6)).astype(np.float32) * 1000)
    masked = torch.from_numpy(np.where(rng.rand(2, n) < 0.5, 1.0, -np.inf)
                              .astype(np.float32))
    requests = torch.tensor([[1.0, 100, 100, 0, 0, 0]] * 2)
    got = assign_scan(masked, requests, requests[:, 1:3].contiguous(), alloc,
                      torch.zeros(n, 6), torch.zeros(n, 2), 0)
    assert got.new_requested.shape == (n, 6) and got.new_nonzero.shape == (n, 2)
    assert float(got.new_requested[:, 0].sum()) == float((got.assignments >= 0).sum())


def test_assign_scan_refuses_more_nodes_than_the_cluster_holds():
    from kubernetes_tpu_torch.ops.assign_scan import node_run

    assert node_run(65536) == 8
    with pytest.raises(ValueError, match="65537 nodes"):
        node_run(65537)


@pytest.mark.parametrize("width", [128, 64, 45])
def test_pack_bits_matches_numpy_packbits(width):
    """The kernel's bit-set layout of a 0/1 operand: bit b of word w is
    column 32w + b, zero past the last column (numpy's little-endian
    packbits, read as little-endian 32-bit words)."""
    from kubernetes_tpu_torch.ops.static_mask import pack_bits_plain

    rng = np.random.RandomState(width)
    x = (rng.rand(37, width) < 0.3).astype(np.float32)
    x[0] = 1.0  # every bit of a word set: the sign bit of the i32 word
    words = -(-width // 32)
    padded = np.zeros((37, 32 * words), bool)
    padded[:, :width] = x != 0
    want = np.packbits(padded, axis=1, bitorder="little").view("<u4").view(np.int32)
    got = pack_bits_plain(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == (37, words)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("width", [128, 64, 45])
def test_bit_set_counts_equal_the_products(width):
    """What the mask kernel computes from the packed words equals what the
    plain version computes with products, for 0/1 operands: the popcount of
    the ANDed words is the dot product, and their OR is zero exactly when
    the product is."""
    from kubernetes_tpu_torch.ops.static_mask import pack_bits_plain

    rng = np.random.RandomState(100 + width)
    a = torch.from_numpy((rng.rand(29, width) < 0.2).astype(np.float32))
    b = torch.from_numpy((rng.rand(41, width) < 0.2).astype(np.float32))
    pa = pack_bits_plain(a).to(torch.int64) & 0xFFFFFFFF
    pb = pack_bits_plain(b).to(torch.int64) & 0xFFFFFFFF
    both = pa[:, None, :] & pb[None, :, :]               # [29, 41, words]
    popc = sum(((both >> i) & 1) for i in range(32)).sum(-1)
    product = torch.matmul(a, b.T)
    np.testing.assert_array_equal(popc.numpy(), product.numpy().astype(np.int64))
    any_bit = (both != 0).any(-1)
    np.testing.assert_array_equal(any_bit.numpy(), (product != 0).numpy())
    assert (product != 0).any() and (product == 0).any()
