"""kubernetes_tpu_torch solver and driver against the reference solver on
the CPU: `schedule_batch` equals JAX `schedule_batch` (with and without the
Pallas fused static mask) on assignments, scores, feasible counts, both
ledgers and rr_end, exactly; `Scheduler.schedule` over three chained
batches equals JAX `schedule_batch` chained by hand; and every gate,
policy or pod outside the main path raises NotImplementedError, but the
gates the port carries (tt and na through the normalization flag, ports,
gpu and storage through the EXT variant, gang with spread or ipa,
preempt), which equal JAX `schedule_batch` on a batch that raises them."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)
try:
    torch.set_num_interop_threads(1)
except RuntimeError:  # the interop pool already started in this process
    pass

from kubernetes_tpu.models.policy import DEFAULT_POLICY as J_POLICY  # noqa: E402
from kubernetes_tpu.ops import solver as jsolver  # noqa: E402
from kubernetes_tpu.state import Capacities as JCaps  # noqa: E402

from kubernetes_tpu_torch.api.objects import Node, Pod  # noqa: E402
from kubernetes_tpu_torch.models.policy import DEFAULT_POLICY, Policy  # noqa: E402
from kubernetes_tpu_torch.ops.solver import (  # noqa: E402
    BatchFlags,
    schedule_batch,
    schedule_batch_plain,
)
from kubernetes_tpu_torch.scheduler import Scheduler  # noqa: E402
from kubernetes_tpu_torch.state import Capacities  # noqa: E402
from kubernetes_tpu_torch.state.convert import (  # noqa: E402
    batch_from_numpy,
    rr_from_numpy,
    state_from_numpy,
)
from tests.test_torch_state import (  # noqa: E402
    BATCH,
    CAPS,
    N_NODES,
    encode_both,
    random_cluster,
)

FIELDS = ("assignments", "scores", "feasible_counts", "new_requested",
          "new_nonzero")
NO_GATES = jsolver.BatchFlags(*([False] * 12))

# one jitted reference solver per static-mask path: the Pallas choice is
# read from KTPU_PALLAS while tracing, so each path gets its own function
# (and so its own trace cache), and the Pallas one is checked to contain
# the kernel
_JAX_SOLVE = {}


def jax_solve(state, batch, rr, pallas):
    fn = _JAX_SOLVE.get(pallas)
    if fn is None:
        def solve(s, b, r):
            return jsolver.schedule_batch(s, b, r, J_POLICY, flags=NO_GATES)
        jaxpr = str(jax.make_jaxpr(solve)(state, batch, np.uint32(rr)))
        assert ("pallas_call" in jaxpr) == pallas
        fn = _JAX_SOLVE[pallas] = jax.jit(solve)
    return fn(state, batch, np.uint32(rr))


def assert_same(got, want, msg=""):
    for name in FIELDS:
        np.testing.assert_array_equal(
            getattr(got, name).cpu().numpy(), np.asarray(getattr(want, name)),
            err_msg=f"{msg} {name}")
    assert int(got.rr_end) == rr_from_numpy(want.rr_end), msg


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("seed", range(4))
def test_schedule_batch_matches_reference(seed, pallas, monkeypatch):
    if pallas:
        monkeypatch.setenv("KTPU_PALLAS", "1")
    else:
        monkeypatch.delenv("KTPU_PALLAS", raising=False)
    rng = np.random.RandomState(200 + seed)
    nodes, pods = random_cluster(rng, 12, BATCH)
    (state, batch, _), (jstate, jbatch, jtable) = encode_both(nodes, pods)
    assert jsolver.batch_flags(jbatch, BATCH, jtable) == NO_GATES
    rr = [0, 3, 2**32 - 1, 12345][seed]
    want = jax_solve(jstate, jbatch, rr, pallas)
    # the reference's own encoding carried across, and this package's
    mine = schedule_batch(state_from_numpy(state, "cpu"),
                          batch_from_numpy(batch, "cpu"), rr)
    carried = schedule_batch(state_from_numpy(jstate, "cpu"),
                             batch_from_numpy(jbatch, "cpu"), rr)
    assert_same(mine, want, "own encoding")
    assert_same(carried, want, "carried state")
    assert_same(schedule_batch_plain(state_from_numpy(state, "cpu"),
                                     batch_from_numpy(batch, "cpu"), rr),
                want, "plain path")
    assert (np.asarray(want.assignments) >= 0).any()


def _chained_reference(node_dicts, pod_dicts, n_batches):
    """JAX schedule_batch over consecutive batches, the ledger and rr
    chained by hand."""
    caps3 = JCaps(num_nodes=N_NODES, batch_pods=BATCH * n_batches)
    _, (jstate, jbig, jtable) = encode_both(node_dicts, pod_dicts,
                                            caps=Capacities(
                                                num_nodes=N_NODES,
                                                batch_pods=BATCH * n_batches),
                                            jcaps=caps3)
    rr = 0
    results = []
    for k in range(n_batches):
        jb = jax.tree.map(lambda a: a[k * BATCH:(k + 1) * BATCH], jbig)
        res = jax_solve(jstate, jb, rr, pallas=False)
        jstate = jstate.replace(requested=np.asarray(res.new_requested),
                                nonzero_requested=np.asarray(res.new_nonzero))
        rr = rr_from_numpy(res.rr_end)
        results.append(res)
    return results, jtable


@pytest.mark.parametrize("seed", range(2))
def test_scheduler_chains_batches_like_the_reference(seed, monkeypatch):
    monkeypatch.delenv("KTPU_PALLAS", raising=False)
    rng = np.random.RandomState(300 + seed)
    nodes, pods = random_cluster(rng, 30, 3 * BATCH)
    want, jtable = _chained_reference(nodes, pods, 3)

    # one batch per schedule() call, each result compared whole
    sched = Scheduler(CAPS, device="cpu")
    sched.add_nodes([Node.from_dict(d) for d in nodes])
    placed = {}
    for k in range(3):
        chunk = [Pod.from_dict(d) for d in pods[k * BATCH:(k + 1) * BATCH]]
        placed.update(sched.schedule(chunk))
        assert_same(sched.last_result, want[k], f"batch {k}")

    # all three batches in one call: same placements, ledger and rr
    whole = Scheduler(CAPS, device="cpu")
    whole.add_nodes([Node.from_dict(d) for d in nodes])
    assert whole.schedule([Pod.from_dict(d) for d in pods]) == placed
    expected = {}
    for k, res in enumerate(want):
        for i, row in enumerate(np.asarray(res.assignments)):
            key = f"default/{pods[k * BATCH + i]['metadata']['name']}"
            expected[key] = jtable.name_of[row] if row >= 0 else None
    assert placed == expected
    # in-batch claims exhausted some nodes: pods left unplaced
    assert None in placed.values()
    assert int(whole.rr) == rr_from_numpy(want[-1].rr_end)
    # the host mirror agrees with the device ledger it adopted
    for db in (sched.statedb, whole.statedb):
        np.testing.assert_array_equal(db.host.requested,
                                      np.asarray(want[-1].new_requested))
        np.testing.assert_array_equal(db.flush().nonzero_requested.numpy(),
                                      np.asarray(want[-1].new_nonzero))


@pytest.mark.parametrize("gate", ["tt", "gpu", "storage", "na", "ports",
                                  "vol", "gang+spread", "gang+ipa", "preempt"])
def test_gates_outside_the_main_path_raise(gate):
    rng = np.random.RandomState(5)
    nodes, pods = random_cluster(rng, 24, BATCH, gated=gate in ("tt", "gpu",
                                                                "storage", "na"))
    (state, batch, _), (jstate, jbatch, _) = encode_both(nodes, pods)
    if gate == "preempt":
        # carried since the preemption pass: without a VictimTable the pass
        # is off on both sides, and no pod gets a verdict
        batch.priority[0] = jbatch.priority[0] = 5
    if gate in ("tt", "na", "preempt"):
        # carried since the normalization flag (the gated cluster's gpu and
        # storage requests held off by the flags, on both sides)
        jflags = dataclasses.replace(NO_GATES, **{gate: True})
        want = jax.jit(lambda s, b, r: jsolver.schedule_batch(
            s, b, r, J_POLICY, flags=jflags))(jstate, jbatch, np.uint32(0))
        got = schedule_batch(state_from_numpy(state, "cpu"),
                             batch_from_numpy(batch, "cpu"), 0,
                             flags=dataclasses.replace(BatchFlags(*([False] * 12)),
                                                       **{gate: True}))
        assert_same(got, want, gate)
        assert (got.preempt_node == -1).all() and (got.victim_count == 0).all()
        return
    if gate in ("gpu", "storage", "ports"):
        # carried since the EXT variant of the main build: the batch raising
        # the gate (the gated cluster's other gated columns held off on
        # both sides, its PreferNoSchedule taints and preferred terms by the
        # flags) equals the reference's with that gate
        from kubernetes_tpu_torch.state.layout import Resource

        other = {"gpu": (Resource.SCRATCH, Resource.OVERLAY),
                 "storage": (Resource.GPU,), "ports": ()}[gate]
        for st, b in ((state, batch), (jstate, jbatch)):
            b.requests[:, list(other)] = 0.0
            if gate == "ports":
                b.port_onehot[[0, 3, 5], 0] = 1.0
                b.port_onehot[5, 1] = 2.0   # a port listed twice
                st.port_count[:12:3, 0] = 1.0
        jflags = dataclasses.replace(NO_GATES, **{gate: True})
        want = jax.jit(lambda s, b, r: jsolver.schedule_batch(
            s, b, r, J_POLICY, flags=jflags))(jstate, jbatch, np.uint32(0))
        got = schedule_batch(state_from_numpy(state, "cpu"),
                             batch_from_numpy(batch, "cpu"), 0,
                             flags=dataclasses.replace(BatchFlags(*([False] * 12)),
                                                       **{gate: True}))
        assert_same(got, want, gate)
        if gate == "ports":
            np.testing.assert_array_equal(got.new_port_count.numpy(),
                                          np.asarray(want.new_port_count))
        else:
            assert got.new_port_count is None   # no port wanted: passed through
        return
    if gate == "vol":
        # carried since the EXT variant widened to volumes: pods mounting a
        # disk read-write and read-only, nodes holding it, equal the
        # reference's with the vol gate, the conflict ledgers too
        for st, b in ((state, batch), (jstate, jbatch)):
            b.vol_want_rw[0, 0] = 1.0
            b.vol_want_ro[[2, 4], 0] = 1.0
            b.vol_want_rw[5, 1] = 2.0   # a disk listed twice
            st.vol_any[:12:3, 0] = 1.0
            st.vol_rw[:12:6, 0] = 1.0
        jflags = dataclasses.replace(NO_GATES, vol=True)
        want = jax.jit(lambda s, b, r: jsolver.schedule_batch(
            s, b, r, J_POLICY, flags=jflags))(jstate, jbatch, np.uint32(0))
        got = schedule_batch(state_from_numpy(state, "cpu"),
                             batch_from_numpy(batch, "cpu"), 0,
                             flags=dataclasses.replace(BatchFlags(*([False] * 12)),
                                                       vol=True))
        assert_same(got, want, gate)
        for name, jname in (("new_vol_any", "new_vol_any"), ("new_vol_rw", "new_vol_rw")):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, jname)), name)
        assert got.new_attach is None   # no attach atom: passed through
        return
    if gate.startswith("gang"):
        # carried since the gang carry in the spread and interpod builds:
        # the batch both gates name equals the reference's with those gates
        for b in (batch, jbatch):
            b.gang_id[:2], b.gang_min[:2] = 1, 2
            if gate == "gang+spread":
                b.spread_q[0] = 0
            else:
                b.paff_q[1, 0] = 0
        raised = dict.fromkeys(gate.split("+"), True)
        jflags = dataclasses.replace(NO_GATES, **raised)
        want = jax.jit(lambda s, b, r: jsolver.schedule_batch(
            s, b, r, J_POLICY, flags=jflags))(jstate, jbatch, np.uint32(0))
        got = schedule_batch(state_from_numpy(state, "cpu"),
                             batch_from_numpy(batch, "cpu"), 0,
                             flags=dataclasses.replace(BatchFlags(*([False] * 12)),
                                                       **raised))
        assert_same(got, want, gate)
        for name in ("new_podsel", "new_term"):
            if getattr(got, name) is not None:   # (None: passed through)
                np.testing.assert_array_equal(getattr(got, name).numpy(),
                                              np.asarray(getattr(want, name)), name)
        return
    with pytest.raises(NotImplementedError) as info:
        schedule_batch(state_from_numpy(state, "cpu"),
                       batch_from_numpy(batch, "cpu"), 0)
    assert all(f"'{g}'" in str(info.value) for g in gate.split("+"))


@pytest.mark.parametrize("policy, match", [
    (Policy(predicates=("GeneralPredicates",)), "PodToleratesNodeTaints"),
    (Policy(label_presence_predicates=(("lp", ("zone",), True),),
            predicates=DEFAULT_POLICY.predicates + ("lp",)), "PolicyRows"),
    (Policy(priorities=(("ImageLocalityPriority", 1),)), "ImageLocality"),
])
def test_policies_outside_the_main_path_raise(policy, match):
    (state, batch, _), _ = encode_both(*random_cluster(
        np.random.RandomState(6), 8, 4))
    with pytest.raises(NotImplementedError, match=match):
        schedule_batch(state_from_numpy(state, "cpu"),
                       batch_from_numpy(batch, "cpu"), 0, policy,
                       flags=BatchFlags(*([False] * 12)))
