"""Throughput harness: the scheduler_perf equivalent for this package.

- `run_device_solve` times the solver alone: one batch, encoded through
  the EncodeCache into packed blobs and uploaded once, solved `iters`
  times against device-resident state, chained through the round-robin
  counter, with one synchronization at the end.
- `run_throughput` times `Scheduler.schedule` end to end over a fixture
  cluster (encode through the cache, upload, solve, readback, ledger
  commit) and reports pods/s, ms per solve and the cache's hits and
  misses. With `n_services` the cluster has that many Services over the
  pods' app groups, which raises the spread gate: the reference bench's
  `bench[spread]` is `run_throughput(15000, 30000, node_kwargs={"zones":
  3}, pod_kwargs={"app_groups": 16}, n_services=16)`. Pods with
  pod-affinity terms raise the ipa gate: `bench[interpod]` is
  `run_throughput(5000, 8192, node_kwargs={"zones": 3},
  pod_kwargs=INTERPOD_PODS)`. Both at once, Services over pods that carry
  terms, run the spread+interpod build: the `spread_interpod` traffic is
  `run_throughput(15000, 30000, node_kwargs={"zones": 3},
  pod_kwargs=SPREAD_INTERPOD_PODS, n_services=16)`. Gang-annotated pods
  raise the gang gate:
  `bench[gang]` is `run_throughput(50000, 24576, node_kwargs={"zones":
  3}, pod_kwargs={"gang_size": 8})`, and a run whose groups do not all
  settle (placed or reverted) fails, as the reference bench's does.
  PreferNoSchedule taints and preferred node affinity raise the tt and
  na gates, which every build takes as its normalization flag: the
  `tt_na` traffic is `run_throughput(15000, 30000,
  node_kwargs=TT_NA_NODES, pod_kwargs=TT_NA_PODS)`. GPU, scratch and
  overlay requests and host ports raise the gpu, storage and ports gates,
  which the main and gang builds take as their EXT variant: the
  `gpu_ports` traffic is `make_pods(30000, **GPU_PORTS_PODS)` on
  `gpu_ports_cluster(15000, ...)` (bound host-port pods accounted first).
- `run_preemption` drives the preemption drill (the reference's
  bench[preemption], kubernetes_tpu/perf/harness.py `_run_preemption`):
  every node's cpu filled by two priority-0 fillers, then a wave of n/4
  pods at priority 1000 whose 2-cpu request fits only after an eviction,
  in one batch: every wave pod must get a verdict, the verdicts' victims
  must be disjoint, of lower priority and evictable, and after the caller
  removes them the whole wave must land. `preemption_pass_inputs` gives
  the post-scan operands of the pass on the first batch the driver would
  solve, on that cluster and on two variants (`preemption_cluster`) the
  card holds kernel 3 on (`mixed`: filler priorities 0, 100, 200,
  every 5th filler protected, wave priorities 150 and 1000 and requests of
  2, 1 and 3 cpu; `gang`: the wave in groups of 8 at quorum 8 with fewer
  evictable victims than it needs).

Both build the CUDA kernels and warm the device before the clock starts,
and run on `cuda` unless given another device.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field

import torch

from kubernetes_tpu_torch.gang import pod_group_key
from kubernetes_tpu_torch.models.policy import DEFAULT_POLICY, Policy
from kubernetes_tpu_torch.ops.preemption import VictimTable, participants
from kubernetes_tpu_torch.ops.solver import (
    check_supported,
    masked_static_scores,
    schedule_batch,
)
from kubernetes_tpu_torch.perf.fixtures import make_nodes, make_pods, make_services
from kubernetes_tpu_torch.scheduler.driver import Scheduler
from kubernetes_tpu_torch.state.convert import upload_blobs
from kubernetes_tpu_torch.state.layout import Capacities
from kubernetes_tpu_torch.state.pod_batch import (
    empty_batch,
    pack_batch,
    packed_batch_flags,
    unpack_batch,
)
from kubernetes_tpu_torch.utils.device import resolve_device


# bench[interpod]'s pod mix: 8 app groups, required hostname anti-affinity
# on every 16th pod, weight-10 preferred zone affinity on every 2nd
INTERPOD_PODS = {"app_groups": 8, "anti_affinity_every": 16,
                 "pref_affinity_every": 2}
# the spread_interpod traffic's pod mix: bench[spread]'s 16 app groups (each
# selected by a Service) with bench[interpod]'s terms
SPREAD_INTERPOD_PODS = {**INTERPOD_PODS, "app_groups": 16}
# the gang_spread_interpod traffic's pod mix: the spread_interpod mix in
# all-or-nothing groups of 8 consecutive pods, each at quorum 8
GANG_SPREAD_INTERPOD_PODS = {**SPREAD_INTERPOD_PODS, "gang_size": 8}


def _tt_na_preferred(group: int) -> list:
    """The tt_na traffic's preferred terms of app group g: its zone,
    zone-{g % 3}, at weight 10 * (1 + g % 4), and for odd groups also
    label-0 In value-{g % 7} at weight 1."""
    terms = [{"weight": 10 * (1 + group % 4), "preference": {"matchExpressions": [
        {"key": "failure-domain.beta.kubernetes.io/zone", "operator": "In",
         "values": [f"zone-{group % 3}"]}]}}]
    if group % 2:
        terms.append({"weight": 1, "preference": {"matchExpressions": [
            {"key": "label-0", "operator": "In", "values": [f"value-{group % 7}"]}]}})
    return terms


# the tt_na traffic: bench[headline]'s nodes (bench.py:260) with one filler
# label and every 8th node tainted dedicated=batch:PreferNoSchedule; its
# 30,000 pods in 16 app groups, the even groups tolerating the taint, each
# group preferring a zone and the odd groups a label value too
TT_NA_NODES = {"zones": 3, "labels_per_node": 1, "prefer_taint_every": 8}
TT_NA_PODS = {
    "app_groups": 16,
    "class_tolerations": tuple(
        [{"key": "dedicated", "operator": "Equal", "value": "batch",
          "effect": "PreferNoSchedule"}] if g % 2 == 0 else []
        for g in range(16)),
    "class_preferred": tuple(_tt_na_preferred(g) for g in range(16)),
}


# the gpu_ports traffic: bench[headline]'s nodes (bench.py:260), every 4th
# with 8 GPUs and every node 100Gi of node-local scratch and no overlay; its
# 30,000 pods of 100m / 250Mi, every 4th also asking a GPU, pods 2 and 6 of
# every 8 1Gi of scratch and 512Mi of overlay (which falls through to
# scratch: no node has overlay allocatable), pod 1 of every 16 host port
# 8080 and pod 5 of every 32 host port 9100; before the run one pod with
# host port 8080 is bound on every 10th node, with a GPU where the node has
# GPUs (`gpu_ports_cluster`)
GPU = "alpha.kubernetes.io/nvidia-gpu"
SCRATCH = "storage.kubernetes.io/scratch"
OVERLAY = "storage.kubernetes.io/overlay"
GPU_PORTS_NODES = {"zones": 3, "extra_allocatable": (
    (4, 0, {GPU: "8"}), (1, 0, {SCRATCH: "100Gi"}))}
GPU_PORTS_PODS = {
    "extra_requests": ((4, 0, {GPU: "1"}), (8, 2, {SCRATCH: "1Gi"}),
                       (8, 6, {OVERLAY: "512Mi"})),
    "host_ports": ((16, 1, 8080), (32, 5, 9100))}
GPU_PORTS_BOUND_EVERY = 10


def gpu_ports_cluster(n_nodes: int, caps: Capacities, device=None,
                      policy: Policy = DEFAULT_POLICY,
                      node_kwargs: dict | None = None) -> Scheduler:
    """A Scheduler on the gpu_ports traffic's nodes (with `node_kwargs`
    added to GPU_PORTS_NODES) with its bound pods accounted
    (`Scheduler.add_pod`): on node i, i % GPU_PORTS_BOUND_EVERY == 0, one
    pod of 100m / 250Mi with host port 8080 and, where the node has GPUs,
    one GPU."""
    sched = Scheduler(caps, policy, device)
    sched.add_nodes(make_nodes(n_nodes, **GPU_PORTS_NODES, **(node_kwargs or {})))
    on = range(0, n_nodes, GPU_PORTS_BOUND_EVERY)
    # bound pod k sits on node 10 k, which has GPUs where k is even
    bound = make_pods(len(on), name_prefix="bound",
                      extra_requests=((2, 0, {GPU: "1"}),),
                      host_ports=((1, 0, 8080),))
    for i, pod in zip(on, bound):
        sched.add_pod(pod, f"node-{i}")
    return sched


def default_caps(n_nodes: int, n_pods: int) -> Capacities:
    """The reference harness's shapes: nodes padded to a power of two, and
    batches of n_pods / 6 clamped to [64, 4096]."""
    return Capacities(num_nodes=1 << max(6, (n_nodes - 1).bit_length()),
                      batch_pods=min(4096, max(64, n_pods // 6)))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warm(caps: Capacities, policy: Policy, device: torch.device,
         n_services: int = 0, pod_kwargs: dict | None = None) -> None:
    """Build the kernels and run one batch at these shapes on a throwaway
    one-node cluster (with a Service when `n_services`, so the spread
    build loads too; with one pod of `pod_kwargs`, so a pod-affinity mix
    loads the interpod build, both the spread+interpod build, or one group
    of a gang mix, the gang build), so library handles and kernel loads
    are set up before any timed region. The pod is pod 0 of the mix: the
    first of its app group, and with the mix's terms where it has any."""
    if device.type == "cuda":
        from kubernetes_tpu_torch.native.build import build

        build()
    sched = Scheduler(caps, policy, device)
    sched.add_nodes(make_nodes(1))
    for svc in make_services(min(n_services, 1)):
        sched.add_service(svc)
    kwargs = dict(pod_kwargs or {})
    if n_services:
        kwargs.setdefault("app_groups", 1)
    sched.schedule(make_pods(kwargs.get("gang_size") or 1, name_prefix="warm",
                             **kwargs))
    _sync(device)


@dataclass
class DeviceSolveResult:
    n_nodes: int
    batch_pods: int
    iters: int
    ms_per_solve: float
    pods_per_sec: float
    device: str

    def __str__(self) -> str:
        return (f"device solve N={self.n_nodes} P={self.batch_pods} on "
                f"{self.device}: {self.ms_per_solve:.2f} ms/solve = "
                f"{self.pods_per_sec:.0f} pods/s")


def run_device_solve(n_nodes: int, batch_pods: int = 4096, iters: int = 16,
                     policy: Policy = DEFAULT_POLICY,
                     node_kwargs: dict | None = None,
                     pod_kwargs: dict | None = None,
                     device=None) -> DeviceSolveResult:
    """Time the solver alone on one encoded batch."""
    dev = resolve_device(device)
    caps = Capacities(num_nodes=1 << max(6, (n_nodes - 1).bit_length()),
                      batch_pods=batch_pods)
    warm(caps, policy, dev)
    sched = Scheduler(caps, policy, dev)
    sched.add_nodes(make_nodes(n_nodes, **(node_kwargs or {})))
    fblob, iblob = pack_batch(empty_batch(caps), caps)
    for i, pod in enumerate(make_pods(batch_pods, **(pod_kwargs or {}))):
        sched.encode_cache.encode_packed_into(fblob, iblob, i, pod)
    flags = packed_batch_flags(fblob, iblob, batch_pods, sched.statedb.table,
                               caps)
    state = sched.statedb.flush()
    # the batch stays on the device: this times the solver, not the upload
    batch = unpack_batch(*upload_blobs(fblob, iblob, dev), caps)
    rr = schedule_batch(state, batch, 0, policy, flags).rr_end
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        rr = schedule_batch(state, batch, rr, policy, flags).rr_end
    _sync(dev)
    dt = time.perf_counter() - t0
    return DeviceSolveResult(
        n_nodes=n_nodes, batch_pods=batch_pods, iters=iters,
        ms_per_solve=1e3 * dt / iters,
        pods_per_sec=iters * batch_pods / dt if dt > 0 else 0.0,
        device=str(dev))


@dataclass
class ThroughputResult:
    scheduled: int
    pods: int
    seconds: float
    pods_per_sec: float
    batches: int
    ms_per_solve: float         # mean host time from dispatch to assignments
    ms_encode_per_batch: float  # mean host time to encode + upload a batch
    cache_hits: int             # EncodeCache hits and misses in the run
    cache_misses: int
    device: str
    gang_groups: int = 0        # gang groups among the pods
    gang_placed: int = 0        # of them, placed, and reverted by the solver
    gang_reverted: int = 0
    placements: dict = field(default_factory=dict, repr=False)

    def __str__(self) -> str:
        return (f"{self.scheduled}/{self.pods} pods in {self.seconds:.2f}s = "
                f"{self.pods_per_sec:.0f} pods/s over {self.batches} batches "
                f"({self.ms_per_solve:.2f} ms/solve) on {self.device}")


def measure(sched: Scheduler, pods) -> ThroughputResult:
    """Time one `sched.schedule(pods)` call. Garbage left by the set-up
    is collected before the clock starts, so its pause is not timed."""
    gc.collect()
    cache = sched.encode_cache
    hits0, misses0 = cache.hits, cache.misses
    placed0, reverted0 = sched.gang_placed, sched.gang_reverted
    n_batches = len(sched.solve_seconds)
    t0 = time.perf_counter()
    placements = sched.schedule(pods)
    _sync(sched.device)
    dt = time.perf_counter() - t0
    solves = sched.solve_seconds[n_batches:]
    encodes = sched.encode_seconds[n_batches:]
    return ThroughputResult(
        scheduled=sum(v is not None for v in placements.values()),
        pods=len(pods), seconds=dt,
        pods_per_sec=len(pods) / dt if dt > 0 else 0.0,
        batches=len(solves),
        ms_per_solve=1e3 * sum(solves) / max(len(solves), 1),
        ms_encode_per_batch=1e3 * sum(encodes) / max(len(encodes), 1),
        cache_hits=cache.hits - hits0, cache_misses=cache.misses - misses0,
        device=str(sched.device),
        gang_groups=len({pod_group_key(p) for p in pods} - {None}),
        gang_placed=sched.gang_placed - placed0,
        gang_reverted=sched.gang_reverted - reverted0, placements=placements)


def run_throughput(n_nodes: int, n_pods: int, caps: Capacities | None = None,
                   policy: Policy = DEFAULT_POLICY,
                   node_kwargs: dict | None = None,
                   pod_kwargs: dict | None = None,
                   device=None, n_services: int = 0) -> ThroughputResult:
    """Sustained scheduling throughput of `Scheduler` on a fixture cluster
    (the headline shape is 15,000 nodes in 3 zones and 30,000 pods), with
    `n_services` Services (`make_services`) registered before the run."""
    dev = resolve_device(device)
    caps = caps or default_caps(n_nodes, n_pods)
    warm(caps, policy, dev, n_services, pod_kwargs)
    sched = Scheduler(caps, policy, dev)
    sched.add_nodes(make_nodes(n_nodes, **(node_kwargs or {})))
    for svc in make_services(n_services):
        sched.add_service(svc)
    result = measure(sched, make_pods(n_pods, **(pod_kwargs or {})))
    settled = result.gang_placed + result.gang_reverted
    if settled != result.gang_groups:
        raise RuntimeError(f"gang run: only {settled}/{result.gang_groups} "
                           f"groups settled")
    return result


# the preemption drill (kubernetes_tpu/perf/harness.py:268-330): two
# fillers a node of 1900m / 256Mi leave 200m of a 4-cpu node free; the
# wave, n/4 pods of 2 cpu / 512Mi at PREEMPTION_PRIORITY, fits only after
# an eviction
PREEMPTION_FILLERS = 2
PREEMPTION_PRIORITY = 1000
PREEMPTION_GANG = 8


def preemption_caps(n_nodes: int) -> Capacities:
    """Nodes padded to a power of two (N = 16,384 at 15,000 nodes), and the
    wave in one batch (P = 4,096 for its 3,750 pods)."""
    wave = n_nodes // 4
    return Capacities(num_nodes=1 << max(6, (n_nodes - 1).bit_length()),
                      batch_pods=min(4096, max(64, 1 << max(0, wave - 1).bit_length())))


def _filler_index(pod) -> int:
    return int(pod.metadata.name.rsplit("-", 1)[1])


def preemption_cluster(n_nodes: int, variant: str = "uniform", device=None,
                       policy: Policy = DEFAULT_POLICY):
    """(Scheduler with the fillers bound, the wave's pods) of one variant:
    `uniform` the drill's; `mixed` with filler i at priority (i % 3) * 100,
    every 5th filler protected, the wave's priorities alternating 150 and
    1000 and its requests cycling 2, 1 and 3 cpu; `gang` the drill's wave
    in groups of 8 at quorum 8 (n/4 rounded down to a multiple of 8), only
    the fillers of its first half's nodes and three more evictable (a pod
    evicts one filler a node), so the first half of the groups find sets
    and the next one reverts after three members."""
    if variant not in ("uniform", "mixed", "gang"):
        raise ValueError(f"preemption variant {variant!r}")
    wave_n = n_nodes // 4
    evictable = None
    filler_prio, wave_kwargs = 0, {"cpu": "2", "priority": PREEMPTION_PRIORITY}
    if variant == "mixed":
        filler_prio = (0, 100, 200)
        wave_kwargs = {"cpu": ("2", "1", "3"), "priority": (150, PREEMPTION_PRIORITY)}
        evictable = lambda pod: _filler_index(pod) % 5 != 0  # noqa: E731
    elif variant == "gang":
        wave_n -= wave_n % PREEMPTION_GANG
        wave_kwargs["gang_size"] = PREEMPTION_GANG
        open_nodes = wave_n // 2 + 3
        evictable = lambda pod: (_filler_index(pod)  # noqa: E731
                                 // PREEMPTION_FILLERS < open_nodes)
    sched = Scheduler(preemption_caps(n_nodes), policy, device, evictable=evictable)
    sched.add_nodes(make_nodes(n_nodes))
    fillers = make_pods(PREEMPTION_FILLERS * n_nodes, cpu="1900m", memory="256Mi",
                        name_prefix="filler", priority=filler_prio)
    for i, pod in enumerate(fillers):
        sched.add_pod(pod, f"node-{i // PREEMPTION_FILLERS}")
    wave = make_pods(wave_n, memory="512Mi", name_prefix="crit", **wave_kwargs)
    return sched, wave


@dataclass
class PassInputs:
    """The preemption pass's operands after the scan of one batch
    (ops.preemption.preemption_pass, in its order: `args()`)."""

    allocatable: torch.Tensor
    base_requested: torch.Tensor
    masked_static: torch.Tensor
    requests: torch.Tensor
    priority: torch.Tensor
    part: torch.Tensor
    gang_id: torch.Tensor
    victims: VictimTable
    use_gang: bool

    def args(self) -> tuple:
        return (self.allocatable, self.base_requested, self.masked_static,
                self.requests, self.priority, self.part, self.gang_id,
                self.victims)


def preemption_pass_inputs(sched: Scheduler, wave) -> PassInputs:
    """The pass's operands on the first batch of `sched.schedule(wave)`:
    the driver's own batching and operands (`Scheduler.batches`,
    `Scheduler.prepare_chunk`, nothing claimed yet), the scan, and the
    masked static scores. Changes nothing of `sched`'s state (it encodes
    through its cache into its host blobs)."""
    chunk, gang_id, gang_min = next(iter(sched.batches(wave)))
    state, batch, flags, victims, _slots = sched.prepare_chunk(chunk, gang_id, gang_min)
    if victims is None:
        raise ValueError("preemption_pass_inputs: no preempt gate or nothing evictable")
    policy = sched.policy
    scan = schedule_batch(state, batch, sched.rr, policy, flags, sched.caps,
                          spread_zones=sched.statedb.table.spread_zones)
    inputs = PassInputs(
        allocatable=state.allocatable, base_requested=scan.new_requested,
        masked_static=masked_static_scores(state, batch, policy,
                                           check_supported(policy, flags)),
        requests=batch.requests, priority=batch.priority.contiguous(),
        part=participants(batch.valid, scan.assignments).contiguous(),
        gang_id=batch.gang_id.contiguous(), victims=victims, use_gang=flags.gang)
    _sync(sched.device)   # the host blobs are free again
    return inputs


@dataclass
class PreemptionResult:
    n_nodes: int
    wave: int
    verdicts: int            # wave pods with a victim set
    victims: int             # distinct victims named
    victim_counts: list      # k of each verdict
    bound_wave: int          # wave pods placed after the removals
    verdict_seconds: float   # the first schedule call: scan, pass, resolve
    rebind_seconds: float    # the removals and the second schedule call
    device: str

    def __str__(self) -> str:
        return (f"preemption N={self.n_nodes}: {self.verdicts}/{self.wave} "
                f"verdicts naming {self.victims} victims in "
                f"{self.verdict_seconds:.3f}s, {self.bound_wave}/{self.wave} "
                f"landed after the removals on {self.device}")


def run_preemption(n_nodes: int, device=None,
                   policy: Policy = DEFAULT_POLICY) -> PreemptionResult:
    """The preemption drill on `preemption_cluster(n_nodes)`, the kernels
    built and warmed first."""
    dev = resolve_device(device)
    sched, wave = preemption_cluster(n_nodes, "uniform", dev, policy)
    warm(sched.caps, policy, dev)
    return preemption_drill(sched, wave)


def preemption_drill(sched: Scheduler, wave) -> PreemptionResult:
    """The drill through `Scheduler.schedule`: the wave gets its verdicts,
    the caller removes the victims (`remove_pod`), and the wave is
    scheduled again. Raises if a wave pod lands before an eviction, or if
    a verdict's victims are shared, not of lower priority or not
    evictable."""
    dev = sched.device
    accounted = sched.statedb._accounted
    gc.collect()
    t0 = time.perf_counter()
    first = sched.schedule(wave)
    _sync(dev)
    t1 = time.perf_counter()
    if any(v is not None for v in first.values()):
        raise RuntimeError("preemption drill: a wave pod landed before any eviction")
    verdicts = dict(sched.preemptions)
    victims = [key for _node, keys in verdicts.values() for key in keys]
    if len(set(victims)) != len(victims):
        raise RuntimeError("preemption drill: a victim named by two verdicts")
    for key in victims:
        pod = accounted[key][6]
        if pod.spec.priority >= PREEMPTION_PRIORITY or (
                sched.evictable is not None and not sched.evictable(pod)):
            raise RuntimeError(f"preemption drill: victim {key} not evictable")
    t2 = time.perf_counter()
    for key in victims:
        sched.remove_pod(key)
    second = sched.schedule(wave)
    _sync(dev)
    t3 = time.perf_counter()
    return PreemptionResult(
        n_nodes=len(sched.statedb.table.row_of), wave=len(wave), verdicts=len(verdicts),
        victims=len(set(victims)),
        victim_counts=[len(keys) for _node, keys in verdicts.values()],
        bound_wave=sum(v is not None for v in second.values()),
        verdict_seconds=t1 - t0, rebind_seconds=t3 - t2, device=str(dev))
