"""Batched assignment solver: the scheduler's main path on one device.

The reference schedules strictly one pod at a time: each pod runs every
predicate and priority over all nodes and is assumed into the cache before
the next. This solver reproduces that decision for decision:

- **Phase A (parallel over P x N)**: every assignment-independent predicate
  and score term for the whole batch. The fused static mask (kernel 1,
  ops/static_mask.py) covers selectors, hard taints, node conditions,
  validity and the nodeName pin; required node affinity, the volume zone /
  node predicates and the hoisted gpu/storage fit are ANDed in with plain
  tensor ops; the static score is NodePreferAvoidPods plus the constant
  shift of the score terms the batch gates off. The result rides one
  f32[P, N] matrix: the score where feasible, -inf elsewhere.
- **Phase B (serial over P)**: the assignment scan (kernel 2,
  ops/assign_scan.py) carries the (requested, nonzero) ledger, so pod K
  sees the claims of pods 0..K-1; it picks the max-score feasible node with
  the reference's round-robin tie-break and adds the pod's requests to it.
  When the batch raises the spread gate and the policy weighs
  SelectorSpreadPriority, the scan's spread build also scores SelectorSpread
  over each pod's feasible nodes and carries the pod-selector ledger. When
  the batch raises the ipa gate (a pod with pod-affinity terms, or a
  carried term anywhere) and the policy runs MatchInterPodAffinity or
  weighs InterPodAffinityPriority, the scan's interpod build applies the
  predicate, scores the priority over each pod's feasible nodes and
  carries the pod-selector, carried-term and domain ledgers. When the
  batch needs both, the scan's spread+interpod build applies the
  predicate, then scores the priority and SelectorSpread over the nodes
  it leaves, over one pod-selector ledger. When the batch raises the
  gang gate (a row with a group id), the scan settles each all-or-nothing
  group as the scan leaves it: a group below its quorum of placed members
  gives back its ledger charges and round-robin bumps, and its
  pod-selector, carried-term and domain counts where the batch also needs
  SelectorSpread or inter-pod affinity (the gang build, or the gang carry
  of the spread, interpod or spread+interpod build the other gates pick).
  After the scan, every member of such a group is masked out of the
  result (node -1, score 0). When the batch raises the
  tt gate (a PreferNoSchedule taint interned) or the na gate (a preferred
  node-affinity term) and the policy weighs TaintToleration or
  NodeAffinity, whichever build runs takes the normalization flag: both
  scores over each pod's feasible nodes, from 64-bit taint and
  requirement words Phase A packs (`norm_inputs`).
  When the batch raises the ports gate (a pod with a host port) and the
  policy runs PodFitsHostPorts, or the gpu or storage gate (a gpu,
  scratch or overlay request), the main or gang build takes the EXT
  variant: PodFitsHostPorts against the running host-port counts and the
  gpu and storage fit against the running ledger, each placed pod's ports
  added to the counts (`new_port_count`), a reverted group's given back.
- **Preemption (serial over the pods left out)**: when the batch raises
  the preempt gate (a pod with a priority) and the caller gives a
  VictimTable, kernel 3 (ops/preemption.py) finds, for every valid pod the
  scan and the gang mask left unplaced, the node whose eviction of the
  fewest lowest-priority victims lets it fit, on the post-scan ledger and
  the masked static scores, for every build: `preempt_node` and
  `victim_count` in the result, (-1, 0) when the pass is off.

This package carries the main path and the spread, ipa, gang, tt, na,
preempt, ports, gpu and storage gates, each with any of the others but
ports, gpu and storage with SelectorSpread or inter-pod affinity: a batch
whose content raises any other BatchFlags gate (vol, attach), or ports,
gpu or storage where the spread or interpod build would run, a policy
that weighs ServiceSpreadingPriority on a spread batch, or a policy
outside the fused static mask or with argument-carrying registrations,
raises NotImplementedError naming what is missing. It never computes an
answer for a program it does not implement.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import torch

from kubernetes_tpu_torch.models.policy import (
    DEFAULT_POLICY,
    Policy,
    active_label_presence,
    active_label_priorities,
    active_service_anti,
)
from kubernetes_tpu_torch.ops import predicates as preds
from kubernetes_tpu_torch.ops import priorities as prios
from kubernetes_tpu_torch.ops.assign_scan import (
    POD_ROW_FIELDS,
    ExtInputs,
    GangInputs,
    InterpodInputs,
    NormInputs,
    SpreadInputs,
    assign_scan,
    assign_scan_ext,
    assign_scan_ext_plain,
    assign_scan_gang,
    assign_scan_gang_ext,
    assign_scan_gang_ext_plain,
    assign_scan_gang_plain,
    assign_scan_interpod,
    assign_scan_interpod_gang,
    assign_scan_interpod_gang_plain,
    assign_scan_interpod_plain,
    assign_scan_plain,
    assign_scan_spread,
    assign_scan_spread_gang,
    assign_scan_spread_gang_plain,
    assign_scan_spread_interpod,
    assign_scan_spread_interpod_gang,
    assign_scan_spread_interpod_gang_plain,
    assign_scan_spread_interpod_plain,
    assign_scan_spread_plain,
    norm_inputs,
)
from kubernetes_tpu_torch.ops.preemption import (
    VictimTable,
    group_runs,
    participants,
    preemption_pass,
    preemption_pass_plain,
)
from kubernetes_tpu_torch.ops.static_mask import node_bits, static_mask, static_mask_plain
from kubernetes_tpu_torch.state.cluster_state import ClusterState
from kubernetes_tpu_torch.state.layout import MAX_PRIORITY, Capacities
from kubernetes_tpu_torch.state.pod_batch import PodBatch, batch_flags


@dataclass(frozen=True)
class BatchFlags:
    """Batch-content gates: which solver kernels the batch (plus accounted
    state) can affect. Each flag set False asserts a fact about the inputs
    under which the kernel's contribution is exactly neutral (constant
    score shifts are re-added as scalars)."""

    ipa: bool = True      # own inter-pod terms in batch, or carried terms
    spread: bool = True   # any spread_q / spread_svc_q entry
    svcanti: bool = True  # any svcanti_q entry
    vol: bool = True      # any disk-conflict atom wanted
    attach: bool = True   # any attachable-volume atom (or resolve failure)
    tt: bool = True       # any PreferNoSchedule taint interned
    na: bool = True       # any preferred node-affinity term in batch
    ports: bool = True    # any host port wanted
    gpu: bool = True      # any GPU request in batch
    storage: bool = True  # any scratch/overlay request in batch
    gang: bool = True     # any gang member in batch
    preempt: bool = True  # any nonzero pod priority in batch
    explain: bool = False
    scale_sim: bool = False


@dataclass(frozen=True)
class PolicyGates:
    """The kernel gates this solver reads for one (policy, flags) pair.
    Weights are post-gating: a flag-neutralized score kernel contributes
    its constant to const_score."""

    use_resources: bool
    use_ports: bool    # PodFitsHostPorts: in the policy and ports raised
    dyn_gpu: bool      # GPU fit must track the in-batch ledger
    dyn_storage: bool  # scratch/overlay fit must track the in-batch ledger
    w_lr: float
    w_ba: float
    w_ss: float        # SelectorSpread, 0 unless the batch raises spread
    use_ipa: bool      # InterPodAffinityMatches: in the policy and ipa raised
    w_ip: float        # InterPodAffinityPriority, 0 unless the batch raises ipa
    hard_w: float      # hardPodAffinityWeight
    w_tt: float        # TaintTolerationPriority, 0 unless the batch raises tt
    w_na: float        # NodeAffinityPriority, 0 unless the batch raises na
    const_score: float

    @property
    def use_terms(self) -> bool:
        """The batch runs the carried-term ledger (the interpod build)."""
        return self.use_ipa or bool(self.w_ip)

    @property
    def use_ext(self) -> bool:
        """The batch runs the EXT variant: host ports, or the gpu or
        storage fit against the running ledger."""
        return self.use_ports or self.dyn_gpu or self.dyn_storage


def policy_gates(policy: Policy, flags: BatchFlags) -> PolicyGates:
    # gated neutral terms: with no spread entry SelectorSpread scores a
    # uniform MaxPriority, and with no PreferNoSchedule taint so does
    # TaintToleration — constant shifts that stay in the reported score
    # (with no preferred node-affinity term NodeAffinity scores 0)
    const_score = 0.0
    if not flags.spread:
        const_score += policy.weight("SelectorSpreadPriority") * float(MAX_PRIORITY)
        const_score += policy.weight("ServiceSpreadingPriority") * float(MAX_PRIORITY)
    if not flags.tt:
        const_score += policy.weight("TaintTolerationPriority") * float(MAX_PRIORITY)
    return PolicyGates(
        use_resources=policy.has_predicate("GeneralPredicates",
                                           "PodFitsResources"),
        # no host port wanted anywhere in the batch: no node conflicts, and
        # the port ledger passes through
        use_ports=policy.has_predicate("GeneralPredicates", "PodFitsHostPorts",
                                       "PodFitsPorts") and flags.ports,
        dyn_gpu=flags.gpu,
        dyn_storage=flags.storage,
        w_lr=policy.weight("LeastRequestedPriority"),
        w_ba=policy.weight("BalancedResourceAllocation"),
        w_ss=policy.weight("SelectorSpreadPriority") if flags.spread else 0,
        use_ipa=policy.has_predicate("MatchInterPodAffinity") and flags.ipa,
        w_ip=policy.weight("InterPodAffinityPriority") if flags.ipa else 0,
        hard_w=float(policy.hard_pod_affinity_weight),
        w_tt=policy.weight("TaintTolerationPriority") if flags.tt else 0,
        w_na=policy.weight("NodeAffinityPriority") if flags.na else 0,
        const_score=const_score,
    )


# predicates the fused static mask applies unconditionally
_FUSED_PREDICATES = (("GeneralPredicates", "PodFitsHost", "HostName"),
                     ("GeneralPredicates", "MatchNodeSelector"),
                     ("PodToleratesNodeTaints",), ("CheckNodeCondition",),
                     ("CheckNodeMemoryPressure",), ("CheckNodeDiskPressure",))
_STATIC_PRIORITIES = ("EqualPriority", "ImageLocalityPriority",
                      "MostRequestedPriority")


def check_supported(policy: Policy, flags: BatchFlags) -> PolicyGates:
    """The gates of a (policy, flags) pair this solver implements; raises
    NotImplementedError naming every gate or registration it does not."""
    # spread, ipa, gang, tt, na, preempt, ports, gpu and storage are
    # carried; svcanti is neutral without a ServiceAntiAffinity
    # registration, which the PolicyRows check below refuses
    raised = [f.name for f in fields(BatchFlags) if getattr(flags, f.name)
              and f.name not in ("spread", "svcanti", "ipa", "gang", "tt", "na",
                                 "preempt", "ports", "gpu", "storage")]
    if raised:
        raise NotImplementedError(
            f"batch raises solver gates {raised}: only the main path and "
            f"the spread, ipa, gang, tt, na, preempt, ports, gpu and storage "
            f"gates are implemented")
    if flags.spread and policy.weight("ServiceSpreadingPriority"):
        raise NotImplementedError(
            "ServiceSpreadingPriority with a weight is not implemented")
    if (active_label_presence(policy) or active_label_priorities(policy)
            or active_service_anti(policy) or policy.service_affinity_predicates):
        raise NotImplementedError(
            "policy carries argument registrations (PolicyRows)")
    missing = [names[0] for names in _FUSED_PREDICATES
               if not policy.has_predicate(*names)]
    if missing:
        raise NotImplementedError(
            f"policy lacks {missing}: only policies the fused static mask "
            f"covers are implemented")
    extra = [n for n in _STATIC_PRIORITIES if policy.weight(n)]
    if extra:
        raise NotImplementedError(f"priorities {extra} are not implemented")
    g = policy_gates(policy, flags)
    if not g.use_resources:
        raise NotImplementedError("policy without PodFitsResources")
    if g.use_ext and (g.use_terms or g.w_ss):
        raise NotImplementedError(
            "host ports / GPU or storage requests with SelectorSpread or "
            "inter-pod affinity are not implemented: the EXT variant is in "
            "the main and gang builds only")
    return g


@dataclass
class SolverResult:
    assignments: torch.Tensor      # i32[P] node row, -1 = unschedulable (or padding)
    scores: torch.Tensor           # f32[P] winning node's score (0 when unassigned)
    feasible_counts: torch.Tensor  # i32[P] nodes that passed all predicates
    new_requested: torch.Tensor    # f32[N, R] ledger after the batch
    new_nonzero: torch.Tensor      # f32[N, 2]
    rr_end: torch.Tensor           # i64 scalar: round-robin counter mod 2^32
    # f32[N, UQ] pod-selector ledger after the batch when the scan carried
    # it (the spread and interpod builds); None when the batch's program
    # passed it through
    new_podsel: torch.Tensor | None
    # f32[N, UE] carried-term ledger after the batch when the scan carried
    # it (the interpod build), else None
    new_term: torch.Tensor | None = None
    # i64 scalars: the batch's groups that reached their quorum and those
    # reverted (the gang build), else None
    gang_placed: torch.Tensor | None = None
    gang_reverted: torch.Tensor | None = None
    # i32[P]: the preemption pass's verdicts for the pods the scan left
    # unplaced, the node whose first victim_count candidates of its
    # VictimTable row the pod would evict (-1, 0: no set, or the pass off)
    preempt_node: torch.Tensor | None = None
    victim_count: torch.Tensor | None = None
    # f32[N, UP] host-port counts after the batch when the scan carried
    # them (PodFitsHostPorts ran), else None (passed through)
    new_port_count: torch.Tensor | None = None


def _static_rest(state: ClusterState, batch: PodBatch,
                 policy: Policy) -> torch.Tensor:
    """The static terms the fused kernel does not cover: required node
    affinity and the volume zone / node predicates."""
    ok = preds.node_affinity_ok(state, batch)
    if policy.has_predicate("NoVolumeZoneConflict"):
        ok &= preds.volume_zone(state, batch)
    if policy.has_predicate("NoVolumeNodeConflict"):
        ok &= preds.volume_node(state, batch)
    return ok


def _static_score(state: ClusterState, batch: PodBatch, policy: Policy,
                  const_score: float) -> torch.Tensor:
    """Assignment-independent score terms: f32[P, N]."""
    shape = (batch.valid.shape[0], state.valid.shape[0])
    score = torch.full(shape, float(const_score), dtype=torch.float32,
                       device=state.valid.device)
    w = policy.weight("NodePreferAvoidPodsPriority")
    if w:
        score = score + w * prios.node_prefer_avoid(state, batch)
    return score


def masked_static_scores(state: ClusterState, batch: PodBatch, policy: Policy,
                         g: PolicyGates, mask_fn=static_mask) -> torch.Tensor:
    """Phase A: f32[P, N], the static score where the pod is valid and the
    node statically feasible, -inf elsewhere."""
    fused = mask_fn(batch.sel_onehot, batch.sel_count,
                    preds.untolerated(state, batch), batch.best_effort,
                    batch.node_name_lo, batch.node_name_hi, state.sel_member,
                    state.taint_hard_member, node_bits(state), state.name_lo,
                    state.name_hi)
    ok = fused & _static_rest(state, batch, policy)
    # resource columns the batch does not request (gpu/storage) hold against
    # the batch-start ledger for the whole batch: hoisted out of the scan
    if not (g.dyn_gpu and g.dyn_storage):
        ok &= preds.fits_resources_static(state, batch.requests, g.dyn_gpu,
                                          g.dyn_storage)
    ok &= batch.valid[:, None]
    score = _static_score(state, batch, policy, g.const_score)
    return torch.where(ok, score, float("-inf"))


def interpod_inputs(state: ClusterState, batch: PodBatch, g: PolicyGates,
                    domain_universe: int) -> InterpodInputs:
    """The interpod build's operands of one batch."""
    return InterpodInputs(
        use_ipa=g.use_ipa, w_ip=float(g.w_ip), hard_w=g.hard_w,
        **{name: getattr(batch, name).contiguous() for name in POD_ROW_FIELDS},
        **{name: getattr(state, name) for name in (
            "podsel_count", "term_count", "topology", "term_q", "term_tkey",
            "term_kind", "term_weight", "term_poison")},
        domain_universe=domain_universe)


def gang_member_mask(gang_id: torch.Tensor, gang_min: torch.Tensor,
                     assignments: torch.Tensor, scores: torch.Tensor):
    """Every member of a group below its quorum out of the scan's result
    (kubernetes_tpu/ops/solver.py:837-853): groups are runs of equal
    gang_id, found by a boundary cumsum, and a run's placed members are one
    index_add. Returns (assignments, scores, groups placed, groups
    reverted), the counts as i64 scalars."""
    p = gang_id.shape[0]
    first, seg = group_runs(gang_id)
    placed = torch.zeros((p,), dtype=torch.int64, device=gang_id.device)
    placed.index_add_(0, seg, (assignments >= 0).to(torch.int64))
    failed = (gang_id > 0) & (placed[seg] < gang_min)
    opened = first & (gang_id > 0)
    return (torch.where(failed, -1, assignments),
            torch.where(failed, 0.0, scores),
            (opened & ~failed).sum(), (opened & failed).sum())


def spread_inputs(state: ClusterState, batch: PodBatch, g: PolicyGates,
                  domain_universe: int, spread_zones: int | None) -> SpreadInputs:
    """The spread build's operands of one batch (`spread_zones` None: the
    whole universe)."""
    return SpreadInputs(
        w_ss=float(g.w_ss), spread_q=batch.spread_q.contiguous(),
        pod_matches_q=batch.pod_matches_q.contiguous(),
        podsel_count=state.podsel_count, topology=state.topology,
        domain_universe=domain_universe,
        zones=domain_universe if spread_zones is None else spread_zones)


def spread_interpod_inputs(state: ClusterState, batch: PodBatch, g: PolicyGates,
                           domain_universe: int, spread_zones: int | None):
    """The spread+interpod build's operands of one batch: (SpreadInputs,
    InterpodInputs), the first holding the second's match rows."""
    ip = interpod_inputs(state, batch, g, domain_universe)
    return replace(spread_inputs(state, batch, g, domain_universe, spread_zones),
                   pod_matches_q=ip.pod_matches_q), ip


def scan_norm_inputs(state: ClusterState, batch: PodBatch,
                     g: PolicyGates) -> NormInputs | None:
    """The normalization flag's operands of one batch (TaintToleration and
    NodeAffinity), or None when the gates leave both weights 0."""
    if not (g.w_tt or g.w_na):
        return None
    return norm_inputs(g.w_tt, g.w_na, state.taint_prefer_member,
                       state.req_member, preds.untolerated(state, batch),
                       batch.pref_onehot, batch.pref_weight)


def _solve(state, batch, rr_start, policy, flags, caps, spread_zones, mask_fn,
           scan_fn, spread_fn, interpod_fn, gang_fn, spread_interpod_fn,
           victims=None, preempt_fn=preemption_pass_plain, spread_gang_fn=None,
           interpod_gang_fn=None, spread_interpod_gang_fn=None, ext_fn=None,
           gang_ext_fn=None):
    if flags is None:
        flags = batch_flags(state, batch)
    g = check_supported(policy, flags)
    masked = masked_static_scores(state, batch, policy, g, mask_fn)
    norm = scan_norm_inputs(state, batch, g)
    args = (masked, batch.requests, batch.nonzero_requests, state.allocatable,
            state.requested, state.nonzero_requested, rr_start,
            float(g.w_lr), float(g.w_ba))
    universe = (caps or Capacities()).domain_universe
    # the build's own operands, then the gang carry's where the batch has
    # groups; every build takes the flag's operands last
    if g.use_terms and g.w_ss:
        build = (spread_interpod_fn, spread_interpod_gang_fn)
        operands = spread_interpod_inputs(state, batch, g, universe, spread_zones)
    elif g.use_terms:
        build = (interpod_fn, interpod_gang_fn)
        operands = (interpod_inputs(state, batch, g, universe),)
    elif g.w_ss:
        build = (spread_fn, spread_gang_fn)
        operands = (spread_inputs(state, batch, g, universe, spread_zones),)
    elif g.use_ext:
        build = (ext_fn, gang_ext_fn)
        operands = (ExtInputs(use_ports=g.use_ports,
                              port_onehot=batch.port_onehot.contiguous(),
                              port_count=state.port_count),)
    else:
        build = (scan_fn, gang_fn)
        operands = ()
    if flags.gang:
        scan = build[1](*args, *operands, GangInputs(
            gang_id=batch.gang_id.contiguous(),
            gang_min=batch.gang_min.contiguous()), norm)
    else:
        scan = build[0](*args, *operands, norm)
    assignments, scores = scan.assignments, scan.scores
    placed = reverted = None
    if flags.gang:
        assignments, scores, placed, reverted = gang_member_mask(
            batch.gang_id, batch.gang_min, assignments, scores)
    if flags.preempt and victims is not None:
        preempt_node, victim_count = preempt_fn(
            state.allocatable, scan.new_requested, masked, batch.requests,
            batch.priority.contiguous(),
            participants(batch.valid, assignments).contiguous(),
            batch.gang_id.contiguous(), victims, flags.gang)
    else:
        preempt_node = torch.full_like(assignments, -1)
        victim_count = torch.zeros_like(assignments)
    return SolverResult(
        assignments=assignments, scores=scores,
        feasible_counts=scan.feasible_counts,
        new_requested=scan.new_requested, new_nonzero=scan.new_nonzero,
        rr_end=scan.rr_end, new_podsel=scan.new_podsel,
        new_term=scan.new_term, gang_placed=placed, gang_reverted=reverted,
        preempt_node=preempt_node, victim_count=victim_count,
        new_port_count=scan.new_port_count)


def schedule_batch(state: ClusterState, batch: PodBatch, rr_start,
                   policy: Policy = DEFAULT_POLICY,
                   flags: BatchFlags | None = None,
                   caps: Capacities | None = None,
                   spread_zones: int | None = None,
                   victims: VictimTable | None = None) -> SolverResult:
    """Schedule a whole pending batch against the accounted state.

    All tensors live on one device: CUDA tensors run the kernels, CPU
    tensors their plain versions. `rr_start` is the round-robin counter (an
    int or an i64 scalar tensor, taken mod 2^32). `flags` defaults to the
    gates read from the batch (state.pod_batch.batch_flags); `caps` gives
    the zone-domain universe SelectorSpread sums over (default
    Capacities()), and the domain universe of the topology slots
    inter-pod affinity aggregates over; `spread_zones`, the zone ids in use
    (`NodeTable.spread_zones`, default the whole universe), bounds what the
    spread build sums and exchanges. `victims` (a VictimTable on the same
    device) runs the preemption pass when the flags raise preempt (JAX
    `schedule_batch(victims=)`: a batch without priorities, or a caller
    with nothing evictable, runs without it). Gang groups are settled in
    whichever build the other gates pick, the inter-pod and pod-selector
    ledgers reverted with the resource ledger (JAX `_live_ledger`). Returns
    per-pod assignments, the post-batch ledgers (assume semantics) and the
    pass's verdicts."""
    return _solve(state, batch, rr_start, policy, flags, caps, spread_zones,
                  static_mask, assign_scan, assign_scan_spread,
                  assign_scan_interpod, assign_scan_gang,
                  assign_scan_spread_interpod, victims, preemption_pass,
                  assign_scan_spread_gang, assign_scan_interpod_gang,
                  assign_scan_spread_interpod_gang, assign_scan_ext,
                  assign_scan_gang_ext)


def schedule_batch_plain(state: ClusterState, batch: PodBatch, rr_start,
                         policy: Policy = DEFAULT_POLICY,
                         flags: BatchFlags | None = None,
                         caps: Capacities | None = None,
                         victims: VictimTable | None = None) -> SolverResult:
    """`schedule_batch` through the kernels' plain versions on any device:
    the reference a card run holds the kernel path against (it sums
    SelectorSpread's zones over the whole universe)."""
    return _solve(state, batch, rr_start, policy, flags, caps, None,
                  static_mask_plain, assign_scan_plain,
                  assign_scan_spread_plain, assign_scan_interpod_plain,
                  assign_scan_gang_plain, assign_scan_spread_interpod_plain,
                  victims, preemption_pass_plain, assign_scan_spread_gang_plain,
                  assign_scan_interpod_gang_plain,
                  assign_scan_spread_interpod_gang_plain, assign_scan_ext_plain,
                  assign_scan_gang_ext_plain)
