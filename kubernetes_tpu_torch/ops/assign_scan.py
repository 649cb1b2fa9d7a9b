"""Kernel 2: the serial assignment scan (Phase B of the batch solver).

Counterpart of the reference solver's `lax.scan` over the pods
(kubernetes_tpu/ops/solver.py `step` and `_select_host`), which has no
Pallas source: in eager PyTorch each pod would cost about fifteen launches,
so the whole scan is one CUDA launch of one thread-block cluster
(csrc/assign_scan.cu; its header gives the design and the bound).

Eight builds of the kernel, chosen at compile time:
- `assign_scan`, the main path's scan (resource fit, LeastRequested and
  BalancedAllocation, the round-robin tie-break, the resource ledger);
- `assign_scan_spread`, the same scan plus SelectorSpread over the
  feasible nodes and the pod-selector ledger it reads (the JAX step's
  `selector_spread` term and `ledger_add`, solver.py:579-581);
- `assign_scan_interpod`, the main scan plus inter-pod (anti-)affinity:
  its predicate, its priority normalized over the feasible nodes, and the
  pod-selector, carried-term and domain ledgers it reads (the JAX step's
  `interpod_feasible`, `interpod_counts`, `interpod_score` and
  `ledger_add` with terms, solver.py:549-551,574-577,783-784);
- `assign_scan_spread_interpod`, the main scan plus both of the above over
  one pod-selector ledger: the inter-pod predicate first, then the
  priority and SelectorSpread, each over the nodes feasible after it, in
  the JAX step's order (solver.py:548-551,574-581), and each placed pod's
  match and carried-term rows added once (solver.py:783-785);
- `assign_scan_gang`, the main scan plus the gang carry (solver.py:738-764,
  795-798 and the close-out of :825-836): where a pod's group id differs
  from the previous pod's, the group being left is settled first (below
  its quorum of placed members, the ledger and the round-robin counter go
  back to what they were when it opened), and the last open group is
  settled after the last pod, so the returned ledger and rr_end are final.
  Assignments and scores come back as the scan made them; the solver masks
  the members of reverted groups out afterwards (solver.py:837-853);
- `assign_scan_ext` and `assign_scan_gang_ext`, the main and gang builds
  with the EXT variant: host ports (PodFitsHostPorts against the running
  host-port counts, the JAX step's `fits_host_ports` and its `port_count`
  carry, solver.py:537-539,780-781) and the gpu and storage fit against
  the running ledger (`fits_resources_dyn` with `dyn_gpu` and
  `dyn_storage`, predicates.py:93, the overlay request falling through to
  scratch on a node without overlay allocatable), and volumes:
  NoDiskConflict against the running disk-conflict counts and
  MaxPDVolumeCount against the running attach counts (the JAX step's
  `no_disk_conflict` and `max_attach_ok` and their `vol_any`, `vol_rw` and
  `attach_count` carry, solver.py:541-547,786-792); a reverted group also
  gives back its host ports and volumes (`new_port_count`, `new_vol_any`,
  `new_vol_rw`, `new_attach`);
- `assign_scan_spread_gang`, `assign_scan_interpod_gang` and
  `assign_scan_spread_interpod_gang`, the spread, interpod and
  spread+interpod builds with the gang carry: a reverted group also gives
  back what it added to the pod-selector, carried-term and domain ledgers,
  as JAX's `_live_ledger` restores the whole inter-pod ledger
  (solver.py:357-363).

Every build also takes the normalization flag at run time (`norm`,
NormInputs, None = off): TaintToleration and NodeAffinity, each normalized
over the pod's feasible nodes (after the inter-pod predicate where the
build applies it), the JAX step's `taint_toleration_from_counts` and
`normalized_from_counts` terms (solver.py:568-573), with counts taken from
64-bit words: a node's PreferNoSchedule taints and satisfied requirements,
a pod's untolerated taints and preferred terms (`norm_inputs`).

Each wrapper launches its build on CUDA tensors (and counts the launch in
`<wrapper>.launches`, and in `<wrapper>.norm_launches` when the flag is
on), runs its plain version, a Python loop of tensor
ops, on CPU tensors, and raises on any other device.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from types import SimpleNamespace

import torch

from kubernetes_tpu_torch.ops.interpod import (
    domain_aggregates,
    interpod_counts,
    interpod_feasible,
    interpod_score,
    ledger_add,
    make_ledger,
    topology_onehot,
)
from kubernetes_tpu_torch.ops.predicates import (
    fits_host_ports,
    fits_resources_dyn,
    max_attach_ok,
    no_disk_conflict,
)
from kubernetes_tpu_torch.ops.preemption import group_runs
from kubernetes_tpu_torch.ops.priorities import (
    balanced_allocation,
    least_requested,
    normalized_from_counts,
    taint_toleration_from_counts,
)
from kubernetes_tpu_torch.ops.spread import selector_spread
from kubernetes_tpu_torch.state.layout import TOPO_SPREAD_ZONE, VolType
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
    new_podsel: torch.Tensor | None = None  # f32[N, UQ], spread and interpod builds
    new_term: torch.Tensor | None = None    # f32[N, UE], builds with the interpod half
    new_port_count: torch.Tensor | None = None  # f32[N, UP], the EXT builds with ports
    new_vol_any: torch.Tensor | None = None     # f32[N, UV], EXT with NoDiskConflict
    new_vol_rw: torch.Tensor | None = None      # f32[N, UV]
    new_attach: torch.Tensor | None = None      # f32[N, UA], EXT with MaxPDVolumeCount


def _rr_tensor(rr_start, device) -> torch.Tensor:
    """rr as an i64 scalar tensor on `device`, reduced mod 2^32."""
    if isinstance(rr_start, torch.Tensor):
        return (rr_start.to(device=device, dtype=torch.int64) % RR_MOD).reshape(())
    return torch.tensor(int(rr_start) % RR_MOD, dtype=torch.int64, device=device)


@dataclass
class SpreadInputs:
    """What the spread build reads beyond the main scan's operands: the
    SelectorSpread weight, each pod's union entry (spread_q i32[P], -1 =
    none) and match row (pod_matches_q f32[P, UQ]), the batch-start
    pod-selector ledger (podsel_count f32[N, UQ], not modified), the
    nodes' topology (i32[N, K], -1 = no domain), whose GetZoneKey slot
    (TOPO_SPREAD_ZONE) holds ids below `domain_universe`, and `zones`, the
    zone ids in use: no node's id lies in [zones, domain_universe) (the
    host's count of interned spread zones, `NodeTable.spread_zones`). The
    plain version sums over the whole universe; the kernel sums and
    exchanges the zones in use only, and traps on an id it was not told
    of."""

    w_ss: float
    spread_q: torch.Tensor
    pod_matches_q: torch.Tensor
    podsel_count: torch.Tensor
    topology: torch.Tensor
    domain_universe: int
    zones: int


@dataclass
class InterpodInputs:
    """What the interpod build reads beyond the main scan's operands:
    whether the predicate runs (use_ipa, MatchInterPodAffinity), the
    priority's weight w_ip and hardPodAffinityWeight hard_w; per pod its
    match row (pod_matches_q f32[P, UQ]), carried-term row (pod_carries_e
    f32[P, UE]), required affinity and anti-affinity terms (paff_q,
    paff_tkey, panti_q, panti_tkey i32[P, IA], -1 = unused), preferred
    terms (ppref_q, ppref_tkey i32[P, IP], ppref_w f32[P, IP]) and
    ipaff_fail (bool[P]); the batch-start ledgers (podsel_count f32[N, UQ],
    term_count f32[N, UE], not modified); the nodes' topology (i32[N, K],
    -1 = no domain, ids of the non-hostname slots below domain_universe);
    and the carried terms' attributes (term_q, term_tkey, term_kind
    i32[UE], term_weight f32[UE], term_poison bool[UE])."""

    use_ipa: bool
    w_ip: float
    hard_w: float
    pod_matches_q: torch.Tensor
    pod_carries_e: torch.Tensor
    paff_q: torch.Tensor
    paff_tkey: torch.Tensor
    panti_q: torch.Tensor
    panti_tkey: torch.Tensor
    ppref_q: torch.Tensor
    ppref_tkey: torch.Tensor
    ppref_w: torch.Tensor
    ipaff_fail: torch.Tensor
    podsel_count: torch.Tensor
    term_count: torch.Tensor
    topology: torch.Tensor
    term_q: torch.Tensor
    term_tkey: torch.Tensor
    term_kind: torch.Tensor
    term_weight: torch.Tensor
    term_poison: torch.Tensor
    domain_universe: int


@dataclass
class GangInputs:
    """What the gang build reads beyond the main scan's operands: each
    pod's batch-local group id (gang_id i32[P], 0 = none; a group's members
    are consecutive rows) and its group's quorum (gang_min i32[P])."""

    gang_id: torch.Tensor
    gang_min: torch.Tensor


@dataclass
class ExtInputs:
    """What the EXT variant of the main and gang builds reads beyond their
    operands: whether PodFitsHostPorts runs (use_ports), each pod's
    host-port row (port_onehot f32[P, UP], a port listed twice counts 2)
    and the batch-start host-port counts (port_count f32[N, UP], not
    modified), UP at most 64. A pod conflicts on a node where
    port_count @ port_onehot is not 0. The gpu, scratch and overlay
    requests are fit against the running ledger, whatever use_ports.

    With use_nodisk (NoDiskConflict), each pod's conflict rows (vol_want_rw
    and vol_want_ro f32[P, UV], counts: a disk listed twice counts 2) and
    the batch-start conflict counts (vol_any, every mount, and vol_rw, the
    read-write ones, f32[N, UV]); with attach_maxes ((VolType, limit), at
    most three pairs: MaxPDVolumeCount), each pod's attach row and fail bit
    (att_onehot f32[P, UA], 0/1, att_fail bool[P]), the batch-start attach
    counts (attach_count f32[N, UA]) and the atoms' types (attach_type
    i32[UA]). UV and UA at most 64; none of the counts is modified."""

    use_ports: bool
    port_onehot: torch.Tensor
    port_count: torch.Tensor
    use_nodisk: bool = False
    vol_want_rw: torch.Tensor | None = None
    vol_want_ro: torch.Tensor | None = None
    vol_any: torch.Tensor | None = None
    vol_rw: torch.Tensor | None = None
    attach_maxes: tuple = ()
    att_onehot: torch.Tensor | None = None
    att_fail: torch.Tensor | None = None
    attach_count: torch.Tensor | None = None
    attach_type: torch.Tensor | None = None


def ext_carried(ext: ExtInputs) -> list:
    """The ledgers the EXT variant carries, as (ScanResult field,
    batch-start counts f32[N, U], each pod's addition f32[P, U]): the
    host-port counts with use_ports, the conflict counts with use_nodisk
    (a mount adds to vol_any, a read-write one to vol_rw too), the attach
    counts with attach_maxes."""
    out = []
    if ext.use_ports:
        out.append(("new_port_count", ext.port_count, ext.port_onehot))
    if ext.use_nodisk:
        out.append(("new_vol_any", ext.vol_any, ext.vol_want_rw + ext.vol_want_ro))
        out.append(("new_vol_rw", ext.vol_rw, ext.vol_want_rw))
    if ext.attach_maxes:
        out.append(("new_attach", ext.attach_count, ext.att_onehot))
    return out


def ext_fits(ext: ExtInputs, ledgers: dict, p: int) -> torch.Tensor | None:
    """bool[N]: pod p's host ports, disks and attach limits on the running
    ledgers (`ledgers`, by ScanResult field, as `ext_carried` names them),
    or None where the variant checks none of them."""
    ok = None
    if ext.use_ports:
        ok = fits_host_ports(ledgers["new_port_count"], ext.port_onehot[p:p + 1])[0]
    if ext.use_nodisk:
        disk = no_disk_conflict(ledgers["new_vol_any"], ledgers["new_vol_rw"],
                                ext.vol_want_rw[p:p + 1], ext.vol_want_ro[p:p + 1])[0]
        ok = disk if ok is None else ok & disk
    if ext.attach_maxes:
        att = max_attach_ok(ledgers["new_attach"], ext.attach_type,
                            ext.att_onehot[p:p + 1], ext.att_fail[p:p + 1],
                            ext.attach_maxes)[0]
        ok = att if ok is None else ok & att
    return ok


@dataclass
class NormInputs:
    """What the normalization flag adds to any build (`norm_inputs` makes
    it): the TaintToleration and NodeAffinity weights (w_tt, w_na), each
    node's PreferNoSchedule taint word and satisfied-requirement word
    (node_taint, node_req i64[N]: bit u is taint / requirement u), each
    pod's untolerated word (pod_untol i64[P], limited to the taints some
    node carries) and its preferred terms' words (pod_terms i64[P, 4], bit
    u: the term holds requirement u) with their weights (pod_weights
    f32[P, 4]: integers up to 65,535, 0 for a slot that never scores)."""

    w_tt: float
    w_na: float
    node_taint: torch.Tensor
    node_req: torch.Tensor
    pod_untol: torch.Tensor
    pod_terms: torch.Tensor
    pod_weights: torch.Tensor


# bits of a word (the taint and requirement universes the flag takes),
# preferred-term slots a pod, and the largest preferred weight (the kernel's
# packed counts stay below 2^24; csrc/assign_scan.cu NM_MAX_WEIGHT)
NORM_MAX_U = 64
NORM_SLOTS = 4
NORM_MAX_WEIGHT = 65535


def pack_words(member: torch.Tensor) -> torch.Tensor:
    """i64[...]: bit u set where member[..., u] != 0, for at most 64
    columns, ORed together (bit 63 is the sign bit, so never summed)."""
    u = member.shape[-1]
    if u > NORM_MAX_U:
        raise ValueError(f"pack_words: {u} columns > {NORM_MAX_U}")
    bits = ((member != 0).to(torch.int64)
            << torch.arange(u, dtype=torch.int64, device=member.device))
    width = 1
    while width < u:
        width *= 2
    if width > u:
        bits = torch.cat([bits, bits.new_zeros((*bits.shape[:-1], width - u))], -1)
    while width > 1:
        width //= 2
        bits = bits[..., :width] | bits[..., width:]
    return bits[..., 0]


def norm_inputs(w_tt: float, w_na: float, taint_prefer_member: torch.Tensor,
                req_member: torch.Tensor, untolerated: torch.Tensor,
                pref_onehot: torch.Tensor,
                pref_weight: torch.Tensor) -> NormInputs:
    """The flag's words from the JAX layout's columns: taint_prefer_member
    f32[N, UT], req_member f32[N, UR], untolerated f32[P, UT] (1 = not
    tolerated), pref_onehot f32[P, TP, UR] (a term's distinct requirement
    ids) and pref_weight f32[P, TP]. ValueError past UT, UR = 64 or TP = 4,
    or for a preferred weight that is not an integer in [0, 65,535]."""
    ut, ur, tp = untolerated.shape[1], req_member.shape[1], pref_onehot.shape[1]
    if ut > NORM_MAX_U or ur > NORM_MAX_U or tp > NORM_SLOTS:
        raise ValueError(
            f"norm_inputs: {ut} taints and {ur} requirements (at most "
            f"{NORM_MAX_U} each), {tp} preferred terms (at most {NORM_SLOTS})")
    p = untolerated.shape[0]
    pad = NORM_SLOTS - tp
    terms = pack_words(pref_onehot)
    weights = pref_weight.to(torch.float32)
    bad = ~((weights >= 0) & (weights <= NORM_MAX_WEIGHT)
            & (weights == torch.trunc(weights)))
    if bool(bad.any()):
        raise ValueError(
            f"norm_inputs: preferred term weight {float(weights[bad][0])} is "
            f"not an integer in [0, {NORM_MAX_WEIGHT}]")
    if pad:
        terms = torch.cat([terms, terms.new_zeros((p, pad))], 1)
        weights = torch.cat([weights, weights.new_zeros((p, pad))], 1)
    node_taint = pack_words(taint_prefer_member)
    # a bit no node carries counts nowhere: the pod's word drops it, so a
    # pod untolerant only of such taints needs no maxima
    carried = pack_words(taint_prefer_member.any(0, keepdim=True))
    return NormInputs(
        w_tt=float(w_tt), w_na=float(w_na), node_taint=node_taint,
        node_req=pack_words(req_member),
        pod_untol=pack_words(untolerated) & carried,
        pod_terms=terms.contiguous(), pod_weights=weights.contiguous())


def popcount64(x: torch.Tensor) -> torch.Tensor:
    """i64: the set bits of each i64 word (bit 63 included)."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return x & 0x7F


def norm_counts(norm: NormInputs, p: int):
    """(TaintToleration counts, NodeAffinity counts), f32[N] each, of pod p
    from the words, as the kernel takes them: the popcount of node_taint &
    pod_untol, and the weights of the positively weighted terms t with
    (node_req & t) == t, added in slot order."""
    tt = popcount64(norm.node_taint & norm.pod_untol[p]).to(torch.float32)
    na = torch.zeros_like(tt)
    for k in range(NORM_SLOTS):
        term, w = norm.pod_terms[p, k], norm.pod_weights[p, k]
        na = na + torch.where(((norm.node_req & term) == term) & (w > 0), w, 0.0)
    return tt, na


# the InterpodInputs fields with a row a pod
POD_ROW_FIELDS = ("pod_matches_q", "pod_carries_e", "paff_q", "paff_tkey",
                  "panti_q", "panti_tkey", "ppref_q", "ppref_tkey", "ppref_w",
                  "ipaff_fail")


def assign_scan_plain(masked_static, requests, nonzero_requests, allocatable,
                      requested, nonzero, rr_start, w_lr: float = 1.0,
                      w_ba: float = 1.0, norm: NormInputs | None = None) -> ScanResult:
    """The scan as a loop over pods of N-wide tensor ops (the CPU path and
    the reference the kernel is held against on the card). Nothing leaves
    the device inside the loop. With `norm`, each pod's score also takes
    w_tt times TaintToleration and w_na times NodeAffinity over its
    feasible nodes, from the counts `norm_counts` takes off the words."""
    return _scan_plain(masked_static, requests, nonzero_requests, allocatable,
                       requested, nonzero, rr_start, w_lr, w_ba, None,
                       norm=norm)


def assign_scan_spread_plain(masked_static, requests, nonzero_requests,
                             allocatable, requested, nonzero, rr_start,
                             w_lr: float, w_ba: float,
                             spread: SpreadInputs,
                             norm: NormInputs | None = None) -> ScanResult:
    """`assign_scan_plain` plus, for each pod, `w_ss` times SelectorSpread
    over the nodes feasible after the dynamic fit, and the pod's match row
    added to the pod-selector ledger at the chosen node (`new_podsel`)."""
    return _scan_plain(masked_static, requests, nonzero_requests, allocatable,
                       requested, nonzero, rr_start, w_lr, w_ba, spread,
                       norm=norm)


def assign_scan_interpod_plain(masked_static, requests, nonzero_requests,
                               allocatable, requested, nonzero, rr_start,
                               w_lr: float, w_ba: float,
                               interpod: InterpodInputs,
                               norm: NormInputs | None = None) -> ScanResult:
    """`assign_scan_plain` with inter-pod (anti-)affinity: for each pod,
    InterPodAffinityMatches (when `use_ipa`) ANDed into the feasible nodes,
    `w_ip` times InterPodAffinityPriority normalized over them added to the
    score, and the pod's match and carried-term rows added to the ledgers
    and domain aggregates at the chosen node (`new_podsel`, `new_term`)."""
    return _scan_plain(masked_static, requests, nonzero_requests, allocatable,
                       requested, nonzero, rr_start, w_lr, w_ba, None,
                       interpod, norm=norm)


def assign_scan_spread_interpod_plain(masked_static, requests,
                                      nonzero_requests, allocatable,
                                      requested, nonzero, rr_start,
                                      w_lr: float, w_ba: float,
                                      spread: SpreadInputs,
                                      interpod: InterpodInputs,
                                      norm: NormInputs | None = None) -> ScanResult:
    """`assign_scan_plain` with inter-pod (anti-)affinity and SelectorSpread
    over one ledger: for each pod, InterPodAffinityMatches (when `use_ipa`)
    ANDed into the feasible nodes, then `w_ip` times InterPodAffinityPriority
    and `w_ss` times SelectorSpread, both over those nodes, added to the
    score in that order, and the pod's match and carried-term rows added
    once to the ledgers and domain aggregates at the chosen node
    (`new_podsel`, `new_term`). `spread` and `interpod` carry the same
    pod-selector ledger, topology and match rows."""
    return _scan_plain(masked_static, requests, nonzero_requests, allocatable,
                       requested, nonzero, rr_start, w_lr, w_ba, spread,
                       interpod, norm=norm)


def assign_scan_spread_gang_plain(masked_static, requests, nonzero_requests,
                                  allocatable, requested, nonzero, rr_start,
                                  w_lr: float, w_ba: float, spread: SpreadInputs,
                                  gang: GangInputs,
                                  norm: NormInputs | None = None) -> ScanResult:
    """`assign_scan_spread_plain` with the gang carry: a group settled below
    its quorum also gives back its pod-selector counts."""
    return _scan_plain(masked_static, requests, nonzero_requests, allocatable,
                       requested, nonzero, rr_start, w_lr, w_ba, spread,
                       gang=gang, norm=norm)


def assign_scan_interpod_gang_plain(masked_static, requests, nonzero_requests,
                                    allocatable, requested, nonzero, rr_start,
                                    w_lr: float, w_ba: float,
                                    interpod: InterpodInputs, gang: GangInputs,
                                    norm: NormInputs | None = None) -> ScanResult:
    """`assign_scan_interpod_plain` with the gang carry: a group settled
    below its quorum also gives back its pod-selector, carried-term and
    domain counts."""
    return _scan_plain(masked_static, requests, nonzero_requests, allocatable,
                       requested, nonzero, rr_start, w_lr, w_ba, None,
                       interpod, gang, norm)


def assign_scan_spread_interpod_gang_plain(masked_static, requests,
                                           nonzero_requests, allocatable,
                                           requested, nonzero, rr_start,
                                           w_lr: float, w_ba: float,
                                           spread: SpreadInputs,
                                           interpod: InterpodInputs,
                                           gang: GangInputs,
                                           norm: NormInputs | None = None) -> ScanResult:
    """`assign_scan_spread_interpod_plain` with the gang carry: a group
    settled below its quorum also gives back its pod-selector,
    carried-term and domain counts."""
    return _scan_plain(masked_static, requests, nonzero_requests, allocatable,
                       requested, nonzero, rr_start, w_lr, w_ba, spread,
                       interpod, gang, norm)


def assign_scan_gang_plain(masked_static, requests, nonzero_requests,
                           allocatable, requested, nonzero, rr_start,
                           w_lr: float, w_ba: float,
                           gang: GangInputs,
                           norm: NormInputs | None = None) -> ScanResult:
    """`assign_scan_plain` with the gang carry: at each group boundary the
    group being left is settled (below quorum, the ledgers and rr return to
    their values at the group's first member, as JAX's `_live_ledger`
    does), and after the last pod the group still open is settled the same
    way."""
    return _scan_plain(masked_static, requests, nonzero_requests, allocatable,
                       requested, nonzero, rr_start, w_lr, w_ba, None,
                       gang=gang, norm=norm)


def assign_scan_ext_plain(masked_static, requests, nonzero_requests,
                          allocatable, requested, nonzero, rr_start,
                          w_lr: float, w_ba: float, ext: ExtInputs,
                          norm: NormInputs | None = None) -> ScanResult:
    """`assign_scan_plain` with the EXT variant: each pod's gpu, scratch
    and overlay requests fit against the running ledger, and with
    `use_ports` its host ports against the running host-port counts, to
    which a placed pod's port row is added (`new_port_count`; None without
    `use_ports`, the counts passed through); with `use_nodisk` its disks
    against the running conflict counts and with `attach_maxes` its attach
    atoms against the running attach counts, likewise carried
    (`new_vol_any`, `new_vol_rw`, `new_attach`)."""
    return _scan_plain(masked_static, requests, nonzero_requests, allocatable,
                       requested, nonzero, rr_start, w_lr, w_ba, None,
                       norm=norm, ext=ext)


def assign_scan_gang_ext_plain(masked_static, requests, nonzero_requests,
                               allocatable, requested, nonzero, rr_start,
                               w_lr: float, w_ba: float, ext: ExtInputs,
                               gang: GangInputs,
                               norm: NormInputs | None = None) -> ScanResult:
    """`assign_scan_gang_plain` with the EXT variant: a group settled below
    its quorum also gives back its host-port, conflict and attach
    counts."""
    return _scan_plain(masked_static, requests, nonzero_requests, allocatable,
                       requested, nonzero, rr_start, w_lr, w_ba, None,
                       gang=gang, norm=norm, ext=ext)


def _scan_plain(masked_static, requests, nonzero_requests, allocatable,
                requested, nonzero, rr_start, w_lr, w_ba,
                spread: SpreadInputs | None,
                interpod: InterpodInputs | None = None,
                gang: GangInputs | None = None,
                norm: NormInputs | None = None,
                ext: ExtInputs | None = None) -> ScanResult:
    p_count, n = masked_static.shape
    dev = masked_static.device
    req = requested.clone()
    nz = nonzero.clone()
    rr = _rr_tensor(rr_start, dev)
    # the EXT variant: the gpu and storage columns fit against the running
    # ledger, and the host-port, conflict and attach counts carried where
    # their predicates run
    dyn = ext is not None
    carried_ext = ext_carried(ext) if dyn else []
    xled = {f: start.clone() for f, start, _add in carried_ext}
    assignments = torch.empty((p_count,), dtype=torch.int32, device=dev)
    scores = torch.empty((p_count,), dtype=torch.float32, device=dev)
    counts = torch.empty((p_count,), dtype=torch.int32, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    if spread is not None and interpod is None:
        ledger = make_ledger(spread.podsel_count)
        onehot = topology_onehot(spread.topology, spread.domain_universe)
    ip = interpod
    if ip is not None:
        ledger = make_ledger(ip.podsel_count, ip.term_count, ip.topology,
                             ip.domain_universe)
        onehot = topology_onehot(ip.topology, ip.domain_universe)
    if gang is not None:
        # group ids and quorums steer the loop; whether a group reached its
        # quorum stays on the device (`placed`)
        gang_ids = gang.gang_id.tolist()
        gang_mins = gang.gang_min.tolist()
        gang_cur, quorum = 0, 0
        placed = torch.zeros((), dtype=torch.int64, device=dev)
        carried = ledger if spread is not None or ip is not None else None

        def settle(req, nz, rr, xled):
            """The ledgers and rr after settling the open group (the
            affinity ledger in place)."""
            if gang_cur <= 0:
                return req, nz, rr, xled
            revert = placed < quorum
            if carried is not None:
                restore_ledger(carried, snap[3], revert)
            return (torch.where(revert, snap[0], req),
                    torch.where(revert, snap[1], nz),
                    torch.where(revert, snap[2], rr),
                    {f: torch.where(revert, snap[4][f], x) for f, x in xled.items()})
    for p in range(p_count):
        if gang is not None and gang_ids[p] != gang_cur:
            # a boundary: settle the group being left, then snapshot the
            # settled ledgers when this pod opens a group
            req, nz, rr, xled = settle(req, nz, rr, xled)
            if gang_ids[p] > 0:
                snap = (req.clone(), nz.clone(), rr.clone(),
                        None if carried is None else ledger_snapshot(carried),
                        {f: x.clone() for f, x in xled.items()})
                placed = torch.zeros_like(placed)
                quorum = gang_mins[p]
            gang_cur = gang_ids[p]
        ms = masked_static[p]
        feasible = (ms > float("-inf")) & fits_resources_dyn(
            allocatable, requests[p:p + 1], req, dyn_gpu=dyn,
            dyn_storage=dyn)[0]
        if xled:   # host ports, disks and attach limits on the running counts
            feasible = feasible & ext_fits(ext, xled, p)
        score = (ms + w_lr * least_requested(allocatable, nonzero_requests[p:p + 1], nz)[0]
                 + w_ba * balanced_allocation(allocatable, nonzero_requests[p:p + 1], nz)[0])
        if ip is not None:
            pod = SimpleNamespace(**{f: getattr(ip, f)[p] for f in POD_ROW_FIELDS})
            if ip.use_ipa:
                feasible = feasible & interpod_feasible(ip, pod, ledger, onehot)
        if norm is not None:   # over the nodes the predicate leaves
            tt_counts, na_counts = norm_counts(norm, p)
            if norm.w_tt:
                score = score + norm.w_tt * taint_toleration_from_counts(
                    tt_counts, feasible)
            if norm.w_na:
                score = score + norm.w_na * normalized_from_counts(
                    na_counts, feasible)
        if ip is not None:
            if ip.w_ip:
                score = score + ip.w_ip * interpod_score(
                    interpod_counts(ip, pod, ledger, ip.hard_w, onehot),
                    feasible)
        if spread is not None:
            score = score + spread.w_ss * selector_spread(
                spread.topology, spread.spread_q[p], ledger, feasible,
                spread.domain_universe, onehot)
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
        for f, _start, adds in carried_ext:
            xled[f][node] += add * adds[p]
        if spread is not None and ip is None:
            ledger_add(ledger, spread.pod_matches_q[p], node, add)
        if ip is not None:   # the pod-selector half serves SelectorSpread too
            ledger_add(ledger, ip.pod_matches_q[p], node, add,
                       ip.pod_carries_e[p], ip.topology)
        rr = (rr + assigned.to(torch.int64)) % RR_MOD
        if gang is not None and gang_cur > 0:
            placed = placed + assigned.to(torch.int64)
        assignments[p] = torch.where(assigned, node.to(torch.int32), -1)
        scores[p] = torch.where(assigned, best, 0.0)
        counts[p] = feasible.sum()
    if gang is not None:
        req, nz, rr, xled = settle(req, nz, rr, xled)   # the group open at the end
    if spread is None and ip is None:
        return ScanResult(assignments, scores, counts, req, nz, rr, **xled)
    return ScanResult(assignments, scores, counts, req, nz, rr,
                      ledger.podsel_count,
                      None if ip is None else ledger.term_count)


# the AffinityLedger's fields a gang revert restores (JAX's `_live_ledger`
# holds the whole of c.ipa)
LEDGER_FIELDS = ("podsel_count", "total_q", "term_count", "dom_podsel",
                 "dom_term", "total_e")


def ledger_snapshot(ledger) -> dict:
    """Copies of the ledger's tensors (the fields it carries)."""
    return {f: getattr(ledger, f).clone() for f in LEDGER_FIELDS
            if getattr(ledger, f) is not None}


def restore_ledger(ledger, snap: dict, revert) -> None:
    """Where `revert` (a bool, or a bool scalar tensor) holds, put the
    snapshot's tensors back into the ledger."""
    for f, old in snap.items():
        setattr(ledger, f, torch.where(torch.as_tensor(revert, device=old.device),
                                       old, getattr(ledger, f)))


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


def _check_operands(name, masked_static, requests, nonzero_requests,
                    allocatable, requested, nonzero) -> torch.device:
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
        raise ValueError(f"{name}: {r} resource columns, want 6")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _check_norm(norm: NormInputs | None, p: int, n: int, dev) -> None:
    """Check the NormInputs tensors of a p-pod, n-node batch."""
    if norm is None:
        return
    i64 = torch.int64
    for check in (("node_taint", norm.node_taint, i64, (n,)),
                  ("node_req", norm.node_req, i64, (n,)),
                  ("pod_untol", norm.pod_untol, i64, (p,)),
                  ("pod_terms", norm.pod_terms, i64, (p, NORM_SLOTS)),
                  ("pod_weights", norm.pod_weights, torch.float32, (p, NORM_SLOTS))):
        check_tensor(*check, dev)


# the flag's operands after every build's own: node words, pod rows, w_tt, w_na
_NORM_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_float] * 2


def norm_pod_rows(norm: NormInputs) -> torch.Tensor:
    """i32[P, 16]: each pod's row of the flag's words as the kernel reads it
    (the untolerated word, 4 term words, 4 weights as f32 bits, 2 of
    padding)."""
    p = norm.pod_untol.shape[0]
    words = torch.cat([norm.pod_untol[:, None], norm.pod_terms], 1).contiguous()
    return torch.cat([words.view(torch.int32),
                      norm.pod_weights.contiguous().view(torch.int32),
                      words.new_zeros((p, 2), dtype=torch.int32)], 1).contiguous()


def _norm_operands(norm: NormInputs | None):
    """The flag's device operands, (the tensors the pointers point into,
    which the caller holds until the launch is enqueued, and the launch's
    pointers and weights): i64[N, 2] node words and i32[P, 16] pod rows
    (`norm_pod_rows`); null pointers with the flag off."""
    if norm is None:
        return (), (None, None, 0.0, 0.0)
    node_w = torch.stack([norm.node_taint, norm.node_req], 1).contiguous()
    pod_w = norm_pod_rows(norm)
    return (node_w, pod_w), (node_w.data_ptr(), pod_w.data_ptr(),
                             float(norm.w_tt), float(norm.w_na))


# ---- a host model of the maxima table of the builds that guess the flag's
# maxima (every build but spread+interpod; the kernel header's guess and
# check), for counting the scan's second rounds

NORM_TABLE = 32                  # entries: one a lane of every warp
NORM_MIX = 0x9E3779B9            # the key's multiplier (the kernel's NM_MIX)


def norm_key_weight(l: int) -> int:
    """The odd multiplier of int l of a row in its key."""
    return ((2 * l + 1) * NORM_MIX) & 0xFFFFFFFF


def norm_row_key(row) -> int:
    """The table's key of one pod row (16 ints): the sum of int l times
    norm_key_weight(l), mod 2^32, as the kernel's warp takes it (a lane an
    int, one redux.sync)."""
    return sum((int(v) & 0xFFFFFFFF) * norm_key_weight(l)
               for l, v in enumerate(row)) & 0xFFFFFFFF


def norm_pack(mt: int, mn: int) -> int:
    """The maxima as the triple's free word carries them: mt | mn << 8."""
    return int(mt) | int(mn) << 8


class NormMaximaTable:
    """The kernel's maxima table: `entries` (key, packed maxima) pairs; a
    key not held guesses 0 and takes the entry after the last one taken
    (first in, first out), a key held keeps its entry and takes each pod's
    true maxima."""

    def __init__(self, entries: int = NORM_TABLE):
        self.keys: list[int | None] = [None] * entries
        self.words = [0] * entries
        self.next = 0

    def guess(self, key: int) -> tuple[int, int]:
        """(the guessed packed maxima, the key's entry or -1)."""
        for i, k in enumerate(self.keys):
            if k == key:
                return self.words[i], i
        return 0, -1

    def settle(self, key: int, at: int, word: int) -> None:
        """Record a pod's true maxima for its key (`at` from `guess`)."""
        if at < 0:
            at = self.next
            self.keys[at] = key
            self.next = (self.next + 1) % len(self.keys)
        self.words[at] = word

    def step(self, key: int, word: int) -> bool:
        """One exchanging pod: whether its guess missed `word` (a second
        round in the kernel); the table takes the word."""
        guess, at = self.guess(key)
        self.settle(key, at, word)
        return guess != word


def norm_exchanges(norm: NormInputs) -> list[bool]:
    """Per pod, whether the kernel takes and checks its maxima: an
    untolerated taint with w_tt set, or a positively weighted term with
    w_na set."""
    tt = (norm.pod_untol != 0) & bool(norm.w_tt)
    na = (norm.pod_weights > 0).any(1) & bool(norm.w_na)
    return (tt | na).tolist()


def norm_true_maxima(masked_static, requests, allocatable, requested, norm: NormInputs,
                     assignments, gang: GangInputs | None = None,
                     interpod: InterpodInputs | None = None,
                     ext: ExtInputs | None = None) -> list:
    """Per pod, the packed true maxima of the flag's counts over its
    feasible nodes (the static row and the ledger fit, with `ext` the EXT
    variant's fit, host ports, disks and attach limits over its carried
    ledgers, and with
    `interpod` the inter-pod predicate over the carried-term ledger, as the
    builds take them) as a scan that made `assignments` saw them, or None
    where the pod exchanges none: a replay of the ledgers from the
    assignments (a gang build's, members of reverted groups included,
    settled at each group boundary as the scan settles them, the
    carried-term ledger with the resource ledger), counts per distinct
    row."""
    p_count, _ = masked_static.shape
    exch = norm_exchanges(norm)
    rows = norm_pod_rows(norm).cpu().numpy()
    tt_on = (norm.pod_untol != 0).tolist()
    na_on = (norm.pod_weights > 0).any(1).tolist()
    placed_at = [int(a) for a in assignments.tolist()]
    gang_ids = gang.gang_id.tolist() if gang is not None else [0] * p_count
    gang_mins = gang.gang_min.tolist() if gang is not None else [0] * p_count
    req = requested.clone()
    carried_ext = ext_carried(ext) if ext is not None else []
    xled = {f: start.clone() for f, start, _add in carried_ext}
    ip = interpod
    if ip is not None:
        ledger = make_ledger(ip.podsel_count, ip.term_count, ip.topology,
                             ip.domain_universe)
        onehot = topology_onehot(ip.topology, ip.domain_universe)
        one = torch.ones((), dtype=torch.float32, device=masked_static.device)
    cache: dict = {}
    out = torch.zeros((p_count, 2), dtype=torch.float32, device=masked_static.device)
    gang_cur, placed, quorum, snap = 0, 0, 0, None
    for p in range(p_count):
        if gang_ids[p] != gang_cur:
            if gang_cur > 0 and placed < quorum:
                req, xled = snap[0], snap[2]
                if ip is not None:
                    restore_ledger(ledger, snap[1], True)
            if gang_ids[p] > 0:
                snap = (req.clone(), None if ip is None else ledger_snapshot(ledger),
                        {f: x.clone() for f, x in xled.items()})
                placed, quorum = 0, gang_mins[p]
            gang_cur = gang_ids[p]
        if exch[p]:
            key = rows[p].tobytes()
            if key not in cache:
                cache[key] = norm_counts(norm, p)
            tt, na = cache[key]
            feasible = (masked_static[p] > float("-inf")) & fits_resources_dyn(
                allocatable, requests[p:p + 1], req, dyn_gpu=ext is not None,
                dyn_storage=ext is not None)[0]
            if xled:
                feasible = feasible & ext_fits(ext, xled, p)
            if ip is not None and ip.use_ipa:
                pod = SimpleNamespace(**{f: getattr(ip, f)[p] for f in POD_ROW_FIELDS})
                feasible = feasible & interpod_feasible(ip, pod, ledger, onehot)
            if tt_on[p] and norm.w_tt:
                out[p, 0] = torch.where(feasible, tt, 0.0).max()
            if na_on[p] and norm.w_na:
                out[p, 1] = torch.where(feasible, na, 0.0).max()
        if placed_at[p] >= 0:
            req[placed_at[p]] += requests[p]
            for f, _start, adds in carried_ext:
                xled[f][placed_at[p]] += adds[p]
            placed += gang_cur > 0
            if ip is not None:
                ledger_add(ledger, ip.pod_matches_q[p], placed_at[p], one,
                           ip.pod_carries_e[p], ip.topology)
    maxima = out.cpu().to(torch.int64).tolist()
    return [norm_pack(*m) if x else None for m, x in zip(maxima, exch)]


def norm_table_misses(norm: NormInputs, maxima: list,
                      entries: int = NORM_TABLE) -> list:
    """Per pod, whether the kernel's guess missed (True: a second round),
    None where the pod exchanges no maxima: the table replayed over the
    pods' rows and their true maxima (`norm_true_maxima`)."""
    table = NormMaximaTable(entries)
    rows = norm_pod_rows(norm).cpu().numpy()
    return [None if word is None else table.step(norm_row_key(row), word)
            for row, word in zip(rows, maxima)]


def _launch(symbol, argtypes, masked_static, requests, nonzero_requests,
            allocatable, requested, nonzero, rr_start, w_lr, w_ba, extra=(),
            norm: NormInputs | None = None):
    """Launch one build on the current stream: the ledgers are cloned (the
    kernel updates them in place), `extra` (pointers and scalars after
    the main operands) is passed through, then the flag's operands. Returns
    the ScanResult fields and raises if the launch fails."""
    from kubernetes_tpu_torch.native.build import load

    p, n = masked_static.shape
    run = node_run(n)
    dev = masked_static.device
    fn = getattr(load("assign_scan"), symbol)
    fn.argtypes = argtypes[:-1] + _NORM_ARGTYPES + argtypes[-1:]
    fn.restype = ctypes.c_int
    _held, norm_args = _norm_operands(norm)
    req = requested.clone()
    nz = nonzero.clone()
    rr = _rr_tensor(rr_start, dev).reshape(1).clone()
    assignments = torch.empty((p,), dtype=torch.int32, device=dev)
    scores = torch.empty((p,), dtype=torch.float32, device=dev)
    counts = torch.empty((p,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(masked_static.data_ptr(), requests.data_ptr(),
                 nonzero_requests.data_ptr(), allocatable.data_ptr(),
                 req.data_ptr(), nz.data_ptr(), assignments.data_ptr(),
                 scores.data_ptr(), counts.data_ptr(), rr.data_ptr(),
                 p, n, run, float(w_lr), float(w_ba), *extra, *norm_args, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error {err}")
    return assignments, scores, counts, req, nz, rr.reshape(())


def assign_scan(masked_static, requests, nonzero_requests, allocatable,
                requested, nonzero, rr_start, w_lr: float = 1.0,
                w_ba: float = 1.0, norm: NormInputs | None = None) -> ScanResult:
    """Phase B over one batch.

    masked_static f32[P, N] (static score where statically feasible and the
    pod valid, else -inf), requests f32[P, R], nonzero_requests f32[P, 2],
    allocatable f32[N, R], and the batch-start ledger requested f32[N, R] /
    nonzero f32[N, 2] (not modified). rr_start is an int or an i64 scalar
    tensor. Requests in the gpu and storage columns must be zero (the solver
    hoists those compares into Phase A). `norm` (NormInputs, None = off)
    raises the normalization flag, which every build takes."""
    args = (masked_static, requests, nonzero_requests, allocatable,
            requested, nonzero)
    dev = _check_operands("assign_scan", *args)
    _check_norm(norm, *masked_static.shape, dev)
    if dev.type == "cpu":
        return assign_scan_plain(*args, rr_start, w_lr, w_ba, norm)
    out = _launch("ktpu_assign_scan", _ARGTYPES, *args, rr_start, w_lr, w_ba,
                  norm=norm)
    assign_scan.launches += 1
    assign_scan.norm_launches += norm is not None
    return ScanResult(*out)


assign_scan.launches = 0
assign_scan.norm_launches = 0   # of them, with the normalization flag

# the kernel's zone-sum slots (MAX_DOMAINS) and pod-slot match columns
# (MAX_UQ)
MAX_DOMAINS = 64
MAX_UQ = 64
_SPREAD_ARGTYPES = (_ARGTYPES[:-1] + [ctypes.c_void_p] * 4
                    + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])


def _check_spread(spread: SpreadInputs, p: int, n: int, dev) -> int:
    """Check the SpreadInputs tensors of a p-pod, n-node batch; returns UQ."""
    uq = spread.podsel_count.shape[1]
    for check in (("spread_q", spread.spread_q, torch.int32, (p,)),
                  ("pod_matches_q", spread.pod_matches_q, torch.float32, (p, uq)),
                  ("podsel_count", spread.podsel_count, torch.float32, (n, uq)),
                  ("topology", spread.topology, torch.int32,
                   (n, spread.topology.shape[1]))):
        check_tensor(*check, dev)
    return uq


def _spread_limits(name: str, spread: SpreadInputs, uq: int) -> None:
    """Raise unless the spread half fits the kernel's slots."""
    if uq > MAX_UQ or spread.domain_universe > MAX_DOMAINS:
        raise ValueError(
            f"{name}: {uq} pod selectors (at most {MAX_UQ}) and "
            f"{spread.domain_universe} zone domains (at most {MAX_DOMAINS})")
    if not 0 <= spread.zones <= spread.domain_universe:
        raise ValueError(f"{name}: {spread.zones} zones in use, "
                         f"universe {spread.domain_universe}")


def assign_scan_spread(masked_static, requests, nonzero_requests, allocatable,
                       requested, nonzero, rr_start, w_lr: float,
                       w_ba: float, spread: SpreadInputs,
                       norm: NormInputs | None = None) -> ScanResult:
    """Phase B with SelectorSpread (`assign_scan_spread_plain`): the
    operands of `assign_scan`, and `spread` (SpreadInputs). On a card the
    wrapper hands the kernel a transposed [UQ, N] copy of the pod-selector
    ledger, which the kernel updates in place, and returns it as
    new_podsel [N, UQ]."""
    return _spread_scan(assign_scan_spread, (masked_static, requests,
                        nonzero_requests, allocatable, requested, nonzero),
                        rr_start, w_lr, w_ba, spread, None, norm)


def assign_scan_spread_gang(masked_static, requests, nonzero_requests,
                            allocatable, requested, nonzero, rr_start,
                            w_lr: float, w_ba: float, spread: SpreadInputs,
                            gang: GangInputs,
                            norm: NormInputs | None = None) -> ScanResult:
    """Phase B with SelectorSpread and the gang carry
    (`assign_scan_spread_gang_plain`): the operands of `assign_scan_spread`,
    and `gang` (GangInputs). On a card the wrapper also gives the kernel the
    gang build's undo log (`assign_scan_gang`); a reverted group's
    pod-selector counts are subtracted back in the kernel."""
    return _spread_scan(assign_scan_spread_gang, (masked_static, requests,
                        nonzero_requests, allocatable, requested, nonzero),
                        rr_start, w_lr, w_ba, spread, gang, norm)


def _spread_scan(wrapper, args, rr_start, w_lr, w_ba, spread: SpreadInputs,
                 gang: GangInputs | None, norm: NormInputs | None) -> ScanResult:
    """The spread build, with the gang carry when `gang` is given: checks,
    the plain version on the CPU, else one launch counted on `wrapper`."""
    name = wrapper.__name__
    dev = _check_operands(name, *args)
    p, n = args[0].shape
    uq = _check_spread(spread, p, n, dev)
    _check_gang(gang, p, dev)
    _check_norm(norm, p, n, dev)
    if dev.type == "cpu":
        return _scan_plain(*args, rr_start, w_lr, w_ba, spread, gang=gang, norm=norm)
    _spread_limits(name, spread, uq)
    podsel_t = spread.podsel_count.t().contiguous()
    zone = spread.topology[:, TOPO_SPREAD_ZONE].contiguous()
    _undo, gang_args = _gang_operands(gang, p, dev)
    out = _launch(f"ktpu_{name}", _with_gang(_SPREAD_ARGTYPES, gang), *args,
                  rr_start, w_lr, w_ba,
                  (podsel_t.data_ptr(), spread.spread_q.data_ptr(),
                   spread.pod_matches_q.data_ptr(), zone.data_ptr(), uq,
                   spread.zones, spread.domain_universe, float(spread.w_ss),
                   *gang_args), norm)
    wrapper.launches += 1
    wrapper.norm_launches += norm is not None
    return ScanResult(*out, podsel_t.t().contiguous())


assign_scan_spread.launches = 0
assign_scan_spread.norm_launches = 0   # of them, with the normalization flag
assign_scan_spread_gang.launches = 0
assign_scan_spread_gang.norm_launches = 0

# the interpod build's columns (IP_MAX_UQ, IP_MAX_UE), term slots per pod
# (IP_SLOTS), topology slots (IP_MAX_K) and domains of a slot (IP_MAX_D)
IP_MAX_UQ = IP_MAX_UE = 64
IP_SLOTS = 4
IP_MAX_K = 16
IP_MAX_D = 64
_INTERPOD_ARGTYPES = (_ARGTYPES[:-1] + [ctypes.c_void_p] * 7
                      + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                      + [ctypes.c_void_p])


def _pod_words(ip: InterpodInputs) -> torch.Tensor:
    """i32[P, 29 + UQ + UE]: the kernel's per-pod words (ipaff_fail, the
    required and preferred term slots padded to 4 with -1, ppref_w, the
    match and carried-term rows; floats as their bits)."""
    p = ip.paff_q.shape[0]

    def slots(a, fill):
        pad = IP_SLOTS - a.shape[1]
        a = a.to(torch.int32)
        if pad:
            a = torch.cat([a, torch.full((p, pad), fill, dtype=torch.int32,
                                         device=a.device)], 1)
        return a

    def bits(a):
        return a.contiguous().view(torch.int32)

    return torch.cat([
        ip.ipaff_fail.to(torch.int32)[:, None],
        slots(ip.paff_q, -1), slots(ip.paff_tkey, 0),
        slots(ip.panti_q, -1), slots(ip.panti_tkey, 0),
        slots(ip.ppref_q, -1), slots(ip.ppref_tkey, 0),
        slots(bits(ip.ppref_w), 0),
        bits(ip.pod_matches_q), bits(ip.pod_carries_e)], 1).contiguous()


def assign_scan_interpod(masked_static, requests, nonzero_requests,
                         allocatable, requested, nonzero, rr_start,
                         w_lr: float, w_ba: float,
                         interpod: InterpodInputs,
                         norm: NormInputs | None = None) -> ScanResult:
    """Phase B with inter-pod (anti-)affinity (`assign_scan_interpod_plain`):
    the operands of `assign_scan`, and `interpod` (InterpodInputs). On a
    card the wrapper hands the kernel a transposed [UQ + UE, N] copy of the
    node-level ledgers, which the kernel updates in place and the wrapper
    returns as new_podsel [N, UQ] and new_term [N, UE], the batch-start
    domain aggregates, and room for one replica of them per block, which
    each block fills, updates and drops."""
    return _interpod_scan(assign_scan_interpod, (masked_static, requests,
                          nonzero_requests, allocatable, requested, nonzero),
                          rr_start, w_lr, w_ba, None, interpod, None, norm)


def assign_scan_interpod_gang(masked_static, requests, nonzero_requests,
                              allocatable, requested, nonzero, rr_start,
                              w_lr: float, w_ba: float,
                              interpod: InterpodInputs, gang: GangInputs,
                              norm: NormInputs | None = None) -> ScanResult:
    """Phase B with inter-pod (anti-)affinity and the gang carry
    (`assign_scan_interpod_gang_plain`): the operands of
    `assign_scan_interpod`, and `gang` (GangInputs), with the gang build's
    undo log on a card."""
    return _interpod_scan(assign_scan_interpod_gang, (masked_static, requests,
                          nonzero_requests, allocatable, requested, nonzero),
                          rr_start, w_lr, w_ba, None, interpod, gang, norm)


assign_scan_interpod.launches = 0
assign_scan_interpod.norm_launches = 0   # of them, with the normalization flag
assign_scan_interpod_gang.launches = 0
assign_scan_interpod_gang.norm_launches = 0


def _check_interpod(ip: InterpodInputs, p: int, n: int, dev) -> None:
    """Check the InterpodInputs tensors of a p-pod, n-node batch."""
    uq, ue = ip.podsel_count.shape[1], ip.term_count.shape[1]
    ia, ipp = ip.paff_q.shape[1], ip.ppref_q.shape[1]
    k = ip.topology.shape[1]
    i32, f32 = torch.int32, torch.float32
    for check in (("pod_matches_q", ip.pod_matches_q, f32, (p, uq)),
                  ("pod_carries_e", ip.pod_carries_e, f32, (p, ue)),
                  ("paff_q", ip.paff_q, i32, (p, ia)),
                  ("paff_tkey", ip.paff_tkey, i32, (p, ia)),
                  ("panti_q", ip.panti_q, i32, (p, ia)),
                  ("panti_tkey", ip.panti_tkey, i32, (p, ia)),
                  ("ppref_q", ip.ppref_q, i32, (p, ipp)),
                  ("ppref_tkey", ip.ppref_tkey, i32, (p, ipp)),
                  ("ppref_w", ip.ppref_w, f32, (p, ipp)),
                  ("ipaff_fail", ip.ipaff_fail, torch.bool, (p,)),
                  ("podsel_count", ip.podsel_count, f32, (n, uq)),
                  ("term_count", ip.term_count, f32, (n, ue)),
                  ("topology", ip.topology, i32, (n, k)),
                  ("term_q", ip.term_q, i32, (ue,)),
                  ("term_tkey", ip.term_tkey, i32, (ue,)),
                  ("term_kind", ip.term_kind, i32, (ue,)),
                  ("term_weight", ip.term_weight, f32, (ue,)),
                  ("term_poison", ip.term_poison, torch.bool, (ue,))):
        check_tensor(*check, dev)


def _interpod_limits(name: str, ip: InterpodInputs) -> None:
    """Raise unless the interpod half fits the kernel's slots."""
    uq, ue = ip.podsel_count.shape[1], ip.term_count.shape[1]
    ia, ipp = ip.paff_q.shape[1], ip.ppref_q.shape[1]
    k = ip.topology.shape[1]
    if (uq > IP_MAX_UQ or ue > IP_MAX_UE or ia > IP_SLOTS or ipp > IP_SLOTS
            or not 5 <= k <= IP_MAX_K
            or not 1 <= ip.domain_universe <= IP_MAX_D):
        raise ValueError(
            f"{name}: {uq} pod selectors, {ue} carried terms "
            f"(at most {IP_MAX_UQ} each), {ia} and {ipp} term slots (at most "
            f"{IP_SLOTS}), {k} topology slots (5 to {IP_MAX_K}) and "
            f"{ip.domain_universe} domains (1 to {IP_MAX_D})")


def _interpod_operands(ip: InterpodInputs):
    """The interpod half's device operands: (the transposed [UQ + UE, N]
    node-level ledger the kernel updates in place, the other tensors the
    pointers point into, which the caller holds until the launch is
    enqueued, and the launch's pointers and scalars after the main
    operands: the ledger, the batch-start domain aggregates, room for a
    replica a block, the totals, the per-pod words, the topology, the term
    attributes, then UQ, UE, K, the domain universe, use_ipa, w_ip and
    hard_w)."""
    i32 = torch.int32
    uq, ue = ip.podsel_count.shape[1], ip.term_count.shape[1]
    counts = torch.cat([ip.podsel_count, ip.term_count], 1)
    node_t = counts.t().contiguous()
    dom0 = domain_aggregates(ip.topology, counts, ip.domain_universe).contiguous()
    dom = torch.empty((CLUSTER, *dom0.shape), dtype=torch.float32,
                      device=counts.device)
    totals = counts.sum(0)
    words = _pod_words(ip)
    attrs = torch.stack([ip.term_q, ip.term_tkey, ip.term_kind,
                         ip.term_weight.contiguous().view(i32),
                         ip.term_poison.to(i32)]).contiguous()
    topology = ip.topology.contiguous()
    return node_t, (dom0, dom, totals, words, attrs, topology), (
        node_t.data_ptr(), dom0.data_ptr(), dom.data_ptr(), totals.data_ptr(),
        words.data_ptr(), topology.data_ptr(), attrs.data_ptr(),
        uq, ue, ip.topology.shape[1], ip.domain_universe,
        int(bool(ip.use_ipa)), float(ip.w_ip), float(ip.hard_w))


_SPREAD_INTERPOD_ARGTYPES = (_INTERPOD_ARGTYPES[:-1] + [ctypes.c_void_p] * 2
                             + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a is b or (a.shape == b.shape and bool(torch.equal(a, b)))


def assign_scan_spread_interpod(masked_static, requests, nonzero_requests,
                                allocatable, requested, nonzero, rr_start,
                                w_lr: float, w_ba: float,
                                spread: SpreadInputs,
                                interpod: InterpodInputs,
                                norm: NormInputs | None = None) -> ScanResult:
    """Phase B with inter-pod (anti-)affinity and SelectorSpread over one
    ledger (`assign_scan_spread_interpod_plain`): the operands of
    `assign_scan`, `spread` (SpreadInputs) and `interpod` (InterpodInputs),
    which carry the same pod-selector ledger, topology, match rows and
    domain universe. On a card the wrapper hands the kernel the interpod
    build's operands, whose transposed [UQ + UE, N] node-level ledger the
    SelectorSpread count columns are read from (its first UQ rows), and
    the spread build's entries and zone column; it returns new_podsel
    [N, UQ] and new_term [N, UE]. Limits: those of both builds."""
    return _interpod_scan(assign_scan_spread_interpod, (masked_static, requests,
                          nonzero_requests, allocatable, requested, nonzero),
                          rr_start, w_lr, w_ba, spread, interpod, None, norm)


def assign_scan_spread_interpod_gang(masked_static, requests, nonzero_requests,
                                     allocatable, requested, nonzero, rr_start,
                                     w_lr: float, w_ba: float,
                                     spread: SpreadInputs,
                                     interpod: InterpodInputs, gang: GangInputs,
                                     norm: NormInputs | None = None) -> ScanResult:
    """Phase B with inter-pod (anti-)affinity, SelectorSpread and the gang
    carry (`assign_scan_spread_interpod_gang_plain`): the operands of
    `assign_scan_spread_interpod`, and `gang` (GangInputs), with the gang
    build's undo log on a card."""
    return _interpod_scan(assign_scan_spread_interpod_gang, (masked_static,
                          requests, nonzero_requests, allocatable, requested,
                          nonzero), rr_start, w_lr, w_ba, spread, interpod,
                          gang, norm)


def _interpod_scan(wrapper, args, rr_start, w_lr, w_ba,
                   spread: SpreadInputs | None, interpod: InterpodInputs,
                   gang: GangInputs | None, norm: NormInputs | None) -> ScanResult:
    """The interpod build, or with `spread` the spread+interpod build, with
    the gang carry when `gang` is given: checks, the plain version on the
    CPU, else one launch counted on `wrapper`."""
    name = wrapper.__name__
    dev = _check_operands(name, *args)
    p, n = args[0].shape
    uq = None if spread is None else _check_spread(spread, p, n, dev)
    _check_interpod(interpod, p, n, dev)
    _check_gang(gang, p, dev)
    _check_norm(norm, p, n, dev)
    if spread is not None and (
            spread.domain_universe != interpod.domain_universe or not all(
                _same(getattr(spread, f), getattr(interpod, f))
                for f in ("podsel_count", "topology", "pod_matches_q"))):
        raise ValueError(f"{name}: spread and interpod carry different "
                         f"ledgers, topology, match rows or universes")
    if dev.type == "cpu":
        return _scan_plain(*args, rr_start, w_lr, w_ba, spread, interpod, gang, norm)
    if spread is not None:
        _spread_limits(name, spread, uq)
    _interpod_limits(name, interpod)
    node_t, _held, extra = _interpod_operands(interpod)
    argtypes = _INTERPOD_ARGTYPES
    if spread is not None:
        argtypes = _SPREAD_INTERPOD_ARGTYPES
        zone = spread.topology[:, TOPO_SPREAD_ZONE].contiguous()
        extra = (*extra, spread.spread_q.data_ptr(), zone.data_ptr(),
                 spread.zones, float(spread.w_ss))
    _undo, gang_args = _gang_operands(gang, p, dev)
    out = _launch(f"ktpu_{name}", _with_gang(argtypes, gang), *args, rr_start,
                  w_lr, w_ba, (*extra, *gang_args), norm)
    wrapper.launches += 1
    wrapper.norm_launches += norm is not None
    uq = interpod.podsel_count.shape[1]
    return ScanResult(*out, node_t[:uq].t().contiguous(),
                      node_t[uq:].t().contiguous())


assign_scan_spread_interpod.launches = 0
assign_scan_spread_interpod.norm_launches = 0   # of them, with the normalization flag
assign_scan_spread_interpod_gang.launches = 0
assign_scan_spread_interpod_gang.norm_launches = 0


def _check_gang(gang: GangInputs | None, p: int, dev) -> None:
    """Check the GangInputs tensors of a p-pod batch."""
    if gang is None:
        return
    for check in (("gang_id", gang.gang_id, torch.int32, (p,)),
                  ("gang_min", gang.gang_min, torch.int32, (p,))):
        check_tensor(*check, dev)


def _gang_operands(gang: GangInputs | None, p: int, dev, words: int = 3):
    """The gang carry's device operands: (the undo log, [CLUSTER, P, words]
    float4s, which the caller holds until the launch is enqueued, and the
    launch's pointers: gang_id, gang_min, the log); none without `gang`."""
    if gang is None:
        return None, ()
    undo = torch.empty((CLUSTER, p, words, 4), dtype=torch.float32, device=dev)
    return undo, (gang.gang_id.data_ptr(), gang.gang_min.data_ptr(), undo.data_ptr())


def _with_gang(argtypes: list, gang: GangInputs | None) -> list:
    """A build's argtypes, with the gang operands before the stream."""
    return argtypes if gang is None else argtypes[:-1] + [ctypes.c_void_p] * 4


_GANG_ARGTYPES = _ARGTYPES[:-1] + [ctypes.c_void_p] * 3 + [ctypes.c_void_p]


def assign_scan_gang(masked_static, requests, nonzero_requests, allocatable,
                     requested, nonzero, rr_start, w_lr: float, w_ba: float,
                     gang: GangInputs, norm: NormInputs | None = None) -> ScanResult:
    """Phase B with the gang carry (`assign_scan_gang_plain`): the operands
    of `assign_scan`, and `gang` (GangInputs). On a card the wrapper gives
    the kernel an undo log of 48 bytes a pod for each block of the cluster,
    where the owner of a node a group member takes keeps the node's old
    ledger row until the group settles."""
    args = (masked_static, requests, nonzero_requests, allocatable,
            requested, nonzero)
    dev = _check_operands("assign_scan_gang", *args)
    p = masked_static.shape[0]
    _check_gang(gang, p, dev)
    _check_norm(norm, p, masked_static.shape[1], dev)
    if dev.type == "cpu":
        return assign_scan_gang_plain(*args, rr_start, w_lr, w_ba, gang, norm)
    _undo, gang_args = _gang_operands(gang, p, dev)
    out = _launch("ktpu_assign_scan_gang", _GANG_ARGTYPES, *args, rr_start,
                  w_lr, w_ba, gang_args, norm)
    assign_scan_gang.launches += 1
    assign_scan_gang.norm_launches += norm is not None
    return ScanResult(*out)


assign_scan_gang.launches = 0
assign_scan_gang.norm_launches = 0   # of them, with the normalization flag

# the EXT variant's universes (host ports, conflict and attach atoms): one
# 64-bit word a node and a pod each; and its (VolType, limit) pairs
EXT_MAX_UP = NORM_MAX_U
EXT_MAX_ATTACH_LIMITS = 3
# the gang build's undo entry with EXT, in float4s: the node's old port and
# volume words beside the gang build's three
EXT_UNDO_WORDS = 5
# a pod's volume flags (the kernel's EXT_FAIL, EXT_DISK, EXT_ATT, EXT_SAME)
EXT_FAIL, EXT_DISK, EXT_ATT, EXT_SAME = 1, 2, 4, 8


def _check_ext(name: str, ext: ExtInputs, p: int, n: int, dev) -> None:
    """Check the ExtInputs tensors of a p-pod, n-node batch; ValueError
    past EXT_MAX_UP host ports, conflict atoms or attach atoms (on every
    device: the kernel's words hold 64) or EXT_MAX_ATTACH_LIMITS pairs."""
    f32 = torch.float32
    checks = [("host ports", "port_onehot", "port_count")]
    if ext.use_nodisk:
        checks += [("conflict atoms", "vol_want_rw", "vol_any"),
                   ("conflict atoms", "vol_want_ro", "vol_rw")]
    if ext.attach_maxes:
        checks += [("attach atoms", "att_onehot", "attach_count")]
        ua = ext.attach_count.shape[1]
        check_tensor("att_fail", ext.att_fail, torch.bool, (p,), dev)
        check_tensor("attach_type", ext.attach_type, torch.int32, (ua,), dev)
        if len(ext.attach_maxes) > EXT_MAX_ATTACH_LIMITS:
            raise ValueError(f"{name}: {len(ext.attach_maxes)} attach limits, at "
                             f"most {EXT_MAX_ATTACH_LIMITS}")
    for what, pod_rows, counts in checks:
        u = getattr(ext, counts).shape[1]
        check_tensor(pod_rows, getattr(ext, pod_rows), f32, (p, u), dev)
        check_tensor(counts, getattr(ext, counts), f32, (n, u), dev)
        if u > EXT_MAX_UP:
            raise ValueError(f"{name}: {u} {what} in the universe, at most "
                             f"{EXT_MAX_UP}")


def _ext_words(ext: ExtInputs):
    """The EXT variant's device words: i64[N + 1, 4], row 0 MaxPDVolumeCount's
    table (the limits' type masks, bit u: atom u is of the type or ANY, then
    their limits, 16 bits each, and their count in bits 48-49), row g + 1
    node g's conflict atoms in use, in use read-write, attach atoms present
    and host ports in use (bit u: the count is not 0), a copy the kernel
    updates in place; and i64[P, 6], a pod's host ports, 0, the atoms it
    mounts read-write and read-only, its attach atoms and its flags: the
    attach fail bit EXT_FAIL, EXT_DISK and EXT_ATT where it has those words,
    EXT_SAME where its words and fail bit equal the previous pod's. Zeros
    where the predicate does not run."""
    dev = ext.port_count.device
    n, p = ext.port_count.shape[0], ext.port_onehot.shape[0]
    node = torch.zeros((n + 1, 4), dtype=torch.int64, device=dev)
    pod = torch.zeros((p, 6), dtype=torch.int64, device=dev)
    if ext.use_ports:
        node[1:, 3] = pack_words(ext.port_count)
        pod[:, 0] = pack_words(ext.port_onehot)
    if ext.use_nodisk:
        node[1:, 0] = pack_words(ext.vol_any)
        node[1:, 1] = pack_words(ext.vol_rw)
        pod[:, 2] = pack_words(ext.vol_want_rw)
        pod[:, 3] = pack_words(ext.vol_want_ro)
    if ext.attach_maxes:
        node[1:, 2] = pack_words(ext.attach_count)
        pod[:, 4] = pack_words(ext.att_onehot)
        pod[:, 5] = ext.att_fail.to(torch.int64) * EXT_FAIL
        types = ext.attach_type.to(torch.int64)
        limits = len(ext.attach_maxes) << 48
        for k, (vtype, limit) in enumerate(ext.attach_maxes):
            mask = ((types == vtype) | (types == VolType.ANY)).to(torch.float32)
            node[0, k] = pack_words(mask[None])[0]
            limits |= min(int(limit), 0xFFFF) << (16 * k)
        node[0, 3] = limits
    vol = pod[:, 2:5]
    pod[:, 5] |= ((vol[:, 0] | vol[:, 1]) != 0).to(torch.int64) * EXT_DISK
    pod[:, 5] |= (vol[:, 2] != 0).to(torch.int64) * EXT_ATT
    same = torch.zeros_like(pod[:, 5])
    same[1:] = (pod[1:, 2:] == pod[:-1, 2:]).all(1).to(torch.int64) * EXT_SAME
    pod[:, 5] |= same
    return node.contiguous(), pod.contiguous()


def ext_ledgers(ext: ExtInputs, assignments: torch.Tensor,
                gang: GangInputs | None = None) -> dict:
    """The EXT variant's carried ledgers after the batch, by ScanResult
    field (`ext_carried`): the batch-start counts plus the rows of the
    pods placed, members of a group below its quorum left out. The counts
    are integers below 2^24, so each sum is the plain scan's carried (and,
    for a reverted group, restored) ledger exactly."""
    carried = ext_carried(ext)
    if not carried:
        return {}
    ok = assignments >= 0
    if gang is not None:
        _first, seg = group_runs(gang.gang_id)
        placed = torch.zeros(ok.shape, dtype=torch.int64, device=ok.device)
        placed.index_add_(0, seg, ok.to(torch.int64))
        ok = ok & ~((gang.gang_id > 0) & (placed[seg] < gang.gang_min))
    rows = torch.where(ok, assignments, 0).to(torch.int64)
    keep = ok[:, None].to(torch.float32)
    return {f: start.index_add(0, rows, add * keep) for f, start, add in carried}


def ext_port_count(ext: ExtInputs, assignments: torch.Tensor,
                   gang: GangInputs | None = None) -> torch.Tensor | None:
    """The host-port counts after the batch (`ext_ledgers`), None without
    use_ports."""
    return ext_ledgers(ext, assignments, gang).get("new_port_count")


def assign_scan_ext(masked_static, requests, nonzero_requests, allocatable,
                    requested, nonzero, rr_start, w_lr: float, w_ba: float,
                    ext: ExtInputs, norm: NormInputs | None = None) -> ScanResult:
    """Phase B with the EXT variant (`assign_scan_ext_plain`): the operands
    of `assign_scan` (the gpu and storage columns of the requests may be
    nonzero), and `ext` (ExtInputs). On a card the wrapper hands the kernel
    a node's host ports, conflict atoms (in use, in use read-write) and
    attach atoms as 64-bit words (a set bit: the count is not 0), which the
    kernel ORs each placed pod's words into, each pod's words and flags,
    and the attach limits' type masks (`_ext_words`); `new_port_count`, `new_vol_any`,
    `new_vol_rw` and `new_attach` are summed after the launch from the
    assignments (`ext_ledgers`)."""
    return _ext_scan(assign_scan_ext, (masked_static, requests, nonzero_requests,
                     allocatable, requested, nonzero), rr_start, w_lr, w_ba,
                     ext, None, norm)


def assign_scan_gang_ext(masked_static, requests, nonzero_requests,
                         allocatable, requested, nonzero, rr_start,
                         w_lr: float, w_ba: float, ext: ExtInputs,
                         gang: GangInputs,
                         norm: NormInputs | None = None) -> ScanResult:
    """Phase B with the gang carry and the EXT variant
    (`assign_scan_gang_ext_plain`): the operands of `assign_scan_ext`, and
    `gang` (GangInputs), with the gang build's undo log on a card, whose
    entries also keep a node's old port and volume words."""
    return _ext_scan(assign_scan_gang_ext, (masked_static, requests,
                     nonzero_requests, allocatable, requested, nonzero),
                     rr_start, w_lr, w_ba, ext, gang, norm)


def _ext_scan(wrapper, args, rr_start, w_lr, w_ba, ext: ExtInputs,
              gang: GangInputs | None, norm: NormInputs | None) -> ScanResult:
    """The main or (with `gang`) gang build with the EXT variant: checks,
    the plain version on the CPU, else one launch counted on `wrapper`."""
    name = wrapper.__name__
    dev = _check_operands(name, *args)
    p, n = args[0].shape
    _check_ext(name, ext, p, n, dev)
    _check_gang(gang, p, dev)
    _check_norm(norm, p, n, dev)
    if dev.type == "cpu":
        return _scan_plain(*args, rr_start, w_lr, w_ba, None, gang=gang,
                           norm=norm, ext=ext)
    node_words, pod_words = _ext_words(ext)
    _undo, gang_args = _gang_operands(gang, p, dev, EXT_UNDO_WORDS)
    argtypes = _ARGTYPES if gang is None else _GANG_ARGTYPES
    out = _launch(f"ktpu_{name}", argtypes[:-1] + [ctypes.c_void_p] * 3, *args,
                  rr_start, w_lr, w_ba,
                  (*gang_args, node_words.data_ptr(), pod_words.data_ptr()), norm)
    wrapper.launches += 1
    wrapper.norm_launches += norm is not None
    return ScanResult(*out, **ext_ledgers(ext, out[0], gang))


assign_scan_ext.launches = 0
assign_scan_ext.norm_launches = 0   # of them, with the normalization flag
assign_scan_gang_ext.launches = 0
assign_scan_gang_ext.norm_launches = 0
