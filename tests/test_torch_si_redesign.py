"""Numpy models of the spread+interpod build's per-pod chain in
csrc/assign_scan.cu (the build that runs a batch needing both
SelectorSpread and inter-pod (anti-)affinity), held against the reference
package on the CPU:

- the SelectorSpread zone sums: up to 4 zones in use, two zones a 32-bit
  word in the warp while the warp's max count times its nodes stays below
  2^16 (zone by zone past it), the warps' sums added into the block's
  words by shared atomics, one reduction a zone in the cluster (lane b
  reads block b), and the node and zone parts of SelectorSpread taken once
  a lane (count x in lane x, zone d in lane d) and read with a shuffle;
  past 4 zones, one reduction a zone in the warp and serial sums; against
  JAX `selector_spread`;
- the packed fields' bound, and that it is tight;
- the combined message: the spread partial's chunks and the (min, max)
  chunk, which also carries the normalization flag's maxima, each
  received once, and the mbarrier armed for the bytes sent;
- the count loop: the block's domain ids as bytes, its replica of
  topology slots 1..k-1, the entries outside the run's nodes; against JAX
  `interpod_feasible` and `interpod_counts`.

Every comparison is exact."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

from kubernetes_tpu.ops import interpod as jinterpod
from kubernetes_tpu.ops import spread as jspread
from tests.test_torch_interpod import (
    CASES,
    D,
    K,
    ROLE_AFF,
    ROLE_ANTI,
    ROLE_CARRIED_ANTI,
    ROLE_SCORE,
    UQ,
    _bits,
    _kernel_list,
    _ops_inputs,
)

F32 = np.float32
CLUSTER, WARP = 16, 32
FAST_ZONES = 4               # SI_FAST_ZONES
FIELD = 1 << 16              # SI_FIELD
U32 = (1 << 32) - 1
UNIVERSE = 64                # the spread zones' domain universe
TOPO_SPREAD_ZONE = 4
ZONE_COUNTS = [0, 1, 3, 4, 31, 32, 33, 63, 64]


# ---- (a) the SelectorSpread zone sums ----

def _warp_packed(c, d, fe, zones):
    """One warp's packed reduction (threads of `c`, `d`, `fe` [32, RUN]):
    each thread's two words (zones 0-1 and 2-3, zone 2k + i in bits 16 i),
    summed over the lanes as the u32 redux.sync does, and whether the
    fields are taken: the warp's max feasible count times its 32 RUN
    nodes below 2^16, so no field reaches 2^16. Returns (taken, [zone
    sums] from the fields)."""
    summed = fe & (d >= 0) & (d < zones)
    pk = [0, 0]
    for lane in range(WARP):
        for j in range(c.shape[1]):
            if not summed[lane, j]:
                continue
            v, z = int(c[lane, j]), int(d[lane, j])
            pk[z >> 1] = (pk[z >> 1] + ((v << (16 * (z & 1))) & U32)) & U32
    wmax = int(c[fe].max(initial=0))
    fields = [pk[0] & (FIELD - 1), pk[0] >> 16, pk[1] & (FIELD - 1), pk[1] >> 16]
    return wmax * WARP * c.shape[1] < FIELD, fields


def _si_spread_model(zone, counts, feasible, zones, run, threads, rng):
    """f32[N] SelectorSpread of one pod as the spread+interpod build takes
    it, with `threads` a block and `run` nodes a thread; also returns how
    many warps took the packed fields and how many fell back."""
    n = zone.shape[0]
    nb = threads * run
    assert n <= CLUSTER * nb
    c = counts.astype(np.int64)
    assert np.array_equal(c, counts), "counts are integers"
    pad = CLUSTER * nb - n
    zone_p = np.r_[zone, np.full(pad, -1)].astype(np.int64)
    c_p = np.r_[c, np.zeros(pad, np.int64)]
    fe_p = np.r_[feasible, np.zeros(pad, bool)]
    fast = zones <= FAST_ZONES
    words = FAST_ZONES if fast else zones
    packed = fallback = 0
    blocks = []
    for b in range(CLUSTER):
        warp_parts = []
        for w in range(threads // WARP):
            lo = b * nb + w * WARP * run
            sl = slice(lo, lo + WARP * run)
            cw = c_p[sl].reshape(WARP, run)
            dw = zone_p[sl].reshape(WARP, run)
            fw = fe_p[sl].reshape(WARP, run)
            part = np.zeros(2 + words, np.int64)   # max, zoned, zone sums
            part[0] = cw[fw].max(initial=0)
            part[1] = bool((fw & (dw >= 0)).any())
            taken, fields = _warp_packed(cw, dw, fw, zones) if fast else (False, None)
            if taken:
                part[2:] = fields
                packed += 1
            else:   # one reduction a zone present in the warp
                fallback += int(fast)
                for d in rng.permutation(np.unique(dw[(dw >= 0) & (dw < zones)])):
                    part[2 + d] = cw[fw & (dw == d)].sum()
            warp_parts.append(part)
        # the block: the warps' words added by shared atomics (any order)
        order = rng.permutation(len(warp_parts))
        stacked = np.stack([warp_parts[i] for i in order])
        blocks.append(np.r_[stacked[:, 0].max(), stacked[:, 1].max(),
                            stacked[:, 2:].sum(0)])
    # every warp: lane b reads block b, one reduction a zone in use
    stacked = np.stack([blocks[i] for i in rng.permutation(CLUSTER)])
    max_c, any_z = stacked[:, 0].max(), stacked[:, 1].max()
    zs = stacked[:, 2:].sum(0)
    zs[zones:] = 0                  # words past the zones in use are not read
    f32 = np.float32
    max_node = f32(max_c)
    max_zone = f32(zs.max(initial=0))

    def part_of(m, x):        # spread_part, the double reciprocal of max(m, 1)
        if not m > 0:
            return f32(10.0)
        num = f32(10.0) * (m - x)
        return f32(np.float64(num) * (1.0 / np.float64(max(m, f32(1.0)))))

    # the parts once a lane where the zones ride packed fields: count x's
    # node part in lane x, zone d's part in lane d, no summed zone's in the
    # others; a node reads them with a shuffle, else takes them itself
    node_tab = [part_of(max_node, f32(x)) for x in range(WARP)]
    zone_tab = [part_of(max_zone, f32(zs[z] if z < zones else 0)) for z in range(WARP)]
    out = np.zeros(n, np.float32)
    for g in range(n):
        d = int(zone[g])
        zc = zs[d] if 0 <= d < zones else 0
        x = int(counts[g])
        if fast and 0 <= x < WARP and f32(x) == counts[g]:
            node_s = node_tab[x]
        else:
            node_s = part_of(max_node, f32(counts[g]))
        if fast:
            zone_s = zone_tab[d if 0 <= d < zones else FAST_ZONES]
        else:
            zone_s = part_of(max_zone, f32(zc))
        blended = (node_s * f32(1.0 - 2.0 / 3.0) + f32(2.0 / 3.0) * zone_s
                   if any_z and d >= 0 else node_s)
        out[g] = np.trunc(blended + f32(1e-6))
    return out, packed, fallback


def _spread_inputs(rng, n, zones, scale):
    """Zone ids (a fifth -1, a tenth past the universe, the rest below
    `zones`), counts up to `scale`, and a feasible mask."""
    zone = rng.randint(0, zones, n) if zones else np.full(n, -1)
    zone[rng.rand(n) < 0.2] = -1
    beyond = rng.rand(n) < 0.1
    zone[beyond] = rng.randint(UNIVERSE, UNIVERSE + 8, int(beyond.sum()))
    counts = rng.randint(0, scale + 1, n).astype(np.float32)
    counts[rng.rand(n) < 0.3] = 0.0
    return zone.astype(np.int32), counts, rng.rand(n) < 0.7


def _jax_spread(zone, counts, feasible):
    topo = np.full((zone.shape[0], 8), -1, np.int32)
    topo[:, TOPO_SPREAD_ZONE] = zone
    return np.asarray(jspread.selector_spread(
        SimpleNamespace(topology=jnp.asarray(topo)), jnp.int32(0),
        jinterpod.AffinityLedger(podsel_count=jnp.asarray(counts[:, None]),
                                 total_q=jnp.asarray(counts.sum()[None])),
        jnp.asarray(feasible), UNIVERSE))


@pytest.mark.parametrize("zones", ZONE_COUNTS)
@pytest.mark.parametrize("scale", [110, 3000])
@pytest.mark.parametrize("run", [1, 8])
def test_si_zone_sums_model_matches_reference(zones, scale, run):
    """The zone sums and the score, in permuted orders at every level, equal
    JAX `selector_spread` for counts up to 110 (every warp packed) and up to
    3,000 (at 8 nodes a thread most warps' totals pass 2^16 and fall back
    zone by zone)."""
    rng = np.random.RandomState(1800 + 7 * zones + scale + run)
    n = 900 if run == 1 else 3000
    zone, counts, feasible = _spread_inputs(rng, n, zones, scale)
    got, packed, fallback = _si_spread_model(zone, counts, feasible, zones, run, 64, rng)
    np.testing.assert_array_equal(_bits(got), _bits(_jax_spread(zone, counts, feasible)))
    if 0 < zones <= FAST_ZONES:
        assert packed > 0
        if scale == 3000 and run == 8:
            assert fallback > 0


@pytest.mark.parametrize("zones", [1, 2, 3, 4])
@pytest.mark.parametrize("run", [1, 2, 8])
def test_si_zone_sums_at_the_packed_bound_match_reference(zones, run):
    """A warp whose nodes all sit in zone 0 with the largest max count the
    fields take, 2^16 / (32 RUN) - 1 (its zone-0 field 2^16 - 32 RUN), and
    one where a node holds one more (which falls back: a field could then
    reach 2^16 and carry into zone 1's)."""
    rng = np.random.RandomState(2000 + zones + 10 * run)
    threads = 64
    n = CLUSTER * threads * run
    zone = rng.randint(0, zones, n).astype(np.int32)
    counts = rng.randint(0, 3, n).astype(np.float32)
    feasible = np.ones(n, bool)
    top = FIELD // (WARP * run) - 1
    first = np.arange(0, WARP * run)
    second = first + WARP * run
    zone[first] = zone[second] = 0
    counts[first] = counts[second] = top
    counts[second[rng.randint(second.size)]] = top + 1
    got, packed, fallback = _si_spread_model(zone, counts, feasible, zones, run, threads, rng)
    np.testing.assert_array_equal(_bits(got), _bits(_jax_spread(zone, counts, feasible)))
    assert fallback == 1 and packed == CLUSTER * threads // WARP - 1


def test_si_packed_fields_are_exact_below_the_bound_only():
    """Each 16-bit field sums one zone's counts over at most the warp's 32
    RUN nodes, each no larger than the warp's max count: while max count
    times 32 RUN stays below 2^16 no field carries into the next (random
    warps of every zone mix and run); with every node of a warp at 2^16 /
    (32 RUN) in zone 0 the low field wraps to 0 and carries 1 into zone 1's,
    which is why the build then falls back."""
    rng = np.random.RandomState(2100)
    for _ in range(200):
        run = int(rng.choice([1, 2, 4, 8]))
        d = rng.randint(-1, FAST_ZONES, (WARP, run))
        fe = rng.rand(WARP, run) < 0.8
        summed = fe & (d >= 0)
        c = rng.randint(0, FIELD // (WARP * run), (WARP, run)).astype(np.int64)
        taken, fields = _warp_packed(c, d, fe, FAST_ZONES)
        assert taken
        want = [int(c[summed & (d == z)].sum()) for z in range(FAST_ZONES)]
        assert fields == want
    for run in (1, 2, 4, 8):
        c = np.full((WARP, run), FIELD // (WARP * run), np.int64)
        d = np.zeros((WARP, run), np.int64)
        taken, fields = _warp_packed(c, d, np.ones((WARP, run), bool), FAST_ZONES)
        assert not taken and fields[:2] == [0, 1]


# ---- (b) the combined message ----
#
# A pod that needs the SelectorSpread partial (spread_q >= 0: 1 + Z words
# in ceil((1 + Z) / 4) 16-byte chunks), the (min, max) of a weighted entry,
# or the flag's maxima (which ride the (min, max) chunk's free words) sends
# one message: warp 0's lane l sends chunks l // 16, l // 16 + 2, ... to
# block l % 16, the partial's chunks into slot `rank` of the partials and
# the last chunk into slot `rank` of the (min, max) slots; its lane 0 arms
# the block's mbarrier for 16 blocks' chunks of this pod.

@pytest.mark.parametrize("zones", ZONE_COUNTS)
@pytest.mark.parametrize("need", ["spread", "interpod", "both", "neither"])
@pytest.mark.parametrize("flag", [False, True])
def test_si_message_plan_sends_each_chunk_once(zones, need, flag):
    sp_on, ip_on = need in ("spread", "both"), need in ("interpod", "both")
    sp_chunks = (1 + zones + 3) // 4
    chunks = (sp_chunks if sp_on else 0) + (1 if ip_on or flag else 0)
    landed = {}
    for rank in range(CLUSTER):
        if not (sp_on or ip_on or flag):
            break   # every block reads the same pod row: none sends
        for lane in range(WARP):
            for k in range(lane // CLUSTER, chunks, WARP // CLUSTER):
                region = "partial" if sp_on and k < sp_chunks else "minmax"
                key = (lane % CLUSTER, region, rank, k if region == "partial" else 0)
                landed[key] = landed.get(key, 0) + 1
    armed = {b: CLUSTER * 16 * chunks for b in range(CLUSTER)}
    for b in range(CLUSTER):
        got = sum(16 * v for (dst, *_rest), v in landed.items() if dst == b)
        assert got == (armed[b] if chunks and (sp_on or ip_on or flag) else 0)
    assert all(v == 1 for v in landed.values())
    for b in range(CLUSTER):
        for rank in range(CLUSTER):
            for k in range(sp_chunks if sp_on else 0):
                assert landed[(b, "partial", rank, k)] == 1
            if ip_on or flag:
                assert landed[(b, "minmax", rank, 0)] == 1
    if sp_on and zones <= FAST_ZONES:
        # the cluster's reduction reads words 0..zones of each partial: all
        # in chunks that landed
        assert (zones + 1 + 3) // 4 <= sp_chunks


# ---- (c) the count loop ----

def _byte_ids(topo, nd):
    """The block's domain ids as bytes: an id in [0, nd) itself, 0xff for
    none, 0xfe for one at or past nd."""
    return np.where(topo < 0, 0xFF, np.where(topo < nd, topo, 0xFE)).astype(np.uint8)


def _si_count(node, rep, ids, u, tk, g):
    """si_count: column u at topology code tk for node g, from the
    node-level counts, the replica of slots 1..k-1 and the byte ids."""
    def at(k, b):
        return rep[k - 1, b, u] if b < D else F32(0)
    if tk == 0:
        return node[g, u]
    if 0 < tk < K:
        return at(tk, ids[g, tk])
    if tk == -2:   # TKEY_DEFAULT_UNION
        z, r = ids[g, 1], ids[g, 2]
        host = node[g, u] if z == 0xFF and r == 0xFF else F32(0)
        return F32(F32(F32(host + at(1, z)) + at(2, r)) - at(3, ids[g, 3]))
    return F32(0)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("seed", range(2))
def test_si_count_loop_model_matches_reference(case, seed):
    """The predicate and the counts from the entries outside the run's
    nodes (each node's entries still in list order), ids read as bytes and
    the replica indexed from slot 1, equal JAX `interpod_feasible` and
    `interpod_counts`, with ids past the universe in every slot (a node
    with a zone past it has a zone, for the default-domain union)."""
    rng = np.random.RandomState(2200 + seed)
    state, pod, podsel, term, feasible = _ops_inputs(rng, case)
    topo = state["topology"]
    n = topo.shape[0]
    for slot in range(1, K):
        past = rng.rand(n) < 0.1
        topo[past, slot] = rng.randint(D, D + 5, int(past.sum()))
    pod["pod_carries_e"] = np.zeros(term.shape[1], np.float32)
    js = SimpleNamespace(**{k: jnp.asarray(v) for k, v in state.items()})
    jp = SimpleNamespace(**{k: jnp.asarray(v) for k, v in pod.items()})
    jtopo = jnp.asarray(topo)
    jled = jinterpod.AffinityLedger(
        podsel_count=jnp.asarray(podsel), total_q=jnp.asarray(podsel.sum(0)),
        term_count=jnp.asarray(term),
        dom_podsel=jinterpod.domain_aggregates(jtopo, jnp.asarray(podsel), D),
        dom_term=jinterpod.domain_aggregates(jtopo, jnp.asarray(term), D),
        total_e=jnp.asarray(term.sum(0)))
    onehot = jinterpod.topology_onehot(jtopo, D)
    want_ok = np.asarray(jinterpod.interpod_feasible(js, jp, jled, onehot))
    want_c = np.asarray(jinterpod.interpod_counts(js, jp, jled, 1.0, onehot))
    # the kernel's state: node-level counts, the replica from slot 1, bytes
    node = np.concatenate([podsel, term], 1)
    replica = np.concatenate([np.asarray(jled.dom_podsel), np.asarray(jled.dom_term)], 2)
    rep = replica[1:]
    ids = _byte_ids(topo, D)
    totals = node.sum(0)
    entries, reject, _counting, _row_nz = _kernel_list(state, pod, totals)
    run = 2
    ok = np.zeros(n, bool)
    counts = np.zeros(n, np.float32)
    for t0 in range(0, n, run):   # a thread's run of nodes
        g_run = list(range(t0, min(t0 + run, n)))
        good = {g: not reject for g in g_run}
        cnt = {g: F32(0) for g in g_run}
        viol = {g: F32(0) for g in g_run}
        for u, tk, role, w in entries:   # entries outer
            for g in g_run:              # the run's nodes inner
                v = _si_count(node, rep, ids, u, tk, g)
                if role == ROLE_SCORE:
                    cnt[g] = F32(cnt[g] + F32(w * v))
                elif role == ROLE_CARRIED_ANTI:
                    viol[g] = F32(viol[g] + v)
                elif role == ROLE_ANTI:
                    good[g] = good[g] and v == 0
                else:
                    assert role == ROLE_AFF
                    good[g] = good[g] and v > 0
        for g in g_run:
            ok[g] = good[g] and viol[g] == 0
            counts[g] = cnt[g]
    np.testing.assert_array_equal(ok, want_ok)
    np.testing.assert_array_equal(_bits(counts), _bits(want_c))
    assert len(np.unique(want_c)) > 1 or not entries
    assert UQ == podsel.shape[1]

