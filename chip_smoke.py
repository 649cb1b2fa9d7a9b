#!/usr/bin/env python3
"""Chip smoke test: kubernetes_tpu_torch's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc. It
prints one JSON line per phase and fails (non-zero exit) if any phase
fails; nothing is caught and skipped:

0. device: the card's name and power limit (nvidia-smi) and the versions;
1. build: compiles every kernel (one nvcc per source, in parallel);
2. static_mask at the headline shape (P=4096 pods, N=16384 nodes, 128
   selector terms, 64 taints) on seeded inputs with selectors, hard taints,
   every condition bit, invalid rows and nodeName pins: the kernel must
   equal its plain PyTorch version exactly; times the kernel, the plain
   version and the two torch.matmul products alone;
3. assign_scan at the headline shape, on the main path's first batch, on
   a heterogeneous seeded batch and on an all-miss batch (every pod's
   requests differ from the previous pod's): assignments, scores, feasible
   counts, both ledgers and rr_end must equal the plain loop's exactly;
   each kernel time is reported as median, min and max; then both
   kernels, and the scan's spread build, against their plain versions at
   ragged shapes (tile edges, node padding), which reach every build of
   the scan (N up to 65,536), the spread build on seeded selector counts
   and zones with its edge cases (a pod with no feasible node, nodes
   without a zone or with an id past the universe, a zero maximum count,
   zoned counts all zero), and the interpod build on seeded ledgers,
   topology and terms (at one shape also without the predicate, without
   the priority, and with other weights); then the spread build's
   hazards at every build (spread_hazards): consecutive pods of one
   selector landing on one thread's nodes with counts up to 110, runs of
   pods without an entry between spread pods, and 0, 1, 3 and 64 zones
   in use; then the interpod build's hazards at every build
   (interpod_hazards), with 5, 8 and 16 topology slots: runs of pods
   placed on one node and on one thread's nodes whose next pods read the
   counts those placements added, totals moved off 0 inside the batch
   (the first-pod escape, an empty-key and a poisoned anti term first
   carried mid-batch), domain ids -1 and past the universe at the placed
   nodes, and zero-row and quiet pods between broadcasting and counting
   ones; then the spread+interpod build's hazards at every build
   (spread_interpod_hazards): the interpod hazards' batches with
   SelectorSpread over the same ledger, pods raising both gates, one of
   them or neither, 0, 1, 3, 4 and 64 zones, a required anti term that
   rejects the node SelectorSpread scores highest and the one holding the
   most counts, pods cycling spread only, interpod only and both, and warp
   totals of 65,535 and 65,536 (the bound of the packed zone sums), the
   4- and 64-zone, cycling and bound batches also with the normalization
   flag; the edge shapes and the 8-node hazards hold it too; then
   the 8-node hazards of every build (run8_hazards): node
   counts with N % 4 = 1, 2 and 3 (rows that start unaligned, and the
   row tail's 4-byte copies), one that leaves the last blocks without a
   node, pod counts that are not a multiple of the row ring's stages, an
   all-miss batch at N = 65,536, and revert-heavy gang batches, among them
   groups reverted after 7 members on one node between pods that hit the
   term cache;
4. packed_batch: the main path's first batch encoded through the
   EncodeCache into page-locked blobs, uploaded and unpacked on the card,
   must equal the fresh encoding (encode_pods, batch_from_numpy) field for
   field, exactly; times both encodings and the upload;
5. the main path: Scheduler(device="cuda") places 30,000 pods on 15,000
   nodes in 3 zones through the encode cache; every pod must be placed and
   go through the cache, no node may exceed its allocatable (recomputed on
   the host), both kernels must have launched, and the first batch must
   equal the plain path on the card;
6. many_classes: the main path again on a backlog where every pod is its
   own class (30,000 distinct memory requests, more classes than the
   cache keeps), so every pod misses and is encoded; every pod must be
   placed, within allocatable, and both kernels must have launched;
7. lifecycle, at 15,000 nodes: 15,000 bound pods accounted, 1,000 of them
   removed, 100 nodes removed and 100 added on the freed rows, then 4,096
   pods scheduled through the cache; the kernel path must equal
   schedule_batch_plain on the same flushed state, both kernels must have
   launched, and every node's pods, cpu and memory (bound pods included),
   recomputed on the host, must equal its ledger row and fit allocatable;
8. spread: the reference bench's bench[spread] (15,000 nodes in 3 zones,
   30,000 pods in 16 app groups, 16 Services) through
   Scheduler(device="cuda"); every pod must be placed within allocatable,
   the spread build must have launched once per batch (and the main scan
   never), and the first batch, and the fifth batch's first 256 pods,
   must equal schedule_batch_plain on the state and batch the driver
   solved them on, pod-selector ledger included; times the spread build on
   the first batch against its plain version;
9. interpod: the reference bench's bench[interpod] (5,000 nodes in 3
   zones, 8,192 pods in 8 app groups, required hostname anti-affinity on
   every 16th pod, weight-10 preferred zone affinity on every 2nd) through
   Scheduler(device="cuda"); every pod must be placed within allocatable,
   no node that holds an anti-affinity pod may hold another pod of its
   group, the interpod build must have launched once per batch (and the
   main and spread builds never), and the first batch, and a later
   batch's first 256 pods, must equal schedule_batch_plain on the state
   and batch the driver solved them on, all three ledgers included;
   interpod_build times the build on
   the first batch against its plain version (the edge shapes of phase 3
   hold it at every build, with carried anti terms, a custom topology key
   and the default-domain union);
9b. spread_interpod: bench[spread]'s cluster, pods and Services with
   bench[interpod]'s terms (every 16th pod with required hostname
   anti-affinity to its group, every 2nd a weight-10 preferred zone
   affinity) through Scheduler(device="cuda"); every pod must be placed
   within allocatable, no node that holds an anti-affinity pod may hold
   another pod of its group, the spread+interpod build must have launched
   once per batch (and no other build of the scan), and the first batch,
   and the last batch's first 256 pods, must equal schedule_batch_plain on
   the state and batch the driver solved them on, every ledger included;
   spread_interpod_build times the build on the first batch against the
   plain path's time;
10. gang: the reference bench's bench[gang] (50,000 nodes in 3 zones,
   N = 65,536, 24,576 pods in 3,072 all-or-nothing groups of 8, 6 batches
   of 4,096) through Scheduler(device="cuda"); every group must settle
   (placed or reverted), no node may exceed its allocatable, the gang
   build must have launched once per batch (and no other build of the
   scan), and the gang build must equal its plain version on the first
   driver batch, whose result must be the masked kernel result; times
   kernel 1 and the gang build on that batch, the plain scan once;
11. gang_build: revert-heavy batches at an N for each build of the scan
   (1, 2, 4 and 8 nodes a thread): groups of 8 at quorum 8 and 6 with
   members that fit nowhere, non-gang pods between groups, a group ending
   on the last row, a node that takes two members of a group that
   reverts, and gpu and storage requests in reverting groups; the gang
   build must equal its plain version exactly, rr_end included;
11b. gang_spread_interpod: the spread_interpod cell's cluster and
   Services with 24,576 pods of its mix in 3,072 all-or-nothing groups of
   8 (6 batches of 4,096) through Scheduler(device="cuda"); every group
   must be placed within allocatable, no node that holds an anti-affinity
   pod may hold another pod of its group, the spread+interpod build with
   the gang carry must have launched once a batch (and no other build),
   and the device ledgers flushed at the end must equal the host's
   recomputation from the placements; the first batch, and its variant in
   which every 8th group has a member asking 5 CPUs (those groups revert
   at full width), must equal schedule_batch_plain on their first 256
   pods; gang_cells runs the first batch of the spread and interpod cells
   with their pods in groups of 8, without and with one PreferNoSchedule
   taint, and of gang_spread_interpod with the taint, through the builds
   with the gang carry (once each), held against the plain versions on
   the first 256 pods and timed there;
12. tt_na: the tt_na cell (bench[headline]'s 15,000 nodes with
   dedicated=batch:PreferNoSchedule on every 8th, 30,000 pods in 16 app
   groups, the even ones tolerating the taint, each preferring a zone and
   the odd ones a label value too) through Scheduler(device="cuda"); every
   pod must be placed within allocatable, the main build must have
   launched once a batch, always with the normalization flag (and no
   other build), and the first and last batch must equal
   schedule_batch_plain on the state and batch the driver solved them on;
   the line gives each batch's misses of the main build's guess of the
   maxima (second rounds) by a host replay of its table; tt_na_build times
   the flag's main build on the first batch against its plain version and
   the main build without the flag; norm_cells runs the
   first batch of the spread, gang, interpod and spread_interpod cells
   with one PreferNoSchedule taint added through their builds with the
   flag (once each), held against the plain versions (the interpod builds
   on the first 256 pods) and timed (the gang build's misses in the line);
   and phase 3 ends with norm_build: every build with the flag against its
   plain version at every RUN, with zero maxima, the largest counts on
   infeasible nodes, ties, padding nodes and odd N, and the main and gang
   builds on traffics that force their guess of the maxima to miss (the
   only nodes holding the maxima fill up until the maxima drop to 0, two
   rows with one table key alternate, 40 classes cycle through the table's
   32 entries); and gang_carry_hazards: the spread, interpod and
   spread+interpod builds with the gang carry against their plain
   versions at every RUN, with and without the flag, on each build's
   hazard batches with groups that revert (a member that fits nowhere, a
   group open at the last row), and the spread and interpod builds with
   the carry on the traffics that force the flag's guess to miss;
13. preemption: the preemption cell (perf/harness.py `preemption_cluster`:
   15,000 nodes, N = 16,384, each filled by two priority-0 fillers of
   1900m / 256Mi, 30,000 bound pods, S = 16 victim slots; a wave of 3,750
   pods of 2 cpu / 512Mi at priority 1000, P = 4,096) through
   Scheduler(device="cuda"): no wave pod may land before an eviction,
   every wave pod must get a verdict with k = 1 or 2, the verdicts'
   victims must be disjoint, of lower priority and evictable, kernel 3
   must have launched, and after the victims are removed the whole wave
   must land; then kernel 3 against its plain version on the post-scan
   operands of the wave's batch exactly (preempt_node and victim_count) on
   the uniform cluster, a mixed one (filler priorities 0, 100, 200, every
   5th filler protected, wave priorities 150 and 1000, requests of 2, 1 and
   3 cpu) and a gang one (groups of 8 at quorum 8, fewer evictable victims
   than the wave needs, so that groups revert; held without the gang mask
   too, where a missing revert would show, and it must show groups that
   found nodes after a revert, on nodes a reverted group had booked, whose
   cached verdicts the kernel must evaluate again), timed on the uniform
   and mixed batches; the uniform operands are the drill's own first
   batch (the driver's `prepare_chunk`) before its removals; then the
   wide check, the mixed operands tiled and shuffled to N = 65,536 on
   their first 512 pods, where kernel 3's placement (ops/preemption.py
   `preemption_layout`, the function the wrapper launches with) reads
   the read-only columns through L2 and keeps the bookings in device
   memory; last the class-churn check, the mixed operands' first 512 pods
   with (priority, cpu request) drawn from 24 classes, more than a node's
   verdict entries;
12b. gpu_ports: the gpu_ports cell (perf/harness.py gpu_ports_cluster:
   bench[headline]'s 15,000 nodes, every 4th with 8 GPUs, every one 100Gi
   of scratch and no overlay, a bound pod with host port 8080 on every
   10th; 30,000 pods of 100m / 250Mi, every 4th asking a GPU, 1Gi of
   scratch or 512Mi of overlay on others, host ports 8080 and 9100 on some)
   through Scheduler(device="cuda"): every pod placed within its node's
   GPUs, scratch, cpu, memory and pods, no host port twice on a node (the
   device's counts equal to the host's), the main build with the EXT
   variant launched once a batch (and no other build), the first and last
   batch equal to the plain path; then the cell's first batch on fresh
   clusters in groups of 8 (the gang build with EXT), with one member of
   every 8th group asking 9 GPUs (64 groups revert), and with one
   PreferNoSchedule taint, alone and in groups (the flag's EXT instances),
   each launched once and held against the plain path; and phase 3 ends
   with ext_hazards: the main and gang builds with EXT against their plain
   versions at every RUN, with and without the flag, on batches whose
   GPUs run out mid-batch, whose pods share few ports, list a port twice,
   ask only a GPU or only scratch, or equal the previous pod in cpu and
   memory but not in GPU or ports, on nodes with counts up to 3 and with
   and without overlay allocatable, on groups that revert on a node three
   members share, and on traffics that force the flag's guess to miss;
12c. volumes: the volumes cell (perf/harness.py volumes_cluster,
   volumes_pods: the 15,000 nodes, 24 zonal GCE PVs bound by claims, 4
   unbound claims, a bound pod holding a dataset disk read-write on every
   10th node; 30,000 pods with a token secret and an emptyDir, every 4th
   mounting a dataset disk read-only, every 8th a claim, 4 a claim not
   found and 4 an unbound claim; the conflict and attach universes at 64)
   through Scheduler(device="cuda"): the 8 unplaceable pods left out and
   every other placed, no read-only disk beside its read-write holder, each
   claim's pod in its PV's zone, no node past its GCE PDs, the device's
   conflict and attach counts equal to the host's, the main build with EXT
   launched once a batch (and no other build), the first and last batch
   equal to the plain path; then the cell's first batch on fresh clusters
   with KUBE_MAX_PD_VOLS=1, in groups of 8, with one member of every 8th
   group on an unbound claim (those groups revert), with one
   PreferNoSchedule taint (the tight limit, and the groups: the flag's EXT
   instances), and with NoVolumeNodeConflict's gate on and 2 PVs with node
   affinity, each launched once and held against the plain path (the
   variants on their first 256 pods); and phase 3 ends with vol_hazards:
   the main and gang builds with EXT against their plain versions at every
   RUN, with and without the flag, on batches whose conflict and attach
   universes are full (64 atoms, bits 31, 32 and 63), whose atoms run out
   mid-batch under three attach limits, whose pods list a disk twice, carry
   the attach fail bit or equal the previous pod but in their volumes, on
   groups that revert on a node three members share and must give their
   words back, and on traffics that force the flag's guess to miss;
14. the kernels line, the nvidia-smi line, and last the result line.

Every phase line carries `elapsed_s`, the script's seconds when it was
printed, so the phases' shares of the time limit can be read off a run.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 20261016
HEADLINE_NODES, HEADLINE_PODS = 15000, 30000
P, N, US, UT = 4096, 16384, 128, 64
H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12     # f32 outside the tensor cores
# arithmetic and compare operations of the scan per evaluated (pod, node):
# fit 6, LeastRequested 20, BalancedAllocation 14, score 4, tie update 2
SCAN_OPS_PER_PAIR = 46
# and of SelectorSpread per (spread pod, statically feasible node): the
# count's max and zone sum 3, node and zone scores 6, blend 3, floor 2,
# weighted add 2
SPREAD_OPS_PER_PAIR = 16
# bench[spread] (bench.py:327-338): app groups and Services
SPREAD_GROUPS = 16
# the later bench[spread] batch held against the plain path
SPREAD_CHECKED = (0, 4)
# bench[interpod] (bench.py:313-323): nodes, pods and the pod mix
INTERPOD_NODES, INTERPOD_PODS = 5000, 8192
INTERPOD_MIX = {"app_groups": 8, "anti_affinity_every": 16,
                "pref_affinity_every": 2}
# the bench[interpod] batches held against the plain path (of 7)
INTERPOD_CHECKED = (0, 5)
# operations of the interpod build per (pod, statically feasible node):
# per count entry a gather, a role test, a multiply-add or compare (4),
# and for a pod whose priority counts, its min, max, subtract, multiply,
# divide, add and truncate (7)
IP_OPS_PER_ENTRY = 4
IP_SCORE_OPS = 7
# the spread_interpod cell: bench[spread]'s cluster, pods and Services
# (bench.py:327-338) with bench[interpod]'s terms (bench.py:313-319)
SI_MIX = {"app_groups": SPREAD_GROUPS, "anti_affinity_every": 16,
          "pref_affinity_every": 2}
# its batches held against the plain path (of 8: the first and the last)
SI_CHECKED = (0, 7)
# bench[gang] (bench.py:343-366): nodes, pods and the group size
GANG_NODES, GANG_PODS, GANG_SIZE = 50000, 24576, 8
# the 8-node build's hazards: (pods, nodes, all-miss) through every build,
# N % 4 = 1, 2, 3 and 0 (40,000 leaves blocks 10-15 empty), P % 4 != 0;
# and (pods, nodes, kind) of revert-heavy gang batches
RUN8_SHAPES = ((50, 40001, False), (50, 50002, False), (37, 65535, False),
               (50, 40000, False), (66, 65536, True))
RUN8_REVERTS = ((203, 40001, "heavy"), (201, 65535, "heavy"),
                (122, 65536, "one_node"), (122, 50002, "one_node"))
# the gang_spread_interpod cell: the spread_interpod cell's cluster and
# Services, 24,576 pods of its mix in all-or-nothing groups of 8
# (perf/harness.py GANG_SPREAD_INTERPOD_PODS; 6 batches of 4,096); the pods
# of a first batch held against schedule_batch_plain (the plain loops take
# 14-16 ms a pod on the card), and the groups of its reverting variant
# whose first member asks for 5 CPUs, which no 4-CPU node fits
GSI_PODS = 24576
GSI_SCOPE = 256
GSI_REVERT_EVERY = 8
# the gang carry's hazards (pods, nodes): every build of the scan (1, 2, 4
# and 8 nodes a thread)
GANG_CARRY_SHAPES = ((64, 60), (64, 12000), (64, 30000), (96, 65536))
# the tt_na cell (perf/harness.py TT_NA_NODES, TT_NA_PODS): bench[headline]'s
# cluster with dedicated=batch:PreferNoSchedule on every 8th node, 16 app
# groups with tolerations and preferred terms; its batches held against the
# plain path (of 8: the first and the last)
TT_NA_CHECKED = (0, 7)
# operations of the normalization flag per (pod, statically feasible
# node), counted for each score where the pod's count can be nonzero with
# its weight set (the kernel skips the other): TaintToleration, the
# count's and and popcount 2, packing 1, its maximum 1, (1 - c / M) * 10 +
# eps and trunc 5, its weight and add 2; NodeAffinity, four terms' and,
# compare, select and add 16, packing 1, its maximum 1, c * 10 / M + eps
# and trunc 4, its weight and add 2
NORM_TT_OPS, NORM_NA_OPS = 11, 24
# the norm_build phase's (pods, nodes): odd N at every build of the scan
# (1, 2, 4 and 8 nodes a thread), and N = 40,000 with its last blocks empty
NORM_SHAPES = ((120, 999), (120, 12001), (100, 30001), (80, 65535), (60, 40000))
# the norm_build phase's traffics that force the main and gang builds'
# guess of the flag's maxima to miss (norm_miss_inputs), and the classes
# the overflow traffic cycles through (more than the table's 32 entries)
NORM_MISS_KINDS = ("fill", "collide", "overflow")
NORM_OVERFLOW_CLASSES = 40
# pods of a cell's first batch on which the interpod and spread+interpod
# builds with the flag are held against, and timed beside, the plain path
# (whose loops take 14-16 ms a pod on the card); their kernels-line entries
# say so in `scope`
NORM_PREFIX = 256
# the EXT variant's hazards (pods, nodes): the main and gang builds with
# EXT at every RUN (1, 2, 4 and 8 nodes a thread), odd N; the host-port
# universe of their inputs (a bit past 31 and bit 63 in use)
EXT_SHAPES = ((120, 999), (120, 12001), (100, 30001), (80, 65535))
EXT_PORTS = 64
# operations of the EXT variant per evaluated (pod, node): the port words'
# and and test 2, the gpu column's add and compare 2, the storage fit's
# overlay test, three adds and a compare (or two adds and two compares) 5
EXT_OPS_PER_PAIR = 9
# the volume half (per feasible pair of a pod with such words): the disk
# conflict (two ANDs, an OR, a compare) and, per attach limit, two ANDs, an
# AND-NOT, two popcounts, an add and a compare
VOL_DISK_OPS = 4
VOL_ATTACH_OPS = 7
# the gpu_ports cell (perf/harness.py GPU_PORTS_NODES, GPU_PORTS_PODS,
# gpu_ports_cluster): its batches held against the plain path (of 8: the
# first and the last), the group size of its gang variant, and every how
# many groups one member of its reverting variant asks 9 GPUs (no node has
# more than 8)
GPU_PORTS_CHECKED = (0, 7)
GPU_PORTS_GANG = 8
GPU_PORTS_REVERT_EVERY = 8
# the pods of a later checked batch, and of the first batch with the flag,
# held against the plain path (whose EXT loop takes ~3 ms a pod on the card)
GPU_PORTS_SCOPE = 256
# the EXT scan then kernel 3: a wave of priority pods asking 8 GPUs on the
# gpu_ports cluster at 2,000 nodes (N = 2,048, one batch of 1,024): 400
# fit whole GPU nodes, and evicting a bound pod frees the 100 with 7
GPU_PREEMPT_NODES, GPU_PREEMPT_PODS = 2000, 600
# the volume hazards: the EXT shapes' batches with conflict and attach
# atoms filling both universes (64, the words' limit: bits 31, 32 and 63
# in use) and three attach limits that bite (EBS 3, GCE 2, Azure 2)
VOL_UNIVERSE = 64
VOL_LIMITS = ((0, 3), (1, 2), (2, 2))   # (VolType, limit)
# the volumes cell (perf/harness.py volumes_cluster, volumes_pods): its
# batches held against the plain path (of 8: the first and the last), the
# group size of its gang variant, every how many groups one member of it
# mounts an unbound claim (those groups revert), KUBE_MAX_PD_VOLS of its
# first batch's tight variant, and the PVs with node affinity of its
# VolumeNode variant
VOLUMES_CHECKED = (0, 7)
VOLUMES_GANG = 8
VOLUMES_REVERT_EVERY = 8
VOLUMES_TIGHT_LIMIT = 1
VOLUMES_NODE_AFFINITY_PVS = 2

# the preemption cell (perf/harness.py preemption_cluster): nodes, and the
# variants whose post-scan operands kernel 3 is held on; operations of the
# pass per (taking-part pod, statically feasible node): per slot the
# evictable, taken and priority tests (3), the ledger's adds (R); and per
# fit checked: the slot's subtraction a resource (R), the fit's adds and
# compares (pods 2, cpu, memory and gpu 6, storage 5)
PREEMPT_NODES = HEADLINE_NODES
PREEMPT_VARIANTS = ("uniform", "mixed", "gang")
PREEMPT_SLOT_OPS = 3
PREEMPT_FIT_OPS = 13
# the wide check of kernel 3: the mixed operands' node axis tiled to N =
# 65,536 (a cluster past 32,768 nodes), where the read-only columns are
# read through L2 (ops/preemption.py preemption_layout), on the batch's
# first pods
PREEMPT_WIDE_COPIES = 4
PREEMPT_WIDE_PODS = 512
# the class-churn check of kernel 3: the mixed operands' first pods with
# priorities and cpu requests (millicores) drawn from more classes than a
# node's verdict cache holds (ops/preemption.py MAX_ENTRIES), so most pods
# evaluate every node again
PREEMPT_CHURN_PODS = 512
PREEMPT_CHURN_PRIORITIES = (50, 150, 250, 1000)
PREEMPT_CHURN_CPU = (500.0, 1000.0, 1500.0, 2000.0, 2500.0, 3000.0)


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase line also gets the script's seconds so far."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def timed_call(torch, fn):
    """(fn(), the CUDA-event ms of that one call): a plain version's
    result and its time from the call the kernel is compared with."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def time_ms(torch, fn, reps: int, warmup: int = 1) -> tuple[float, float, float]:
    """(median, min, max) CUDA-event time of one call, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), min(times), max(times)


def timed(torch, fn, reps: int, key: str = "ms") -> dict:
    """{key: median, key_min: min, key_max: max} of time_ms."""
    med, lo, hi = time_ms(torch, fn, reps)
    return {key: med, f"{key}_min": lo, f"{key}_max": hi}


# every bound() call's (bytes, operations), newest last (norm_bound reads them)
BOUND_PARTS: list = []


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    BOUND_PARTS.append((nbytes, ops))
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_report(log: str) -> dict:
    """{kernel: "spill bytes, registers"} from nvcc's -Xptxas=-v report; a
    template kernel is named with its template arguments (the scan's
    `<RUN, SPREAD, IPA, GANG, NORM, EXT>` as e.g.
    "assign_scan_kernel<8,0,0,1,0,0>")."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(_Z\w+)'", ln)
        if m:
            # the mangled name's components: <length><identifier>...
            mangled = m.group(1)
            i = 3 if mangled.startswith("_ZN") else 2
            while i < len(mangled) and mangled[i].isdigit():
                j = i
                while mangled[j].isdigit():
                    j += 1
                name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
            if mangled[i:i + 1] == "I":
                # (those before the pack of operand types, `J...E`: the
                # flag's NormMain<RUN> carries a template argument of its own)
                args = re.findall(r"Li(\d+)E|Lb([01])E", mangled[i:].split("J")[0])
                name += f"<{','.join(a or b for a, b in args)}>"
        elif name and ("registers" in ln or "spill" in ln):
            out[name] = (out.get(name, "") + " " + ln.strip()).strip()
    return out


def max_abs_err(torch, pairs) -> float:
    return max(float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
               for a, b in pairs)


def static_mask_inputs(torch, rng, dev, P=P, N=N, live=HEADLINE_NODES):
    """Seeded kernel-1 inputs: P pods, N node rows of which `live` valid."""
    n_terms, n_taints = 16, 8
    sel_member = (rng.random((N, US)) < 0.5) & (np.arange(US) < n_terms)
    sel_onehot = np.zeros((P, US), np.float32)
    for p in np.flatnonzero(rng.random(P) < 0.3):
        sel_onehot[p, rng.choice(n_terms, rng.integers(1, 3), replace=False)] = 1
    sel_count = sel_onehot.sum(1)
    hard = (rng.random((N, UT)) < 0.05) & (np.arange(UT) < n_taints)
    tolerated = (rng.random((P, UT)) < 0.3) & (np.arange(UT) < n_taints)
    conditions = np.zeros(N, np.int32)
    for bit in range(6):
        conditions |= np.where(rng.random(N) < 0.03, 1 << bit, 0).astype(np.int32)
    bits = np.where(np.arange(N) < live, conditions,
                    conditions | np.int32(-2147483648)).astype(np.int32)
    name_lo = rng.integers(1, 2**31 - 1, N, dtype=np.int32)
    name_hi = rng.integers(1, 2**31 - 1, N, dtype=np.int32)
    pin = rng.random(P) < 0.02
    target = rng.integers(0, N, P)
    pod_lo = np.where(pin, name_lo[target], 0).astype(np.int32)
    pod_hi = np.where(pin, name_hi[target], 0).astype(np.int32)
    pod_lo[np.flatnonzero(pin)[:8]] = 7  # pinned to a name no node has

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=dev, dtype=dtype)

    f32 = torch.float32
    return (t(sel_onehot), t(sel_count, f32), t(1.0 - tolerated, f32),
            t(rng.random(P) < 0.1), t(pod_lo), t(pod_hi), t(sel_member, f32),
            t(hard, f32), t(bits), t(name_lo), t(name_hi))


def scan_inputs(torch, rng, dev, P=P, N=N, all_miss=False):
    """A seeded heterogeneous kernel-2 batch: mixed capacities, a partly
    filled ledger, statically infeasible pairs, avoid-scores, and requests
    in runs (consecutive pods of one workload share them) of random length,
    with BestEffort-like all-zero requests among them. With `all_miss`
    every pod's (cpu, memory) differs from the previous pod's, so the
    scan's term cache never hits."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    alloc = np.zeros((N, 6), np.float32)
    alloc[:, 0] = rng.integers(1, 9, N)
    alloc[:, 1] = rng.integers(1, 9, N) * 1000
    alloc[:, 2] = rng.integers(2, 17, N) * 1024
    alloc[rng.random(N) < 0.01, 1] = 0
    requested = np.floor(alloc * rng.random((N, 1)) * 0.7)
    nonzero = requested[:, 1:3] + 100
    ms = np.where(rng.random((P, N)) < 0.2, -np.inf,
                  np.where(rng.random((P, N)) < 0.05, 20.0, 100020.0))
    run = np.cumsum(rng.random(P) < 0.2)
    cpu = rng.choice([0, 100, 250, 500, 1000], run[-1] + 1)[run]
    mem = rng.choice([0, 128, 256, 1024], run[-1] + 1)[run]
    if all_miss:  # a step of 1..4 grid points from the previous pod's
        cpu = (np.cumsum(rng.integers(1, 5, P)) % 9) * 125
        mem = (np.cumsum(rng.integers(1, 5, P)) % 9) * 128
    reqs = np.zeros((P, 6), np.float32)
    reqs[:, 0], reqs[:, 1], reqs[:, 2] = 1, cpu, mem
    nz_reqs = np.stack([np.where(cpu > 0, cpu, 100), np.where(mem > 0, mem, 200)], 1)
    return (t(ms), t(reqs), t(nz_reqs), t(alloc), t(requested), t(nonzero),
            2**32 - 3)


def static_mask_bound(torch, args) -> tuple[float, str]:
    """Bytes: the bool output plus every operand once. Operations: the
    products' nonzero pairs (the one-hot operands are sparse) plus eight
    epilogue operations per output."""
    sel_onehot, _, untol, _, _, _, sel_member, hard, _, _, _ = args
    p, n = sel_onehot.shape[0], sel_member.shape[0]
    nbytes = p * n + sum(a.numel() * a.element_size() for a in args)
    pairs = sum(float(((a != 0).sum(0).double() * (b != 0).sum(0).double()).sum())
                for a, b in ((sel_onehot, sel_member), (untol, hard)))
    return bound(nbytes, 2 * pairs + 8 * p * n)


def scan_bound(masked, requests, nonzero_requests, alloc, requested, nonzero):
    """Bytes: every input once, the ledger written once, the per-pod outputs.
    Operations: SCAN_OPS_PER_PAIR per statically feasible (pod, node)."""
    ins = (masked, requests, nonzero_requests, alloc, requested, nonzero)
    nbytes = (sum(a.numel() * a.element_size() for a in ins)
              + requested.numel() * 4 + nonzero.numel() * 4 + masked.shape[0] * 12)
    pairs = float((masked > float("-inf")).sum())
    return bound(nbytes, SCAN_OPS_PER_PAIR * pairs)


def compare_scan(torch, got, want) -> float:
    names = ("assignments", "scores", "feasible_counts", "new_requested",
             "new_nonzero", "rr_end")
    for name in names:
        if not torch.equal(getattr(got, name), getattr(want, name)):
            raise AssertionError(f"assign_scan kernel != plain on {name}")
    return max_abs_err(torch, [(getattr(got, n), getattr(want, n)) for n in names])


def norm_test_inputs(torch, rng, dev, masked, w_tt=1.0, w_na=1.0):
    """Seeded NormInputs for a kernel-2 batch `masked` [P, N], and the
    batch's masked_static with its hazards: nodes carry taint bits 0, 1, 2,
    5 and 63 (the sign bit) and requirement bits 0-11 and 63; pods are
    untolerant of some of those and of bit 7, which no node carries (so a
    pod untolerant of it alone has a zero maximum, with an exchange),
    prefer up to 4 terms of 1-3 requirement bits (bit 40, which no node
    meets, in some: a zero NodeAffinity maximum) with weights from 1 to
    100, 0 and -2 (never scoring); every 7th pod's highest-count node (all
    taint bits, all requirement bits) is statically infeasible to it; a
    few distinct bits make many nodes tie on both counts."""
    p, n = masked.shape
    one = np.uint64(1)

    def word(bits, prob, size):
        w = np.zeros(size, np.uint64)
        for b in bits:
            w |= np.where(rng.random(size) < prob, one << np.uint64(b), np.uint64(0))
        return w

    taint_bits, req_bits = (0, 1, 2, 5, 63), tuple(range(12)) + (63,)
    node_taint = word(taint_bits, 0.15, n)
    node_req = word(req_bits, 0.5, n)
    untol = word(taint_bits + (7,), 0.4, p)
    untol[rng.random(p) < 0.1] = 0
    untol[rng.random(p) < 0.05] = one << np.uint64(7)
    terms = np.zeros((p, 4), np.uint64)
    for k in range(4):
        for _ in range(3):
            pick = np.array(req_bits + (40,))[rng.integers(0, len(req_bits) + 1, p)]
            terms[:, k] |= np.where(rng.random(p) < 0.6, one << pick.astype(np.uint64),
                                    np.uint64(0))
    weights = rng.choice([0.0, 1.0, 5.0, 10.0, 100.0, -2.0], (p, 4)).astype(np.float32)
    weights[rng.random(p) < 0.1] = 0.0
    ms = masked.clone()
    hot = np.flatnonzero(np.arange(p) % 7 == 3)
    if hot.size:
        node = rng.integers(0, n, hot.size)
        node_taint[node] = np.bitwise_or.reduce([one << np.uint64(b) for b in taint_bits])
        node_req[node] = ~np.uint64(0)
        ms[torch.from_numpy(hot).to(dev), torch.from_numpy(node).to(dev)] = float("-inf")

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int64)).to(dev)

    from kubernetes_tpu_torch.ops.assign_scan import NormInputs

    return ms, NormInputs(
        w_tt=w_tt, w_na=w_na, node_taint=t(node_taint), node_req=t(node_req),
        pod_untol=t(untol), pod_terms=t(terms),
        pod_weights=torch.from_numpy(weights).to(dev))


def norm_miss_inputs(torch, rng, dev, sargs, kind):
    """Scan operands (scan_inputs' `sargs`, changed) and NormInputs that
    force the main and gang builds' guess of the flag's maxima to miss
    (csrc/assign_scan.cu's header: the maxima table):
    - fill: three nodes meet the pods' preferred terms (weights 60 and 40:
      sums 100, 60 and 40), each with room for two more pods, and w_na =
      100 (every other static score 20) makes them win, so the maxima fall
      from 100 to 60, 40 and 0 as the only nodes holding them fill up;
    - collide: the pods alternate between untolerating taint 0 and taints
      0 and 2 (maxima 1 and 2 while a node with both is feasible), the
      second row's unweighted fourth term word chosen so that both rows
      have one table key;
    - overflow: pod p untolerates the lowest 1 + p % 40 taints and some
      nodes carry all 64, so 40 keys with 40 maxima cycle through the
      table's 32 entries.
    Returns (the operands, the NormInputs)."""
    from kubernetes_tpu_torch.ops.assign_scan import (NORM_SLOTS, NormInputs,
                                                      norm_key_weight, norm_pod_rows,
                                                      norm_row_key)

    ms, reqs, nz_reqs, alloc, requested, nonzero, rr = sargs
    p, n = ms.shape
    node_taint = np.zeros(n, np.uint64)
    node_req = np.zeros(n, np.uint64)
    untol = np.zeros(p, np.uint64)
    terms = np.zeros((p, NORM_SLOTS), np.uint64)
    weights = np.zeros((p, NORM_SLOTS), np.float32)
    w_na = 1.0
    if kind == "fill":
        hot = torch.from_numpy(rng.choice(n, 3, replace=False)).to(dev)
        node_req[hot.cpu().numpy()] = [3, 1, 2]
        terms[:, 0], terms[:, 1] = 1, 2
        weights[:, 0], weights[:, 1] = 60.0, 40.0
        w_na = 100.0
        ms = torch.where(ms > float("-inf"), 20.0, float("-inf"))
        ms[:, hot] = 20.0
        alloc, requested = alloc.clone(), requested.clone()
        requested[hot, 1:] = 0.0
        alloc[hot, 0] = requested[hot, 0] + 2.0
        alloc[hot, 1], alloc[hot, 2] = 64000.0, 65536.0
    elif kind == "collide":
        node_taint |= np.where(rng.random(n) < 0.2, np.uint64(1), np.uint64(0))
        node_taint |= np.where(rng.random(n) < 0.2, np.uint64(4), np.uint64(0))
        untol[0::2], untol[1::2] = 1, 5
    elif kind == "overflow":
        node_taint[rng.random(n) < 0.05] = ~np.uint64(0)
        k = 1 + np.arange(p) % NORM_OVERFLOW_CLASSES
        untol[:] = (np.uint64(1) << k.astype(np.uint64)) - np.uint64(1)
    else:
        raise ValueError(f"norm_miss_inputs: {kind}")

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int64)).to(dev)

    norm = NormInputs(w_tt=1.0, w_na=w_na, node_taint=t(node_taint), node_req=t(node_req),
                      pod_untol=t(untol), pod_terms=t(terms),
                      pod_weights=torch.from_numpy(weights).to(dev))
    if kind == "collide" and p > 1:
        # the odd rows' fourth term word (ints 8 and 9, weight 0) such that
        # their key is the even rows': int 9 solves the key's sum
        rows = norm_pod_rows(norm).cpu().numpy()
        rest = norm_row_key(rows[1])   # ints 8 and 9 are 0 here
        x9 = (norm_row_key(rows[0]) - rest) * pow(norm_key_weight(9), -1, 1 << 32)
        terms[1::2, 3] = np.uint64(x9 % (1 << 32)) << np.uint64(32)
        norm.pod_terms = t(terms)
        keys = {norm_row_key(r) for r in norm_pod_rows(norm).cpu().numpy()}
        if len(keys) != 1:
            raise AssertionError(f"norm_miss_inputs: collide made keys {keys}")
    return (ms, reqs, nz_reqs, alloc, requested, nonzero, rr), norm


# the scan builds whose flag guesses its maxima (every build but
# spread+interpod; csrc/assign_scan.cu's header)
NORM_GUESS_BUILDS = ("assign_scan", "assign_scan_spread", "assign_scan_interpod",
                     "assign_scan_gang", "assign_scan_spread_gang",
                     "assign_scan_interpod_gang")


def norm_misses(name, args, norm, got):
    """The second rounds (misses of the guess) of a launch of build `name`
    (NORM_GUESS_BUILDS, EXT_BUILDS) with the flag on `args` that returned `got`, from
    the host replay of its maxima table (ops/assign_scan.py
    norm_true_maxima, with the interpod build's predicate, and
    norm_table_misses): (misses, pods that exchange maxima)."""
    from kubernetes_tpu_torch.ops.assign_scan import (ExtInputs, GangInputs,
                                                      norm_table_misses, norm_true_maxima)

    gang = next((a for a in args[9:] if isinstance(a, GangInputs)), None)
    ext = next((a for a in args[9:] if isinstance(a, ExtInputs)), None)
    interpod = args[9] if name.startswith("assign_scan_interpod") else None
    maxima = norm_true_maxima(args[0], args[1], args[3], args[4], norm,
                              got.assignments, gang, interpod, ext)
    table = norm_table_misses(norm, maxima)
    return sum(m is True for m in table), sum(m is not None for m in table)


def compare_spread(torch, got, want) -> float:
    """compare_scan plus the pod-selector ledger."""
    err = compare_scan(torch, got, want)
    if not torch.equal(got.new_podsel, want.new_podsel):
        raise AssertionError("assign_scan_spread kernel != plain on new_podsel")
    return max(err, max_abs_err(torch, [(got.new_podsel, want.new_podsel)]))


def spread_inputs(torch, rng, dev, n, p, uq=32, zones=3, no_entry=None,
                  beyond=0.05, universe=64):
    """Seeded SpreadInputs for p pods on n nodes: selector counts, zones
    (ids below `zones`, the zones in use; a fifth of the nodes without one
    and a share `beyond` with an id past the universe), each pod's entry
    (-1 for some; with `no_entry`, that share of short runs of pods is
    -1 between runs of entries) and match row. Column 0 is zero everywhere
    (a zero maximum count) and column 1 counts only on nodes without a
    zone (zoned counts all zero)."""
    from kubernetes_tpu_torch.ops.assign_scan import SpreadInputs
    from kubernetes_tpu_torch.state.layout import TOPO_SPREAD_ZONE

    zone = rng.integers(0, zones, n) if zones else np.full(n, -1)
    zone[rng.random(n) < 0.2] = -1
    past = rng.random(n) < beyond
    zone[past] = rng.integers(universe, universe + 8, int(past.sum()))
    topo = np.full((n, 8), -1, np.int32)
    topo[:, TOPO_SPREAD_ZONE] = zone
    podsel = rng.integers(0, 6, (n, uq)).astype(np.float32)
    podsel[rng.random((n, uq)) < 0.5] = 0.0
    podsel[:, 0] = 0.0
    podsel[zone >= 0, 1] = 0.0
    q = rng.integers(-1, uq, p).astype(np.int32)
    if no_entry is not None:   # runs of 1-3 pods, some without an entry
        runs = np.cumsum(rng.random(p) < 0.5)
        q[(rng.random(runs[-1] + 1) < no_entry)[runs]] = -1
    match = (rng.random((p, uq)) < 0.1).astype(np.float32)
    match[q >= 0, q[q >= 0]] = 1.0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return SpreadInputs(w_ss=1.0, spread_q=t(q), pod_matches_q=t(match),
                        podsel_count=t(podsel), topology=t(topo),
                        domain_universe=universe, zones=zones)


def spread_hot_inputs(torch, rng, dev, n, p, uq=8):
    """A spread batch whose pods of one selector land on one thread's nodes
    pod after pod: only one thread's run of nodes (the scan gives a
    thread node_run(n) consecutive nodes) and two other nodes are
    feasible, the counts are heavy (up to 110 a node), and the pods take
    one entry in long runs (now and then another entry, or none), so a
    pod's count column is loaded before the pod ahead of it lands on the
    same thread. Returns (the scan's arguments, SpreadInputs)."""
    from kubernetes_tpu_torch.ops.assign_scan import SpreadInputs, node_run
    from kubernetes_tpu_torch.state.layout import TOPO_SPREAD_ZONE

    run = node_run(n)
    first = run * int(rng.integers(0, n // run))
    feasible = np.r_[np.arange(first, first + run), rng.choice(n, 2)]
    ms = np.full((p, n), -np.inf, np.float32)
    ms[:, feasible] = np.where(rng.random((p, feasible.size)) < 0.1, 20.0, 100020.0)
    alloc = np.zeros((n, 6), np.float32)
    alloc[:, 0], alloc[:, 1], alloc[:, 2] = 400, 64000, 262144
    requested = np.zeros((n, 6), np.float32)
    requested[:, 0] = rng.integers(0, 100, n)
    nonzero = np.full((n, 2), 100.0, np.float32)
    reqs = np.zeros((p, 6), np.float32)
    reqs[:, 0], reqs[:, 1], reqs[:, 2] = 1, 100, 128
    nz_reqs = np.tile(np.float32([100, 128]), (p, 1))
    zone = rng.integers(0, 3, n)
    zone[rng.random(n) < 0.2] = -1
    topo = np.full((n, 8), -1, np.int32)
    topo[:, TOPO_SPREAD_ZONE] = zone
    podsel = rng.integers(0, 111, (n, uq)).astype(np.float32)
    base = int(rng.integers(0, uq))
    other = rng.integers(0, uq, p)
    switch = np.cumsum(rng.random(p) < 0.15) % 3   # runs: base, another, base
    q = np.where(switch == 1, other, base).astype(np.int32)
    q[rng.random(p) < 0.1] = -1
    match = (rng.random((p, uq)) < 0.3).astype(np.float32)
    match[q >= 0, q[q >= 0]] = 1.0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    args = (t(ms), t(reqs), t(nz_reqs), t(alloc), t(requested), t(nonzero), 2**32 - 5)
    return args, SpreadInputs(w_ss=1.0, spread_q=t(q), pod_matches_q=t(match),
                              podsel_count=t(podsel), topology=t(topo),
                              domain_universe=64, zones=3)


def spread_bound(scan_args, spread) -> tuple[float, str]:
    """scan_bound's bytes plus the spread inputs once and the pod-selector
    ledger written once; its operations plus SPREAD_OPS_PER_PAIR per
    statically feasible pair of a pod with an entry."""
    masked = scan_args[0]
    t_bytes, _ = scan_bound(*scan_args[:6])
    ins = (spread.spread_q, spread.pod_matches_q, spread.podsel_count)
    nbytes = (t_bytes * 1e-3 * H100_BYTES_PER_S
              + sum(a.numel() * a.element_size() for a in ins)
              + masked.shape[1] * 4 + spread.podsel_count.numel() * 4)
    feasible = masked > float("-inf")
    pairs = float(feasible.sum())
    spread_pairs = float(feasible[spread.spread_q >= 0].sum())
    return bound(nbytes, SCAN_OPS_PER_PAIR * pairs + SPREAD_OPS_PER_PAIR * spread_pairs)


def spread_scan_args(torch, state, batch, caps, flags, zones=None):
    """The spread build's arguments for one solved batch: Phase A's masked
    scores and the scan operands, and its SpreadInputs (with `zones`, the
    zone ids in use, where given; a tree from before the field takes
    none)."""
    from kubernetes_tpu_torch.ops import solver
    from kubernetes_tpu_torch.ops.assign_scan import SpreadInputs

    g = solver.check_supported(solver.DEFAULT_POLICY, flags)
    masked = solver.masked_static_scores(state, batch, solver.DEFAULT_POLICY, g)
    args = (masked, batch.requests, batch.nonzero_requests, state.allocatable,
            state.requested, state.nonzero_requested, 0, float(g.w_lr),
            float(g.w_ba))
    return args, SpreadInputs(
        w_ss=float(g.w_ss), spread_q=batch.spread_q.contiguous(),
        pod_matches_q=batch.pod_matches_q.contiguous(),
        podsel_count=state.podsel_count, topology=state.topology,
        domain_universe=caps.domain_universe,
        **({} if zones is None else {"zones": zones}))


def spread_first_batch(torch, dev):
    """bench[spread]'s cluster and the flushed state and batch of its first
    batch, encoded through a Scheduler: (caps, nodes, pods, services,
    state, batch, flags, the spread zones interned)."""
    from kubernetes_tpu_torch.ops import solver
    from kubernetes_tpu_torch.perf.fixtures import make_nodes, make_pods, make_services
    from kubernetes_tpu_torch.perf.harness import default_caps
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.state.convert import batch_from_numpy
    from kubernetes_tpu_torch.state.pod_batch import encode_pods

    caps = default_caps(HEADLINE_NODES, HEADLINE_PODS)
    nodes = make_nodes(HEADLINE_NODES, zones=3)
    from kubernetes_tpu_torch.state.layout import TOPO_SPREAD_ZONE

    pods = make_pods(HEADLINE_PODS, app_groups=SPREAD_GROUPS)
    services = make_services(SPREAD_GROUPS)
    ref = Scheduler(caps, device=dev)
    ref.add_nodes(nodes)
    for svc in services:
        ref.add_service(svc)
    host = encode_pods(pods[:caps.batch_pods], caps, ref.statedb.table,
                       ctx=ref.encode_cache.ctx)
    state = ref.statedb.flush()
    batch = batch_from_numpy(host, dev)
    return (caps, nodes, pods, services, state, batch, solver.batch_flags(state, batch),
            len(ref.statedb.table.domains[TOPO_SPREAD_ZONE]))


def record_solves(torch, driver, checked, seen):
    """Wrap the driver's schedule_batch: append (inputs, result) of every
    batch to `seen`, the inputs (a copy of the state, which the next flush
    may write in place, the batch, rr and the flags) only for the batch
    indices in `checked`. Returns the original function."""
    solve = driver.schedule_batch

    def recording(state, batch, rr, policy, flags, caps_, **kw):
        k = len(seen)
        keep = None
        if k in checked:
            keep = (dataclasses.replace(state, **{
                f.name: getattr(state, f.name).clone()
                for f in dataclasses.fields(state)}), batch,
                rr.clone() if isinstance(rr, torch.Tensor) else rr, flags)
        result = solve(state, batch, rr, policy, flags, caps_, **kw)
        seen.append((keep, result))
        return result

    driver.schedule_batch = recording
    return solve


def spread_phase(torch, caps, dev, kernels) -> tuple[dict, dict]:
    """bench[spread] through Scheduler(device="cuda"), its first and fifth
    batch held against the plain path on the state and batch the driver
    solved them on, and the spread build timed on the first batch. Returns
    (the phase line, the kernels-line entry)."""
    from kubernetes_tpu_torch.ops import solver
    from kubernetes_tpu_torch.ops.assign_scan import (
        assign_scan_spread,
        assign_scan_spread_plain,
    )
    from kubernetes_tpu_torch.perf.harness import measure, warm
    from kubernetes_tpu_torch.scheduler import Scheduler, driver

    _caps, nodes, pods, services, state0, first, flags0, zones = spread_first_batch(torch, dev)
    warm(caps, solver.DEFAULT_POLICY, dev, n_services=SPREAD_GROUPS)
    sched = Scheduler(caps, device=dev)
    sched.add_nodes(nodes)
    for svc in services:
        sched.add_service(svc)
    # record what the driver solves in the checked batches
    seen = []
    solve = record_solves(torch, driver, SPREAD_CHECKED, seen)
    for k in kernels:
        k.launches = 0
    try:
        result = measure(sched, pods)
    finally:
        driver.schedule_batch = solve
    launches = {k.__name__: k.launches for k in kernels}
    if result.scheduled != HEADLINE_PODS:
        raise AssertionError(f"spread: placed {result.scheduled}/{HEADLINE_PODS}")
    if launches != {"static_mask": result.batches, "assign_scan": 0,
                    "assign_scan_spread": result.batches,
                    "assign_scan_spread_interpod": 0}:
        raise AssertionError(f"spread: launches {launches} over "
                             f"{result.batches} batches")
    load = check_load(pods, result.placements, nodes)
    for k in SPREAD_CHECKED:
        (state, batch, rr, flags), got = seen[k]
        if k != SPREAD_CHECKED[0]:
            # a later batch on its first GSI_SCOPE pods, the kernel path run
            # again on them (the plain spread loop takes ~13 s a whole batch)
            batch = scope_batch(batch, GSI_SCOPE)
            got = solver.schedule_batch(state, batch, rr, solver.DEFAULT_POLICY, flags,
                                        caps, spread_zones=sched.statedb.table.spread_zones)
        plain = solver.schedule_batch_plain(state, batch, rr, solver.DEFAULT_POLICY,
                                            flags, caps)
        compare_spread(torch, got, plain)
    # the first batch as the driver solved it is the one encoded afresh
    names = sched.statedb.table.name_of
    if [names[r] for r in seen[0][1].assignments.tolist()] != \
            [result.placements[p.key] for p in pods[:caps.batch_pods]]:
        raise AssertionError("spread: first batch placements != its result")
    if not torch.equal(seen[0][0][1].pod_matches_q, first.pod_matches_q) or \
            not torch.equal(seen[0][0][1].spread_q, first.spread_q):
        raise AssertionError("spread: the driver's first batch != the fresh encoding")
    # per app group, pods in the fullest and the emptiest zone
    zone_of = {n.metadata.name: n.metadata.labels[
        "failure-domain.beta.kubernetes.io/zone"] for n in nodes}
    spread_counts: dict = {}
    for p in pods:
        key = (p.metadata.labels["app"], zone_of[result.placements[p.key]])
        spread_counts[key] = spread_counts.get(key, 0) + 1
    per_group = {}
    for (app, _z), c in spread_counts.items():
        per_group.setdefault(app, []).append(c)
    imbalance = max(max(v) - min(v) for v in per_group.values())

    args, spread = spread_scan_args(torch, state0, first, caps, flags0, zones)
    plain, plain_ms = timed_call(torch, lambda: assign_scan_spread_plain(*args, spread))
    err = compare_spread(torch, assign_scan_spread(*args, spread), plain)
    entry = {
        "name": "assign_scan_spread", "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/assign_scan.cu",
        "replaces": "kubernetes_tpu/ops/spread.py:29",
        "launches": launches["assign_scan_spread"], "max_abs_err": err,
        **timed(torch, lambda: assign_scan_spread(*args, spread), reps=5),
        "plain_ms": plain_ms,
        "library_ms": None,
    }
    entry["bound_ms"], entry["bound_by"] = spread_bound(args, spread)
    encode_ms = 1e3 * sum(sched.encode_seconds)
    solve_ms = 1e3 * sum(sched.solve_seconds)
    line = {"phase": "spread", "nodes": HEADLINE_NODES, "pods": HEADLINE_PODS,
            "services": len(services), "app_groups": SPREAD_GROUPS,
            **run_fields(result), "encode_ms": encode_ms, "solve_ms": solve_ms,
            "remainder_ms": 1e3 * result.seconds - encode_ms - solve_ms,
            "podsel_entries": len(sched.statedb.table.podsels),
            "nodes_used": len(load), "max_zone_imbalance_per_group": imbalance,
            "launches": launches, "checked_batches_equal_plain": list(SPREAD_CHECKED),
            "later_batch_scope_pods": GSI_SCOPE}
    return line, entry


def compare_interpod(torch, got, want, kernel="assign_scan_interpod") -> float:
    """compare_scan plus the pod-selector and carried-term ledgers."""
    err = compare_scan(torch, got, want)
    for name in ("new_podsel", "new_term"):
        if not torch.equal(getattr(got, name), getattr(want, name)):
            raise AssertionError(f"{kernel} kernel != plain on {name}")
    return max(err, max_abs_err(torch, [(got.new_podsel, want.new_podsel),
                                        (got.new_term, want.new_term)]))


def interpod_inputs(torch, rng, dev, n, p, uq=32, ue=32, k=8, poisoned=False):
    """Seeded InterpodInputs for p pods on n nodes: zones, regions and their
    composites (some nodes without one), a custom topology key in slot 5,
    sparse pod-selector and carried-term counts, carried terms of every
    kind at hostname, zone, region, the custom slot and (preferred ones)
    the default-domain union, one required anti term with an empty key
    and, with `poisoned`, a poisoned anti term with a carrier; pods with
    match and carried-term rows, required affinity and anti-affinity on
    those keys, preferred terms of both signs, and a few ipaff_fail."""
    from kubernetes_tpu_torch.ops.assign_scan import InterpodInputs

    topo = np.full((n, k), -1, np.int32)
    topo[:, 0] = np.arange(n)
    zone = rng.integers(-1, 3, n)
    region = rng.integers(-1, 2, n)
    topo[:, 1], topo[:, 2] = zone, region
    topo[:, 3] = np.where((zone >= 0) & (region >= 0), zone * 2 + region, -1)
    topo[:, 4] = np.where((zone >= 0) | (region >= 0), (region + 1) * 4 + zone + 1, -1)
    topo[:, 5] = rng.integers(-1, 10, n)
    podsel = rng.integers(0, 4, (n, uq)).astype(np.float32)
    podsel[rng.random((n, uq)) < 0.7] = 0.0
    term = rng.integers(0, 3, (n, ue)).astype(np.float32)
    term[rng.random((n, ue)) < 0.8] = 0.0
    keys = np.array([0, 1, 2, 5])
    term_q = rng.integers(0, uq, ue).astype(np.int32)
    kind = rng.integers(0, 4, ue).astype(np.int32)
    tkey = rng.choice(keys, ue).astype(np.int32)
    tkey[(kind >= 2) & (rng.random(ue) < 0.3)] = -2
    weight = np.where(kind == 2, rng.integers(1, 100, ue),
                      np.where(kind == 3, -rng.integers(1, 100, ue), 0)).astype(np.float32)
    poison = np.zeros(ue, bool)
    kind[0], tkey[0] = 0, -1                  # an empty key on a required anti term
    term[:, 0] = 0.0
    term[rng.integers(n), 0] = 1.0 if poisoned else 0.0
    kind[1], poison[1] = 0, True              # a poisoned anti term
    term[:, 1] = 0.0
    if poisoned:
        term[rng.integers(n), 1] = 1.0
    match = (rng.random((p, uq)) < 0.15).astype(np.float32)
    carry = (rng.random((p, ue)) < 0.05).astype(np.float32)
    slots = 4

    def ids(frac, lo_keys):
        q = np.where(rng.random((p, slots)) < frac, rng.integers(0, uq, (p, slots)), -1)
        return q.astype(np.int32), rng.choice(lo_keys, (p, slots)).astype(np.int32)

    paff_q, paff_tkey = ids(0.15, keys)
    panti_q, panti_tkey = ids(0.2, keys)
    ppref_q, ppref_tkey = ids(0.4, np.append(keys, -2))
    ppref_w = (rng.integers(1, 100, (p, slots)) * rng.choice([-1, 1], (p, slots))
               ).astype(np.float32)
    fail = rng.random(p) < 0.02

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return InterpodInputs(
        use_ipa=True, w_ip=1.0, hard_w=1.0, pod_matches_q=t(match),
        pod_carries_e=t(carry), paff_q=t(paff_q), paff_tkey=t(paff_tkey),
        panti_q=t(panti_q), panti_tkey=t(panti_tkey), ppref_q=t(ppref_q),
        ppref_tkey=t(ppref_tkey), ppref_w=t(ppref_w), ipaff_fail=t(fail),
        podsel_count=t(podsel), term_count=t(term), topology=t(topo),
        term_q=t(term_q), term_tkey=t(tkey), term_kind=t(kind),
        term_weight=t(weight), term_poison=t(poison), domain_universe=64)


def interpod_hazard_inputs(torch, rng, dev, n, p, k, pool):
    """A batch that drives the interpod build's per-pod order, p pods on n
    nodes with k topology slots. `pool` picks the statically feasible
    nodes: "one_node" (every pod on one node), "one_thread" (the nodes of
    two neighbouring threads and one other node, so the scan's owners see
    their own nodes' counts pod after pod) or "wide" (four fifths of the
    nodes). Topology ids of slots 1..k-1 include -1 and ids past the
    universe. Pods come in runs: "quiet" runs match only columns that no
    weighted term reads and have no preferred terms (their priority does
    not count), some with zero rows (nothing broadcast), between "loud"
    runs that count. Among the carried terms: a required anti term on the
    hostname and one on the zone whose carriers arrive in the batch, one
    with an empty key and one poisoned, each first carried by a pod late in
    the batch; the pods' own terms: hostname anti-affinity against the
    hostname group, and zone affinity to a selector no pod matches at
    batch start, which the first such pod matches itself (the first-pod
    escape); preferred terms on every key, the default-domain union
    included. Returns (the scan's arguments, InterpodInputs)."""
    from kubernetes_tpu_torch.ops.assign_scan import InterpodInputs, node_run

    uq = ue = 16
    nd = 64
    topo = np.full((n, k), -1, np.int32)
    topo[:, 0] = np.arange(n)
    for slot, hi in ((1, 3), (2, 2), (3, 6), (4, 12)) + tuple(
            (s, 10) for s in range(5, k)):
        if slot >= k:
            break
        ids = rng.integers(0, hi, n)
        ids[rng.random(n) < 0.2] = -1
        past = rng.random(n) < 0.05
        ids[past] = rng.integers(nd, nd + 8, int(past.sum()))
        topo[:, slot] = ids
    podsel = np.zeros((n, uq), np.float32)
    podsel[:, :8] = rng.integers(0, 3, (n, 8)) * (rng.random((n, 8)) < 0.2)
    term = np.zeros((n, ue), np.float32)
    # columns 0-7 are read by weighted terms, 8-15 by required ones only
    term_q = np.array([8, 12, 9, 10, 0, 1, 2, 3, 4, 5, 6, 7, 0, 1, -1, -1], np.int32)
    kind = np.array([0, 0, 0, 0, 1, 2, 3, 2, 3, 2, 2, 3, 2, 3, 2, 2], np.int32)
    last = k - 1
    tkey = np.array([-1, 0, 0, 1, 0, 1, 0, -2, last, 2, -2, 1, last, 2, 0, 0],
                    np.int32)
    weight = np.array([0, 0, 0, 0, 0, 7, -5, 11, -3, 2, 4, -9, 6, -1, 0, 0],
                      np.float32)
    poison = np.zeros(ue, bool)
    poison[1] = True
    term[:, 4:14] = rng.integers(0, 2, (n, 10)) * (rng.random((n, 10)) < 0.1)
    run = node_run(n)
    if pool == "one_node":
        feasible = np.array([int(rng.integers(0, n))])
    elif pool == "one_thread":
        first = 2 * run * int(rng.integers(0, n // (2 * run)))
        feasible = np.r_[np.arange(first, min(first + 2 * run, n)),
                         rng.integers(0, n, 1)]
    else:
        feasible = np.flatnonzero(rng.random(n) < 0.8)
    ms = np.full((p, n), -np.inf, np.float32)
    ms[:, feasible] = np.where(rng.random((p, feasible.size)) < 0.1, 20.0, 100020.0)
    alloc = np.zeros((n, 6), np.float32)
    alloc[:, 0], alloc[:, 1], alloc[:, 2] = 400, 64000, 262144
    requested = np.zeros((n, 6), np.float32)
    nonzero = np.full((n, 2), 100.0, np.float32)
    reqs = np.zeros((p, 6), np.float32)
    reqs[:, 0], reqs[:, 1], reqs[:, 2] = 1, 100, 128
    nz_reqs = np.tile(np.float32([100, 128]), (p, 1))

    runs = np.cumsum(rng.random(p) < 0.4)
    loud = (rng.random(runs[-1] + 1) < 0.5)[runs]
    zero = ~loud & (rng.random(runs[-1] + 1) < 0.5)[runs]
    match = np.zeros((p, uq), np.float32)
    carry = np.zeros((p, ue), np.float32)
    match[:, 8:] = rng.random((p, 8)) < 0.3
    match[loud, :8] = rng.random((int(loud.sum()), 8)) < 0.4
    carry[:, 4:14] = (rng.random((p, 10)) < 0.1) & loud[:, None]
    hostname_group = rng.random(p) < 0.4     # match q9 and carry e2
    match[hostname_group, 9] = 1.0
    carry[hostname_group, 2] = 1.0
    carry[rng.random(p) < 0.1, 3] = 1.0      # the zone anti term's carriers
    match[zero] = 0.0
    carry[zero] = 0.0
    carry[int(0.6 * p), 0] = 1.0             # the empty-key anti term's carrier
    carry[int(0.85 * p), 1] = 1.0            # the poisoned term's carrier
    slots = 4
    paff_q = np.full((p, slots), -1, np.int32)
    paff_tkey = np.zeros((p, slots), np.int32)
    panti_q = np.full((p, slots), -1, np.int32)
    panti_tkey = np.zeros((p, slots), np.int32)
    ppref_q = np.full((p, slots), -1, np.int32)
    ppref_tkey = np.zeros((p, slots), np.int32)
    ppref_w = np.zeros((p, slots), np.float32)
    # zone affinity to selector 11 (matched by no node at batch start): the
    # first such pod matches it itself and escapes, the others follow it
    escape = np.flatnonzero(rng.random(p) < 0.15)
    paff_q[escape, 0], paff_tkey[escape, 0] = 11, 1
    match[:, 11] = 0.0
    match[escape[:1], 11] = 1.0
    anti = np.flatnonzero(rng.random(p) < 0.2)
    panti_q[anti, 1], panti_tkey[anti, 1] = 9, 0
    keys = np.array([0, 1, 2, -2, last])
    for s_ in range(slots):
        on = loud & (rng.random(p) < 0.5)
        ppref_q[on, s_] = rng.integers(0, 8, int(on.sum()))
        ppref_tkey[on, s_] = rng.choice(keys, int(on.sum()))
        ppref_w[on, s_] = (rng.integers(1, 50, int(on.sum()))
                           * rng.choice([-1, 1], int(on.sum())))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    args = (t(ms), t(reqs), t(nz_reqs), t(alloc), t(requested), t(nonzero), 2**32 - 7)
    return args, InterpodInputs(
        use_ipa=True, w_ip=1.0, hard_w=1.0, pod_matches_q=t(match),
        pod_carries_e=t(carry), paff_q=t(paff_q), paff_tkey=t(paff_tkey),
        panti_q=t(panti_q), panti_tkey=t(panti_tkey), ppref_q=t(ppref_q),
        ppref_tkey=t(ppref_tkey), ppref_w=t(ppref_w),
        ipaff_fail=t(np.zeros(p, bool)), podsel_count=t(podsel),
        term_count=t(term), topology=t(topo), term_q=t(term_q),
        term_tkey=t(tkey), term_kind=t(kind), term_weight=t(weight),
        term_poison=t(poison), domain_universe=nd)


def interpod_entries(torch, ip):
    """(count entries i64[P], priority counts bool[P]) of each pod: the
    carried terms whose required anti-affinity or symmetric weight applies
    to it, and its own terms in use (the kernel's list, csrc header)."""
    q = ip.term_q.long().clamp(min=0)
    match_e = torch.where(ip.term_q >= 0, ip.pod_matches_q[:, q], 0.0)
    keyed = ip.term_tkey != -1
    anti = (ip.term_kind == 0) & (match_e > 0) & keyed
    eff = ip.term_weight + ip.hard_w * (ip.term_kind == 1).float()
    sym = (match_e * eff != 0) & keyed
    pref = (ip.ppref_q >= 0) & (ip.ppref_w != 0)
    entries = (anti.sum(1) + sym.sum(1) + (ip.paff_q >= 0).sum(1)
               + (ip.panti_q >= 0).sum(1) + pref.sum(1))
    return entries, sym.any(1) | pref.any(1)


def interpod_bound(torch, scan_args, ip) -> tuple[float, str]:
    """scan_bound's bytes plus the per-pod rows, the topology, the term
    attributes and the domain aggregates read once, and the node-level
    ledgers read once and written once; its operations plus, per
    statically feasible (pod, node) pair, IP_OPS_PER_ENTRY per count
    entry of the pod and IP_SCORE_OPS when the pod's priority counts."""
    from kubernetes_tpu_torch.ops.interpod import make_ledger

    masked = scan_args[0]
    t_bytes, _ = scan_bound(*scan_args[:6])
    ledger = make_ledger(ip.podsel_count, ip.term_count, ip.topology,
                         ip.domain_universe)
    rows = [getattr(ip, f) for f in ("pod_matches_q", "pod_carries_e", "paff_q",
                                     "paff_tkey", "panti_q", "panti_tkey",
                                     "ppref_q", "ppref_tkey", "ppref_w",
                                     "ipaff_fail", "topology", "term_q",
                                     "term_tkey", "term_kind", "term_weight",
                                     "term_poison")]
    nbytes = (t_bytes * 1e-3 * H100_BYTES_PER_S
              + sum(a.numel() * a.element_size() for a in rows)
              + 4 * (ledger.dom_podsel.numel() + ledger.dom_term.numel())
              + 2 * 4 * (ip.podsel_count.numel() + ip.term_count.numel()))
    feasible = (masked > float("-inf")).sum(1).double()
    entries, counting = interpod_entries(torch, ip)
    ops = (SCAN_OPS_PER_PAIR * float(feasible.sum())
           + IP_OPS_PER_ENTRY * float((feasible * entries.double()).sum())
           + IP_SCORE_OPS * float(feasible[counting].sum()))
    return bound(nbytes, ops)


def interpod_first_batch(torch, dev):
    """bench[interpod]'s first batch, encoded through a Scheduler's table
    on its flushed state, and the interpod build's arguments for it:
    (caps, the scan arguments, InterpodInputs)."""
    from kubernetes_tpu_torch.ops import solver
    from kubernetes_tpu_torch.perf.fixtures import make_nodes, make_pods
    from kubernetes_tpu_torch.perf.harness import default_caps
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.state.convert import batch_from_numpy
    from kubernetes_tpu_torch.state.pod_batch import encode_pods

    caps = default_caps(INTERPOD_NODES, INTERPOD_PODS)
    sched = Scheduler(caps, device=dev)
    sched.add_nodes(make_nodes(INTERPOD_NODES, zones=3))
    pods = make_pods(INTERPOD_PODS, **INTERPOD_MIX)[:caps.batch_pods]
    host = encode_pods(pods, caps, sched.statedb.table)
    state = sched.statedb.flush()
    batch = batch_from_numpy(host, dev)
    g = solver.check_supported(solver.DEFAULT_POLICY, solver.batch_flags(state, batch))
    masked = solver.masked_static_scores(state, batch, solver.DEFAULT_POLICY, g)
    args = (masked, batch.requests, batch.nonzero_requests, state.allocatable,
            state.requested, state.nonzero_requested, 0, float(g.w_lr),
            float(g.w_ba))
    return caps, args, solver.interpod_inputs(state, batch, g, caps.domain_universe)


def interpod_phase(torch, caps, dev, kernels) -> tuple[dict, dict]:
    """bench[interpod] through Scheduler(device="cuda"), the first and a
    later batch held against the plain path on the state and batch the
    driver solved them on, the anti-affinity checked on the placements,
    and the interpod build timed on the first batch. Returns (the phase
    line, the kernels-line entry)."""
    from kubernetes_tpu_torch.ops import solver
    from kubernetes_tpu_torch.ops.assign_scan import (
        assign_scan_interpod,
        assign_scan_interpod_plain,
    )
    from kubernetes_tpu_torch.perf.fixtures import make_nodes, make_pods
    from kubernetes_tpu_torch.perf.harness import measure, warm
    from kubernetes_tpu_torch.scheduler import Scheduler, driver
    from kubernetes_tpu_torch.state.pod_batch import encode_pods

    nodes = make_nodes(INTERPOD_NODES, zones=3)
    pods = make_pods(INTERPOD_PODS, **INTERPOD_MIX)
    warm(caps, solver.DEFAULT_POLICY, dev, pod_kwargs=INTERPOD_MIX)
    sched = Scheduler(caps, device=dev)
    sched.add_nodes(nodes)
    seen = []
    solve = record_solves(torch, driver, INTERPOD_CHECKED, seen)
    for k in kernels:
        k.launches = 0
    try:
        result = measure(sched, pods)
    finally:
        driver.schedule_batch = solve
    launches = {k.__name__: k.launches for k in kernels}
    if result.scheduled != INTERPOD_PODS:
        raise AssertionError(f"interpod: placed {result.scheduled}/{INTERPOD_PODS}")
    if launches != {"static_mask": result.batches, "assign_scan": 0,
                    "assign_scan_spread": 0,
                    "assign_scan_interpod": result.batches,
                    "assign_scan_spread_interpod": 0}:
        raise AssertionError(f"interpod: launches {launches} over "
                             f"{result.batches} batches")
    load = check_load(pods, result.placements, nodes)
    # required hostname anti-affinity against the pod's own group: a node
    # that holds an anti-affinity pod holds no other pod of that group
    group_on: dict = {}
    anti_nodes = set()
    for i, p in enumerate(pods):
        node = result.placements[p.key]
        app = p.metadata.labels["app"]
        group_on[(node, app)] = group_on.get((node, app), 0) + 1
        if i % INTERPOD_MIX["anti_affinity_every"] == 0:
            anti_nodes.add((node, app))
    crowded = [key for key in anti_nodes if group_on[key] != 1]
    if crowded:
        raise AssertionError(f"interpod: anti-affinity broken on {crowded[:5]}")
    for k in INTERPOD_CHECKED:
        (state, batch, rr, flags), got = seen[k]
        if k != INTERPOD_CHECKED[0]:
            # a later batch on its first GSI_SCOPE pods, the kernel path run
            # again on them (the plain interpod loop takes ~16-22 s a batch)
            batch = scope_batch(batch, GSI_SCOPE)
            got = solver.schedule_batch(state, batch, rr, solver.DEFAULT_POLICY, flags,
                                        caps, spread_zones=sched.statedb.table.spread_zones)
        plain = solver.schedule_batch_plain(state, batch, rr, solver.DEFAULT_POLICY,
                                            flags, caps)
        compare_interpod(torch, got, plain)
    # the driver's first batch equals the fresh encoding of its pods
    fresh = Scheduler(caps, device=dev)
    fresh.add_nodes(nodes)
    host = encode_pods(pods[:caps.batch_pods], caps, fresh.statedb.table)
    first = seen[0][0][1]
    for name in ("pod_matches_q", "pod_carries_e", "paff_q", "panti_q",
                 "panti_tkey", "ppref_q", "ppref_tkey", "ppref_w"):
        want = torch.from_numpy(np.ascontiguousarray(getattr(host, name))).to(dev)
        if not torch.equal(getattr(first, name), want.to(getattr(first, name).dtype)):
            raise AssertionError(f"interpod: the driver's first batch != the "
                                 f"fresh encoding on {name}")

    state0, batch0, _rr, flags0 = seen[0][0]
    g = solver.check_supported(solver.DEFAULT_POLICY, flags0)
    masked = solver.masked_static_scores(state0, batch0, solver.DEFAULT_POLICY, g)
    args = (masked, batch0.requests, batch0.nonzero_requests, state0.allocatable,
            state0.requested, state0.nonzero_requested, 0, float(g.w_lr),
            float(g.w_ba))
    ip = solver.interpod_inputs(state0, batch0, g, caps.domain_universe)
    plain, plain_ms = timed_call(torch, lambda: assign_scan_interpod_plain(*args, ip))
    err = compare_interpod(torch, assign_scan_interpod(*args, ip), plain)
    entries, counting = interpod_entries(torch, ip)
    entry = {
        "name": "assign_scan_interpod", "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/assign_scan.cu",
        "replaces": "kubernetes_tpu/ops/interpod.py:152",
        "launches": launches["assign_scan_interpod"], "max_abs_err": err,
        **timed(torch, lambda: assign_scan_interpod(*args, ip), reps=5),
        "plain_ms": plain_ms,
        "library_ms": None,
    }
    entry["bound_ms"], entry["bound_by"] = interpod_bound(torch, args, ip)
    encode_ms = 1e3 * sum(sched.encode_seconds)
    solve_ms = 1e3 * sum(sched.solve_seconds)
    line = {"phase": "interpod", "nodes": INTERPOD_NODES, "pods": INTERPOD_PODS,
            **INTERPOD_MIX, "caps": [caps.num_nodes, caps.batch_pods],
            **run_fields(result), "encode_ms": encode_ms, "solve_ms": solve_ms,
            "remainder_ms": 1e3 * result.seconds - encode_ms - solve_ms,
            "podsel_entries": len(sched.statedb.table.podsels),
            "carried_terms": len(sched.statedb.table.terms),
            "nodes_used": len(load), "anti_affinity_nodes": len(anti_nodes),
            "first_batch_entries_mean": float(entries.double().mean()),
            "first_batch_counting_pods": int(counting.sum()),
            "launches": launches,
            "checked_batches_equal_plain": list(INTERPOD_CHECKED),
            "later_batch_scope_pods": GSI_SCOPE}
    return line, entry


def with_spread(torch, rng, ip, zones, no_entry=0.33):
    """SelectorSpread over an InterpodInputs' ledger: the GetZoneKey slot
    (TOPO_SPREAD_ZONE) holds `zones` zones (ids below it; a fifth of the
    nodes without one and a twentieth past the universe), and pods take
    spread entries in runs, a share `no_entry` of the runs none (-1), so
    pods raise both gates, one of them or neither. Returns (SpreadInputs,
    InterpodInputs) that share the ledger, topology and match rows."""
    from kubernetes_tpu_torch.ops.assign_scan import SpreadInputs
    from kubernetes_tpu_torch.state.layout import TOPO_SPREAD_ZONE

    n, uq = ip.podsel_count.shape
    p = ip.pod_matches_q.shape[0]
    nd = ip.domain_universe
    zone = rng.integers(0, zones, n) if zones else np.full(n, -1)
    zone[rng.random(n) < 0.2] = -1
    past = rng.random(n) < 0.05
    zone[past] = rng.integers(nd, nd + 8, int(past.sum()))
    topo = ip.topology.clone()
    topo[:, TOPO_SPREAD_ZONE] = torch.from_numpy(zone.astype(np.int32)).to(topo.device)
    runs = np.cumsum(rng.random(p) < 0.3)
    q = rng.integers(0, uq, runs[-1] + 1)[runs].astype(np.int32)
    q[(rng.random(runs[-1] + 1) < no_entry)[runs]] = -1
    ip = dataclasses.replace(ip, topology=topo)
    return SpreadInputs(w_ss=1.0, spread_q=torch.from_numpy(q).to(topo.device),
                        pod_matches_q=ip.pod_matches_q, podsel_count=ip.podsel_count,
                        topology=topo, domain_universe=nd, zones=zones), ip


def spread_interpod_hazard_inputs(torch, rng, dev, n, p, k, pool, zones, mode=""):
    """interpod_hazard_inputs' batch (`pool`, k topology slots) with
    SelectorSpread over the same ledger (`with_spread`, `zones` zones).
    `mode` adds a hazard:
    - "reject" (pool "wide"): every pod with an entry takes entry 14, and
      the pods' required hostname anti-affinity (selector 15, which no pod
      matches) rejects two statically feasible nodes: one without a count
      of entry 14, which SelectorSpread scores highest and which every
      pod's static score puts at the top, and one that holds the most,
      which would set the maximum count if SelectorSpread counted before
      the predicate;
    - "alternate": pods cycle spread only (an entry, no weighted count
      entry), interpod only (no entry, a preferred zone term) and both, so
      the combined message's size changes every pod;
    - "bound" (4 zones or fewer): every pod takes entry 3, and the first
      two warps of block 0 hold nodes of zone 0 that every pod may take,
      each with 2^16 / (32 RUN) - 1 counts of entry 3, the largest max
      count whose zone sums the build reduces in packed 16-bit fields (a
      field of 2^16 - 32 RUN), one node of the second warp with one more,
      which the build reduces zone by zone; placements add to both.
    Returns (the scan's arguments, SpreadInputs, InterpodInputs)."""
    from kubernetes_tpu_torch.ops.assign_scan import node_run
    from kubernetes_tpu_torch.state.layout import TOPO_SPREAD_ZONE

    args, ip = interpod_hazard_inputs(torch, rng, dev, n, p, k, pool)
    spread, ip = with_spread(torch, rng, ip, zones)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    if mode == "reject":
        q = spread.spread_q.cpu().numpy()
        q[q >= 0] = 14
        ms = args[0].cpu().numpy()
        feasible = np.flatnonzero(np.isfinite(ms[0]))
        x, y = rng.choice(feasible, 2, replace=False)
        ms[:, x] = 100020.0
        podsel = ip.podsel_count.cpu().numpy()
        podsel[feasible, 14] = rng.integers(1, 6, feasible.size)
        podsel[x, 14], podsel[y, 14] = 0.0, 50.0
        podsel[:, 15] = 0.0
        podsel[[x, y], 15] = 1.0
        match = ip.pod_matches_q.cpu().numpy()
        match[:, 15] = 0.0
        match[q >= 0, 14] = 1.0
        panti_q, panti_tkey = ip.panti_q.cpu().numpy(), ip.panti_tkey.cpu().numpy()
        panti_q[:, 2], panti_tkey[:, 2] = 15, 0
        args = (t(ms), *args[1:])
        ip = dataclasses.replace(ip, podsel_count=t(podsel), pod_matches_q=t(match),
                                 panti_q=t(panti_q), panti_tkey=t(panti_tkey))
        spread = dataclasses.replace(spread, spread_q=t(q), podsel_count=ip.podsel_count,
                                     pod_matches_q=ip.pod_matches_q)
    elif mode == "alternate":
        # the weighted terms read selectors 0-7: a pod that matches none of
        # them and prefers nothing has no priority to count
        kind = np.arange(p) % 3            # 0 spread only, 1 interpod only, 2 both
        q = spread.spread_q.cpu().numpy()
        q[kind == 1] = -1
        q[kind != 1] = rng.integers(0, 8, int((kind != 1).sum()))
        match = ip.pod_matches_q.cpu().numpy()
        match[kind == 0, :8] = 0.0
        ppref_q, ppref_tkey = ip.ppref_q.cpu().numpy(), ip.ppref_tkey.cpu().numpy()
        ppref_w = ip.ppref_w.cpu().numpy()
        ppref_q[kind == 0] = -1
        counting = kind != 0
        ppref_q[counting, 0] = rng.integers(0, 8, int(counting.sum()))
        ppref_tkey[counting, 0] = 1
        ppref_w[counting, 0] = 5.0
        ip = dataclasses.replace(ip, pod_matches_q=t(match), ppref_q=t(ppref_q),
                                 ppref_tkey=t(ppref_tkey), ppref_w=t(ppref_w))
        spread = dataclasses.replace(spread, spread_q=t(q), pod_matches_q=ip.pod_matches_q)
    elif mode == "bound":
        if zones > 4:
            raise ValueError("the packed zone sums take 4 zones or fewer")
        warp = 32 * node_run(n)
        top = (1 << 16) // warp - 1
        q = np.full(p, 3, np.int32)
        ms = args[0].cpu().numpy()
        podsel = ip.podsel_count.cpu().numpy()
        topo = ip.topology.cpu().numpy()
        for w in (0, 1):
            nodes = np.arange(w * warp, min((w + 1) * warp, n))
            ms[:, nodes] = 100020.0
            topo[nodes, TOPO_SPREAD_ZONE] = 0
            podsel[nodes, 3] = top
        podsel[min(2 * warp, n) - 1, 3] = top + 1
        args = (t(ms), *args[1:])
        ip = dataclasses.replace(ip, podsel_count=t(podsel), topology=t(topo))
        spread = dataclasses.replace(spread, spread_q=t(q), podsel_count=ip.podsel_count,
                                     topology=ip.topology)
    elif mode:
        raise ValueError(f"unknown hazard {mode!r}")
    return args, spread, ip


def spread_interpod_hazards_phase(torch, rng, dev, shapes) -> dict:
    """The spread+interpod build's hazards at each (pods, nodes) of
    `shapes`: runs of pods placed on one node and on one thread's nodes
    (the match row added once, the count column patched a pod ahead), pods
    with both gates, one of them or neither (spread_q -1, no weighted
    entry: the message's size moves pod to pod), 0, 1, 3, 4 and 64 zones
    (the zone sums in packed fields up to 4, zone by zone past it), domain
    ids -1 and past the universe, a required anti term that rejects the
    node SelectorSpread scores highest and the one with the most counts,
    pods cycling spread only, interpod only and both, and warp totals at
    the packed fields' bound (spread_interpod_hazard_inputs); the 4- and
    64-zone, cycling and bound batches also with the normalization flag
    (norm_test_inputs). Returns the phase line."""
    from kubernetes_tpu_torch.ops.assign_scan import (
        assign_scan_spread_interpod,
        assign_scan_spread_interpod_plain,
        node_run,
    )

    cases = (("one_node", 8, 3, ""), ("one_thread", 5, 1, ""), ("wide", 16, 0, ""),
             ("wide", 8, 3, "reject"), ("wide", 8, 4, ""), ("wide", 8, 64, ""),
             ("wide", 8, 3, "alternate"), ("wide", 8, 4, "bound"))

    def with_flag(zones, mode):
        return mode in ("alternate", "bound") or zones in (4, 64)

    for p_, n_ in shapes:
        for pool, k_, zones_, mode in cases:
            hargs, sp_, ip_ = spread_interpod_hazard_inputs(
                torch, rng, dev, n_, p_, k_, pool, zones_, mode)
            variants = [()]
            if with_flag(zones_, mode):
                ms_, norm_ = norm_test_inputs(torch, rng, dev, hargs[0])
                hargs = (ms_, *hargs[1:])
                variants.append((norm_,))
            for v in variants:
                compare_interpod(
                    torch, assign_scan_spread_interpod(*hargs, 1.0, 1.0, sp_, ip_, *v),
                    assign_scan_spread_interpod_plain(*hargs, 1.0, 1.0, sp_, ip_, *v),
                    "spread_interpod")
    return {"phase": "spread_interpod_hazards", "shapes": [list(x) for x in shapes],
            "runs": sorted({node_run(n_) for _, n_ in shapes}),
            "cases": [f"{pool}_k{k_}_z{z_}" + (f"_{m_}" if m_ else "")
                      + ("_and_flag" if with_flag(z_, m_) else "")
                      for pool, k_, z_, m_ in cases],
            "kernel_equals_plain": True}


def spread_interpod_bound(torch, scan_args, spread, ip) -> tuple[float, str]:
    """interpod_bound's bytes (the [UQ + UE, N] ledger read and written
    once, the per-pod rows, topology, term attributes and domain
    aggregates read once) plus the spread entries and the zone column read
    once; its operations plus SPREAD_OPS_PER_PAIR per statically feasible
    pair of a pod with an entry."""
    t_ip, _ = interpod_bound(torch, scan_args, ip)
    feasible = scan_args[0] > float("-inf")
    entries, counting = interpod_entries(torch, ip)
    per_pod = feasible.sum(1).double()
    ops = (SCAN_OPS_PER_PAIR * float(per_pod.sum())
           + IP_OPS_PER_ENTRY * float((per_pod * entries.double()).sum())
           + IP_SCORE_OPS * float(per_pod[counting].sum())
           + SPREAD_OPS_PER_PAIR * float(per_pod[spread.spread_q >= 0].sum()))
    nbytes = (t_ip * 1e-3 * H100_BYTES_PER_S + spread.spread_q.numel() * 4
              + scan_args[0].shape[1] * 4)
    return bound(nbytes, ops)


def spread_interpod_first_batch(torch, dev):
    """The spread_interpod cell's first batch, encoded through a
    Scheduler's table and encode context on its flushed state, and the
    scan's arguments for it: (caps, the scan arguments, SpreadInputs,
    InterpodInputs), the two sharing the ledger and match rows."""
    from kubernetes_tpu_torch.ops import solver
    from kubernetes_tpu_torch.perf.fixtures import make_nodes, make_pods, make_services
    from kubernetes_tpu_torch.perf.harness import default_caps
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.state.convert import batch_from_numpy
    from kubernetes_tpu_torch.state.pod_batch import encode_pods

    caps = default_caps(HEADLINE_NODES, HEADLINE_PODS)
    sched = Scheduler(caps, device=dev)
    sched.add_nodes(make_nodes(HEADLINE_NODES, zones=3))
    for svc in make_services(SPREAD_GROUPS):
        sched.add_service(svc)
    pods = make_pods(HEADLINE_PODS, **SI_MIX)[:caps.batch_pods]
    host = encode_pods(pods, caps, sched.statedb.table, ctx=sched.encode_cache.ctx)
    state = sched.statedb.flush()
    batch = batch_from_numpy(host, dev)
    g = solver.check_supported(solver.DEFAULT_POLICY, solver.batch_flags(state, batch))
    masked = solver.masked_static_scores(state, batch, solver.DEFAULT_POLICY, g)
    args = (masked, batch.requests, batch.nonzero_requests, state.allocatable,
            state.requested, state.nonzero_requested, 0, float(g.w_lr),
            float(g.w_ba))
    return (caps, args, *solver.spread_interpod_inputs(
        state, batch, g, caps.domain_universe, sched.statedb.table.spread_zones))


def gang_spread_interpod_first_batch(torch, dev, revert_every: int = 0):
    """The gang_spread_interpod cell's first batch as the driver builds it
    (its groups whole, the gang columns written after encoding), encoded
    through a Scheduler's table and encode context on its flushed state,
    and the scan's arguments for it: (caps, the scan arguments,
    SpreadInputs, InterpodInputs, GangInputs). With `revert_every`, the
    first member of every revert_every-th group asks 5 CPUs, which no node
    fits, so those groups revert."""
    from kubernetes_tpu_torch.ops import solver
    from kubernetes_tpu_torch.ops.assign_scan import GangInputs
    from kubernetes_tpu_torch.perf.fixtures import make_nodes, make_pods, make_services
    from kubernetes_tpu_torch.perf.harness import GANG_SPREAD_INTERPOD_PODS, default_caps
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.state.convert import batch_from_numpy
    from kubernetes_tpu_torch.state.pod_batch import encode_pods

    caps = default_caps(HEADLINE_NODES, GSI_PODS)
    sched = Scheduler(caps, device=dev)
    sched.add_nodes(make_nodes(HEADLINE_NODES, zones=3))
    for svc in make_services(SPREAD_GROUPS):
        sched.add_service(svc)
    pods = make_pods(GSI_PODS, **GANG_SPREAD_INTERPOD_PODS)
    chunk, gang_id, gang_min = next(sched._gang_batches(pods))
    host = encode_pods(chunk, caps, sched.statedb.table, ctx=sched.encode_cache.ctx)
    host.gang_id[:len(chunk)] = gang_id
    host.gang_min[:len(chunk)] = gang_min
    if revert_every:
        rows = np.arange(0, len(chunk), revert_every * GANG_SIZE)
        host.requests[rows, 1] = 5000.0
        host.nonzero_requests[rows, 0] = 5000.0
    state = sched.statedb.flush()
    batch = batch_from_numpy(host, dev)
    g = solver.check_supported(solver.DEFAULT_POLICY, solver.batch_flags(state, batch))
    masked = solver.masked_static_scores(state, batch, solver.DEFAULT_POLICY, g)
    args = (masked, batch.requests, batch.nonzero_requests, state.allocatable,
            state.requested, state.nonzero_requested, 0, float(g.w_lr),
            float(g.w_ba))
    sp, ip = solver.spread_interpod_inputs(state, batch, g, caps.domain_universe,
                                           sched.statedb.table.spread_zones)
    return caps, args, sp, ip, GangInputs(gang_id=batch.gang_id.contiguous(),
                                          gang_min=batch.gang_min.contiguous())


def spread_interpod_phase(torch, caps, dev, kernels) -> tuple[dict, dict]:
    """The spread_interpod cell (bench[spread]'s 15,000 nodes in 3 zones,
    30,000 pods in 16 app groups and 16 Services, with bench[interpod]'s
    terms) through Scheduler(device="cuda"); every pod must be placed
    within allocatable, no node that holds an anti-affinity pod may hold
    another pod of its group, the spread+interpod build must have launched
    once per batch (and no other build of the scan), and the first batch,
    and the last batch's first GSI_SCOPE pods, must equal
    schedule_batch_plain on the state and batch the driver solved them on,
    every ledger included; the build is timed on the first batch, against
    the plain path's time on that batch. Returns (the phase line, the
    kernels-line entry)."""
    from kubernetes_tpu_torch.ops import solver
    from kubernetes_tpu_torch.ops.assign_scan import assign_scan_spread_interpod
    from kubernetes_tpu_torch.perf.fixtures import make_nodes, make_pods, make_services
    from kubernetes_tpu_torch.perf.harness import measure, warm
    from kubernetes_tpu_torch.scheduler import Scheduler, driver

    nodes = make_nodes(HEADLINE_NODES, zones=3)
    pods = make_pods(HEADLINE_PODS, **SI_MIX)
    services = make_services(SPREAD_GROUPS)
    warm(caps, solver.DEFAULT_POLICY, dev, n_services=SPREAD_GROUPS, pod_kwargs=SI_MIX)
    sched = Scheduler(caps, device=dev)
    sched.add_nodes(nodes)
    for svc in services:
        sched.add_service(svc)
    seen = []
    solve = record_solves(torch, driver, SI_CHECKED, seen)
    for k in kernels:
        k.launches = 0
    try:
        result = measure(sched, pods)
    finally:
        driver.schedule_batch = solve
    launches = {k.__name__: k.launches for k in kernels}
    if result.scheduled != HEADLINE_PODS:
        raise AssertionError(f"spread_interpod: placed {result.scheduled}/{HEADLINE_PODS}")
    want = {name: 0 for name in launches}
    want.update(static_mask=result.batches, assign_scan_spread_interpod=result.batches)
    if launches != want or result.batches != len(seen):
        raise AssertionError(f"spread_interpod: launches {launches} over "
                             f"{result.batches} batches")
    load = check_load(pods, result.placements, nodes)
    # required hostname anti-affinity against the pod's own group
    group_on: dict = {}
    anti_nodes = set()
    for i, p in enumerate(pods):
        key = (result.placements[p.key], p.metadata.labels["app"])
        group_on[key] = group_on.get(key, 0) + 1
        if i % SI_MIX["anti_affinity_every"] == 0:
            anti_nodes.add(key)
    crowded = [key for key in anti_nodes if group_on[key] != 1]
    if crowded:
        raise AssertionError(f"spread_interpod: anti-affinity broken on {crowded[:5]}")
    names = sched.statedb.table.name_of
    if [names[r] for r in seen[0][1].assignments.tolist()] != \
            [result.placements[p.key] for p in pods[:caps.batch_pods]]:
        raise AssertionError("spread_interpod: first batch placements != its result")
    plains = {}
    for k in SI_CHECKED:
        (state, batch, rr, flags), got = seen[k]
        if k != SI_CHECKED[0]:
            # a later batch on its first GSI_SCOPE pods, the kernel path run
            # again on them (the plain loop takes ~56 s a whole batch)
            batch = scope_batch(batch, GSI_SCOPE)
            got = solver.schedule_batch(state, batch, rr, solver.DEFAULT_POLICY, flags,
                                        caps, spread_zones=sched.statedb.table.spread_zones)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        plain = solver.schedule_batch_plain(state, batch, rr, solver.DEFAULT_POLICY,
                                            flags, caps)
        end.record()
        end.synchronize()
        compare_interpod(torch, got, plain, "spread_interpod")
        plains[k] = (plain, start.elapsed_time(end))
    # the build alone on the first batch, against the plain scan's result
    state0, batch0, _rr, flags0 = seen[0][0]
    g = solver.check_supported(solver.DEFAULT_POLICY, flags0)
    masked = solver.masked_static_scores(state0, batch0, solver.DEFAULT_POLICY, g)
    args = (masked, batch0.requests, batch0.nonzero_requests, state0.allocatable,
            state0.requested, state0.nonzero_requested, 0, float(g.w_lr),
            float(g.w_ba))
    spread, ip = solver.spread_interpod_inputs(state0, batch0, g, caps.domain_universe,
                                               sched.statedb.table.spread_zones)
    if not (g.w_ss and g.use_terms) or _rr != 0:
        raise AssertionError(f"spread_interpod: first batch gates {flags0}, rr {_rr}")
    # the plain path's result on the first batch (rr 0)
    plain, plain_ms = plains[0]
    err = compare_interpod(torch, assign_scan_spread_interpod(*args, spread, ip), plain,
                           "spread_interpod")
    entries, counting = interpod_entries(torch, ip)
    entry = {
        "name": "assign_scan_spread_interpod", "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/assign_scan.cu",
        "replaces": "kubernetes_tpu/ops/solver.py:574",
        "launches": launches["assign_scan_spread_interpod"], "max_abs_err": err,
        **timed(torch, lambda: assign_scan_spread_interpod(*args, spread, ip), reps=5),
        "plain_ms": plain_ms, "library_ms": None,
    }
    entry["bound_ms"], entry["bound_by"] = spread_interpod_bound(torch, args, spread, ip)
    zone_of = {n.metadata.name: n.metadata.labels[
        "failure-domain.beta.kubernetes.io/zone"] for n in nodes}
    per_group: dict = {}
    for p in pods:
        key = (p.metadata.labels["app"], zone_of[result.placements[p.key]])
        per_group[key] = per_group.get(key, 0) + 1
    spread_of: dict = {}
    for (app, _z), c in per_group.items():
        spread_of.setdefault(app, []).append(c)
    encode_ms = 1e3 * sum(sched.encode_seconds)
    solve_ms = 1e3 * sum(sched.solve_seconds)
    line = {"phase": "spread_interpod", "nodes": HEADLINE_NODES, "pods": HEADLINE_PODS,
            "services": len(services), **SI_MIX,
            "caps": [caps.num_nodes, caps.batch_pods], **run_fields(result),
            "encode_ms": encode_ms, "solve_ms": solve_ms,
            "remainder_ms": 1e3 * result.seconds - encode_ms - solve_ms,
            "podsel_entries": len(sched.statedb.table.podsels),
            "carried_terms": len(sched.statedb.table.terms),
            "nodes_used": len(load), "anti_affinity_nodes": len(anti_nodes),
            "max_zone_imbalance_per_group": max(max(v) - min(v)
                                                for v in spread_of.values()),
            "first_batch_entries_mean": float(entries.double().mean()),
            "first_batch_counting_pods": int(counting.sum()),
            "first_batch_spread_pods": int((spread.spread_q >= 0).sum()),
            "launches": launches, "checked_batches_equal_plain": list(SI_CHECKED),
            "later_batch_scope_pods": GSI_SCOPE}
    return line, entry


def random_gang(torch, rng, dev, p):
    """Seeded GangInputs for p pods: runs of non-gang pods and groups of 1
    to 8 members with a random quorum, ids 1, 2, ... in order."""
    from kubernetes_tpu_torch.ops.assign_scan import GangInputs

    gid, gmin, k = [], [], 0
    while len(gid) < p:
        size = min(int(rng.integers(1, 9)), p - len(gid))
        if rng.random() < 0.7:
            k += 1
            gid += [k] * size
            gmin += [int(rng.integers(1, size + 1))] * size
        else:
            gid += [0] * size
            gmin += [0] * size

    def t(a):
        return torch.tensor(a, dtype=torch.int32, device=dev)

    return GangInputs(gang_id=t(gid), gang_min=t(gmin))


def revert_heavy_inputs(torch, rng, dev, n, p):
    """A seeded kernel-2 batch of p pods on n nodes built to revert: tight
    nodes (1 to 3 pods each); repeating blocks of a group of 8 at quorum 8,
    non-gang pods, a group of 8 at quorum 6 with 2 members that fit
    nowhere (placed), one at quorum 8 with 1 (reverted), one at quorum 6
    with 3 (reverted), and a group of 3 whose first two members fit one
    roomy node only and whose third fits nowhere (reverted: the node took
    two members); gpu and storage requests in the reverting groups; the
    last group ends on the last row. Returns (scan arguments, GangInputs)."""
    from kubernetes_tpu_torch.ops.assign_scan import GangInputs

    ms, reqs, nz, alloc, requested, nonzero, rr = scan_inputs(torch, rng, dev, p, n)
    alloc[:, 0] = torch.from_numpy(rng.integers(1, 4, n).astype(np.float32)).to(dev)
    requested[:, 0] = 0.0
    gid, gmin, k = [], [], 0
    nowhere, gpu = [], []

    def group(size, quorum, n_nowhere=0, heavy=False):
        nonlocal k
        k += 1
        start = len(gid)
        gid.extend([k] * size)
        gmin.extend([quorum] * size)
        nowhere.extend(range(start + size - n_nowhere, start + size))
        if heavy:
            gpu.extend(range(start, start + size))
        return start

    while len(gid) + 40 + 4 <= p:   # a block of 40 rows, and room for the tail
        group(8, 8)
        gid.extend([0, 0, 0])
        gmin.extend([0, 0, 0])
        group(8, 6, 2)
        group(8, 8, 1, heavy=True)
        gid.extend([0, 0])
        gmin.extend([0, 0])
        group(8, 6, 3, heavy=True)
        two = group(3, 3, 1)
        roomy = int(rng.integers(0, n))
        ms[two:two + 2] = float("-inf")
        ms[two:two + 2, roomy] = 100020.0
        alloc[roomy, :3] = torch.tensor([8.0, 8000.0, 16384.0], device=dev)
    tail = p - len(gid)   # the last group ends on the last row
    group(tail, tail, 1, heavy=True)
    ms[nowhere] = float("-inf")
    reqs[gpu, 3] = 1.0
    reqs[gpu[::2], 4] = 1024.0

    def t(a):
        return torch.tensor(a, dtype=torch.int32, device=dev)

    return ((ms, reqs, nz, alloc, requested, nonzero, rr),
            GangInputs(gang_id=t(gid), gang_min=t(gmin)))


def revert_one_node_inputs(torch, rng, dev, n, p):
    """A seeded kernel-2 batch of p pods on n nodes in blocks of 12 rows
    with one set of requests each (so the scan's term cache hits): a group
    of 8 at quorum 8 whose first 7 members fit one roomy node only and
    whose last fits nowhere (reverted after 7 members on one node), then 4
    non-gang pods that can take that node too. Returns (scan arguments,
    GangInputs)."""
    from kubernetes_tpu_torch.ops.assign_scan import GangInputs

    ms, reqs, nz, alloc, requested, nonzero, rr = scan_inputs(torch, rng, dev, p, n)
    gid = np.zeros(p, np.int32)
    gmin = np.zeros(p, np.int32)
    for k, b in enumerate(range(0, p - 11, 12)):
        roomy = int(rng.integers(0, n))
        alloc[roomy, :3] = torch.tensor([64.0, 64000.0, 262144.0], device=dev)
        ms[b:b + 8] = float("-inf")
        ms[b:b + 7, roomy] = 100020.0
        ms[b + 8:b + 12, roomy] = 100020.0
        reqs[b + 1:b + 12] = reqs[b]
        nz[b + 1:b + 12] = nz[b]
        gid[b:b + 8], gmin[b:b + 8] = k + 1, 8

    def t(a):
        return torch.from_numpy(a).to(dev)

    return ((ms, reqs, nz, alloc, requested, nonzero, rr),
            GangInputs(gang_id=t(gid), gang_min=t(gmin)))


def run8_phase(torch, rng, dev) -> dict:
    """The 8-node build's hazards (every build of the scan at 8 nodes a
    thread against its plain version): node counts with N % 4 = 1, 2 and 3
    (rows that start unaligned, and the row tail's 4-byte copies), one whose
    last blocks hold no node (40,000: blocks 10-15), pod counts that are not
    a multiple of the row ring's stages, an all-miss batch (the packed terms
    recomputed every pod), and revert-heavy gang batches, among them
    reverts after 7 members on one node with the term cache hitting around
    them. Returns the phase line."""
    from kubernetes_tpu_torch.ops import solver
    from kubernetes_tpu_torch.ops.assign_scan import (
        assign_scan,
        assign_scan_gang,
        assign_scan_gang_plain,
        assign_scan_interpod,
        assign_scan_interpod_plain,
        assign_scan_plain,
        assign_scan_spread,
        assign_scan_spread_interpod,
        assign_scan_spread_interpod_plain,
        assign_scan_spread_plain,
        node_run,
    )

    cases = []
    for p_, n_, miss in RUN8_SHAPES:
        sargs = scan_inputs(torch, rng, dev, p_, n_, all_miss=miss)
        compare_scan(torch, assign_scan(*sargs), assign_scan_plain(*sargs))
        gang = random_gang(torch, rng, dev, p_)
        compare_scan(torch, assign_scan_gang(*sargs, 1.0, 1.0, gang),
                     assign_scan_gang_plain(*sargs, 1.0, 1.0, gang))
        spread = spread_inputs(torch, rng, dev, n_, p_)
        compare_spread(torch, assign_scan_spread(*sargs, 1.0, 1.0, spread),
                       assign_scan_spread_plain(*sargs, 1.0, 1.0, spread))
        ip = interpod_inputs(torch, rng, dev, n_, p_)
        compare_interpod(torch, assign_scan_interpod(*sargs, 1.0, 1.0, ip),
                         assign_scan_interpod_plain(*sargs, 1.0, 1.0, ip))
        sp_, ip_ = with_spread(torch, rng, ip, zones=3)
        compare_interpod(torch, assign_scan_spread_interpod(*sargs, 1.0, 1.0, sp_, ip_),
                         assign_scan_spread_interpod_plain(*sargs, 1.0, 1.0, sp_, ip_),
                         "spread_interpod")
        cases.append([p_, n_, "all_miss" if miss else "mixed"])
    reverted = []
    for p_, n_, make in RUN8_REVERTS:
        gargs, gang = (revert_one_node_inputs if make == "one_node"
                       else revert_heavy_inputs)(torch, rng, dev, n_, p_)
        want = assign_scan_gang_plain(*gargs, 1.0, 1.0, gang)
        compare_scan(torch, assign_scan_gang(*gargs, 1.0, 1.0, gang), want)
        _a, _s, n_placed, n_reverted = solver.gang_member_mask(
            gang.gang_id, gang.gang_min, want.assignments, want.scores)
        if int(n_reverted) == 0:
            raise AssertionError(f"run8_hazards: no group reverted at P={p_} N={n_}")
        reverted.append([p_, n_, make, int(n_placed), int(n_reverted)])
    runs = {node_run(n_) for _, n_, _ in RUN8_SHAPES + RUN8_REVERTS}
    if runs != {8}:
        raise AssertionError(f"run8_hazards: node runs {sorted(runs)}, want 8")
    return {"phase": "run8_hazards", "cases": cases,
            "reverts_placed_reverted": reverted, "kernels_equal_plain": True}


def gang_bound(scan_args, gang, placed_members: int) -> tuple[float, str]:
    """scan_bound plus the group ids and quorums read once and one undo-log
    entry (32 bytes; 48 with gpu or storage columns) written per placed
    group member."""
    t_bytes, _ = scan_bound(*scan_args[:6])
    nbytes = (t_bytes * 1e-3 * H100_BYTES_PER_S + 8 * gang.gang_id.numel()
              + 32 * placed_members)
    pairs = float((scan_args[0] > float("-inf")).sum())
    return bound(nbytes, SCAN_OPS_PER_PAIR * pairs)


def gang_carry_bound(base, gang, res) -> tuple[float, str]:
    """The bound of a spread, interpod or spread+interpod build with the
    gang carry: its build's bytes and operations (`base()`), plus the group
    ids and quorums read once and one undo-log entry (32 bytes) written per
    placed group member of the result `res`."""
    base()
    nbytes, ops = BOUND_PARTS[-1]
    members = int(((res.assignments >= 0) & (gang.gang_id > 0)).sum())
    return bound(nbytes + 8 * gang.gang_id.numel() + 32 * members, ops)


def gang_first_batch(torch, dev):
    """bench[gang]'s cluster and its first batch as the driver builds it
    (its groups whole, the gang columns written after encoding) on the
    flushed state: (caps, nodes, pods, static-mask arguments, the scan
    arguments, GangInputs, the state, the batch)."""
    from kubernetes_tpu_torch.ops import solver
    from kubernetes_tpu_torch.ops.assign_scan import GangInputs
    from kubernetes_tpu_torch.ops.static_mask import node_bits
    from kubernetes_tpu_torch.ops import predicates
    from kubernetes_tpu_torch.perf.fixtures import make_nodes, make_pods
    from kubernetes_tpu_torch.perf.harness import default_caps
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.state.convert import batch_from_numpy
    from kubernetes_tpu_torch.state.pod_batch import encode_pods

    caps = default_caps(GANG_NODES, GANG_PODS)
    nodes = make_nodes(GANG_NODES, zones=3)
    pods = make_pods(GANG_PODS, gang_size=GANG_SIZE)
    sched = Scheduler(caps, device=dev)
    sched.add_nodes(nodes)
    chunk, gang_id, gang_min = next(sched._gang_batches(pods))
    host = encode_pods(chunk, caps, sched.statedb.table)
    host.gang_id[:len(chunk)] = gang_id
    host.gang_min[:len(chunk)] = gang_min
    state = sched.statedb.flush()
    batch = batch_from_numpy(host, dev)
    g = solver.check_supported(solver.DEFAULT_POLICY, solver.batch_flags(state, batch))
    mask_args = (batch.sel_onehot, batch.sel_count,
                 predicates.untolerated(state, batch), batch.best_effort,
                 batch.node_name_lo, batch.node_name_hi, state.sel_member,
                 state.taint_hard_member, node_bits(state), state.name_lo,
                 state.name_hi)
    masked = solver.masked_static_scores(state, batch, solver.DEFAULT_POLICY, g)
    args = (masked, batch.requests, batch.nonzero_requests, state.allocatable,
            state.requested, state.nonzero_requested, 0, float(g.w_lr),
            float(g.w_ba))
    gang = GangInputs(gang_id=batch.gang_id.contiguous(),
                      gang_min=batch.gang_min.contiguous())
    return caps, nodes, pods, mask_args, args, gang, state, batch


def gang_phase(torch, dev, kernels) -> tuple[dict, dict]:
    """bench[gang] through Scheduler(device="cuda"): every group settled,
    allocatable held, one gang-build launch a batch; the first driver
    batch's result equal to the masked plain scan on its inputs; kernel 1
    and the gang build timed on it. Returns (the phase line, the
    kernels-line entry)."""
    from kubernetes_tpu_torch.ops import solver
    from kubernetes_tpu_torch.ops.assign_scan import (
        assign_scan,
        assign_scan_gang,
        assign_scan_gang_plain,
    )
    from kubernetes_tpu_torch.ops.static_mask import static_mask, static_mask_plain
    from kubernetes_tpu_torch.perf.harness import measure, warm
    from kubernetes_tpu_torch.scheduler import Scheduler, driver

    caps, nodes, pods, mask_args, args, gang, _state, _batch = gang_first_batch(torch, dev)
    mask = static_mask(*mask_args)
    if not torch.equal(mask, static_mask_plain(*mask_args)):
        raise AssertionError("gang: static_mask kernel != plain at N=65536")
    k1_ms = timed(torch, lambda: static_mask(*mask_args), reps=20, key="static_mask_ms")
    k1_bound, k1_by = static_mask_bound(torch, mask_args)
    del mask, mask_args
    warm(caps, solver.DEFAULT_POLICY, dev, pod_kwargs={"gang_size": GANG_SIZE})
    sched = Scheduler(caps, device=dev)
    sched.add_nodes(nodes)
    seen = []
    solve = record_solves(torch, driver, (0,), seen)
    for k in kernels:
        k.launches = 0
    try:
        result = measure(sched, pods)
    finally:
        driver.schedule_batch = solve
    launches = {k.__name__: k.launches for k in kernels}
    groups = GANG_PODS // GANG_SIZE
    if (result.gang_groups, result.gang_placed + result.gang_reverted) != (groups, groups):
        raise AssertionError(f"gang: {result.gang_placed} placed + "
                             f"{result.gang_reverted} reverted of "
                             f"{result.gang_groups} groups ({groups} expected)")
    if launches != {"static_mask": result.batches, "assign_scan": 0,
                    "assign_scan_spread": 0, "assign_scan_interpod": 0,
                    "assign_scan_spread_interpod": 0,
                    "assign_scan_gang": result.batches} or result.batches != 6:
        raise AssertionError(f"gang: launches {launches} over {result.batches} batches")
    placed = {k: v for k, v in result.placements.items() if v is not None}
    load = check_load(pods, placed, nodes)

    # the first driver batch: the same inputs as gang_first_batch's
    (state0, batch0, _rr, _flags), got = seen[0]
    if not (torch.equal(batch0.gang_id, gang.gang_id)
            and torch.equal(batch0.gang_min, gang.gang_min)
            and torch.equal(batch0.requests, args[1])
            and torch.equal(state0.requested, args[4])):
        raise AssertionError("gang: the driver's first batch != its fresh encoding")
    kern = assign_scan_gang(*args, gang)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = assign_scan_gang_plain(*args, gang)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    err = compare_scan(torch, kern, plain)
    masked_a, masked_s, n_placed, n_reverted = solver.gang_member_mask(
        gang.gang_id, gang.gang_min, plain.assignments, plain.scores)
    for name, want in (("assignments", masked_a), ("scores", masked_s),
                       ("feasible_counts", plain.feasible_counts),
                       ("new_requested", plain.new_requested),
                       ("new_nonzero", plain.new_nonzero), ("rr_end", plain.rr_end),
                       ("gang_placed", n_placed), ("gang_reverted", n_reverted)):
        if not torch.equal(getattr(got, name), want):
            raise AssertionError(f"gang: first driver batch != masked plain on {name}")
    members = int(((gang.gang_id > 0) & (plain.assignments >= 0)).sum())
    entry = {
        "name": "assign_scan_gang", "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/assign_scan.cu",
        "replaces": "kubernetes_tpu/ops/solver.py:738",
        "launches": launches["assign_scan_gang"], "max_abs_err": err,
        **timed(torch, lambda: assign_scan_gang(*args, gang), reps=5),
        "plain_ms": plain_ms, "library_ms": None, "shape": list(args[0].shape),
    }
    entry["bound_ms"], entry["bound_by"] = gang_bound(args, gang, members)
    main_ms = timed(torch, lambda: assign_scan(*args), reps=5,
                    key="main_build_same_batch_ms")
    encode_ms = 1e3 * sum(sched.encode_seconds)
    solve_ms = 1e3 * sum(sched.solve_seconds)
    line = {"phase": "gang", "nodes": GANG_NODES, "pods": GANG_PODS,
            "group_size": GANG_SIZE, "caps": [caps.num_nodes, caps.batch_pods],
            **run_fields(result), "encode_ms": encode_ms, "solve_ms": solve_ms,
            "remainder_ms": 1e3 * result.seconds - encode_ms - solve_ms,
            "groups": result.gang_groups, "groups_placed": result.gang_placed,
            "groups_reverted": result.gang_reverted, "nodes_used": len(load),
            "launches": launches, **k1_ms, "static_mask_bound_ms": k1_bound,
            "static_mask_bound_by": k1_by, **main_ms,
            "first_batch_placed_members": members,
            "first_batch_equals_plain": True}
    return line, entry


def with_reverts(torch, rng, dev, args):
    """Gang groups over a batch's scan arguments, built to revert:
    random_gang's runs of groups (each at its full size as quorum) and solo
    pods, the last rows one group, and in about half of the groups of two
    or more, and in the last, one member after the first that fits nowhere
    (its masked_static row -inf). Returns (the arguments with that
    masked_static, GangInputs)."""
    from kubernetes_tpu_torch.ops.assign_scan import GangInputs

    ms = args[0].clone()
    p = ms.shape[0]
    gid = random_gang(torch, rng, dev, p).gang_id.cpu().numpy().copy()
    tail = max(2, p // 12)
    gid[-tail:] = gid.max() + 1
    gmin = np.zeros(p, np.int32)
    nowhere = []
    for g in np.unique(gid[gid > 0]):
        rows = np.flatnonzero(gid == g)
        gmin[rows] = rows.size
        if rows.size > 1 and (g == gid[-1] or rng.random() < 0.5):
            nowhere.append(int(rows[1 + rng.integers(0, rows.size - 1)]))
    ms[torch.tensor(nowhere, dtype=torch.long, device=ms.device)] = float("-inf")

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    return (ms, *args[1:]), GangInputs(gang_id=t(gid), gang_min=t(gmin))


def gang_carry_hazards_phase(torch, rng, dev) -> dict:
    """The gang carry in the spread, interpod and spread+interpod builds
    against their plain versions at each (pods, nodes) of
    GANG_CARRY_SHAPES (every RUN), with and without the normalization flag
    (norm_test_inputs), on batches built to revert (with_reverts: members
    that fit nowhere, solo pods between groups, a group open at the last
    row) over each build's hazards: the spread build's one-thread batch
    (spread_hot_inputs: the count column loaded a pod ahead and patched by
    the owner, so a revert must load it again), the interpod build's
    one-node batch (every member of a group on one node) and wide batch
    with 16 topology slots (interpod_hazard_inputs: the totals moved
    mid-batch, the first-pod escape, ids past the universe), the
    spread+interpod build's one-thread batch and its batch cycling spread
    only, interpod only and both (spread_interpod_hazard_inputs); a revert
    must give back the node-level counts, every block's replica and totals
    and the count column. At the first shape also the spread and interpod
    builds with the gang carry on norm_miss_inputs' traffics, whose guesses
    miss. Returns the phase line."""
    from kubernetes_tpu_torch.ops import assign_scan as scan
    from kubernetes_tpu_torch.ops import solver

    reverted: dict = {}
    errs: dict = {}

    def held(name, args, extra, gang, norm=None):
        kern, plain = getattr(scan, name), getattr(scan, f"{name}_plain")
        got = kern(*args, 1.0, 1.0, *extra, gang, norm)
        want = plain(*args, 1.0, 1.0, *extra, gang, norm)
        compare = compare_spread if name == "assign_scan_spread_gang" else (
            lambda t, a, b: compare_interpod(t, a, b, name))
        errs[name] = max(errs.get(name, 0.0), compare(torch, got, want))
        _a, _s, _placed, n_rev = solver.gang_member_mask(
            gang.gang_id, gang.gang_min, want.assignments, want.scores)
        reverted[name] = reverted.get(name, 0) + int(n_rev)
        return got

    for p_, n_ in GANG_CARRY_SHAPES:
        cases = []
        hargs, sp_ = spread_hot_inputs(torch, rng, dev, n_, p_)
        cases.append(("assign_scan_spread_gang", hargs, (sp_,)))
        for pool, k_ in (("one_node", 8), ("wide", 16)):
            hargs, ip_ = interpod_hazard_inputs(torch, rng, dev, n_, p_, k_, pool)
            cases.append(("assign_scan_interpod_gang", hargs, (ip_,)))
        for pool, k_, zones_, mode in (("one_thread", 5, 1, ""), ("wide", 8, 3, "alternate")):
            hargs, sp_, ip_ = spread_interpod_hazard_inputs(torch, rng, dev, n_, p_, k_,
                                                            pool, zones_, mode)
            cases.append(("assign_scan_spread_interpod_gang", hargs, (sp_, ip_)))
        for name, hargs, extra in cases:
            gargs, gang = with_reverts(torch, rng, dev, hargs)
            held(name, gargs, extra, gang)
            ms_, norm_ = norm_test_inputs(torch, rng, dev, gargs[0])
            held(name, (ms_, *gargs[1:]), extra, gang, norm_)
    # the builds that guess the flag's maxima, on traffics that force misses
    p_, n_ = GANG_CARRY_SHAPES[0]
    misses: dict = {}
    for kind in NORM_MISS_KINDS:
        margs, mnorm = norm_miss_inputs(torch, rng, dev, scan_inputs(torch, rng, dev, p_, n_),
                                        kind)
        gargs, gang = with_reverts(torch, rng, dev, margs)
        for name, extra in (("assign_scan_spread_gang",
                             (spread_inputs(torch, rng, dev, n_, p_, no_entry=0.3),)),
                            ("assign_scan_interpod_gang",
                             (interpod_inputs(torch, rng, dev, n_, p_),))):
            got = held(name, gargs, extra, gang, mnorm)
            m, x = norm_misses(name, (*gargs, 1.0, 1.0, *extra, gang), mnorm, got)
            key = f"{name}_{kind}"
            misses[key] = [m, x]
    runs = sorted({scan.node_run(n_) for _, n_ in GANG_CARRY_SHAPES})
    if runs != list(scan.RUNS):
        raise AssertionError(f"gang_carry_hazards checked {runs}, built {scan.RUNS}")
    if not all(reverted.values()):
        raise AssertionError(f"gang_carry_hazards: a build reverted no group {reverted}")
    if not all(m > 0 for m, _x in misses.values()):
        raise AssertionError(f"gang_carry_hazards: a forced-miss traffic missed nothing "
                             f"{misses}")
    return {"phase": "gang_carry_hazards", "shapes": [list(x) for x in GANG_CARRY_SHAPES],
            "runs": runs, "groups_reverted": reverted, "max_abs_err": errs,
            "forced_misses_of_exchanging_pods": misses, "kernels_equal_plain": True}


def scope_batch(batch, pods: int):
    """A PodBatch's first `pods` rows."""
    return dataclasses.replace(batch, **{f.name: getattr(batch, f.name)[:pods]
                                         for f in dataclasses.fields(batch)})


def compare_solves(torch, got, want, what: str) -> None:
    """Two SolverResults equal in every field, the gang counts included."""
    for name in ("assignments", "scores", "feasible_counts", "new_requested",
                 "new_nonzero", "rr_end", "new_podsel", "new_term", "gang_placed",
                 "gang_reverted", "new_port_count"):
        a, b = getattr(got, name), getattr(want, name)
        if (a is None) != (b is None) or (a is not None and not torch.equal(a, b)):
            raise AssertionError(f"{what}: kernel path != plain on {name}")


def gang_spread_interpod_phase(torch, dev, kernels) -> tuple[dict, dict]:
    """The gang_spread_interpod cell (bench[spread]'s 15,000 nodes in 3
    zones and 16 Services, 24,576 pods of bench[interpod]'s terms over 16
    app groups in 3,072 all-or-nothing groups of 8 at quorum 8) through
    Scheduler(device="cuda"): every group must settle placed (each fits),
    no node may exceed its allocatable, no node that holds an anti-affinity
    pod may hold another pod of its group, the spread+interpod build with
    the gang carry must have launched once a batch (and no other build of
    the scan), and the device ledgers flushed at the end must equal the
    host's, which the StateDB recomputed from the placements. Then the
    first batch, and its variant whose every GSI_REVERT_EVERY-th group asks
    5 CPUs for its first member (which no node fits: the group reverts at
    full width, and the groups after it read the counts it gave back), on
    their first GSI_SCOPE pods through schedule_batch against
    schedule_batch_plain, every field included; the build timed on the
    first batch's scope. Returns (the phase line, the kernels-line entry)."""
    from kubernetes_tpu_torch.ops import solver
    from kubernetes_tpu_torch.perf.fixtures import make_nodes, make_pods, make_services
    from kubernetes_tpu_torch.perf.harness import (GANG_SPREAD_INTERPOD_PODS,
                                                   default_caps, measure, warm)
    from kubernetes_tpu_torch.scheduler import Scheduler, driver

    caps = default_caps(HEADLINE_NODES, GSI_PODS)
    mix = GANG_SPREAD_INTERPOD_PODS
    nodes = make_nodes(HEADLINE_NODES, zones=3)
    pods = make_pods(GSI_PODS, **mix)
    services = make_services(SPREAD_GROUPS)
    warm(caps, solver.DEFAULT_POLICY, dev, n_services=SPREAD_GROUPS, pod_kwargs=mix)
    sched = Scheduler(caps, device=dev)
    sched.add_nodes(nodes)
    for svc in services:
        sched.add_service(svc)
    seen = []
    solve = record_solves(torch, driver, (0,), seen)
    _count_launches(kernels, reset=True)
    try:
        result = measure(sched, pods)
    finally:
        driver.schedule_batch = solve
    launches, norm_launches = _count_launches(kernels)
    groups = GSI_PODS // mix["gang_size"]
    if (result.scheduled, result.gang_groups, result.gang_placed) != (GSI_PODS, groups,
                                                                       groups):
        raise AssertionError(f"gang_spread_interpod: placed {result.scheduled}/{GSI_PODS}, "
                             f"{result.gang_placed} of {result.gang_groups} groups")
    want = {name: 0 for name in launches}
    want.update(static_mask=result.batches,
                assign_scan_spread_interpod_gang=result.batches)
    if launches != want or any(norm_launches.values()) or result.batches != 6:
        raise AssertionError(f"gang_spread_interpod: launches {launches} over "
                             f"{result.batches} batches")
    load = check_load(pods, result.placements, nodes)
    group_on: dict = {}
    anti_nodes = set()
    for i, p in enumerate(pods):
        key = (result.placements[p.key], p.metadata.labels["app"])
        group_on[key] = group_on.get(key, 0) + 1
        if i % mix["anti_affinity_every"] == 0:
            anti_nodes.add(key)
    crowded = [key for key in anti_nodes if group_on[key] != 1]
    if crowded:
        raise AssertionError(f"gang_spread_interpod: anti-affinity broken on {crowded[:5]}")
    device = sched.statedb.flush()
    for name in ("requested", "nonzero_requested", "podsel_count", "term_count"):
        if not np.array_equal(getattr(device, name).cpu().numpy(),
                              getattr(sched.statedb.host, name)):
            raise AssertionError(f"gang_spread_interpod: device {name} != the host's")
    # the first batch and its reverting variant on their scope
    (state, batch, rr, flags), _got = seen[0]
    zones = sched.statedb.table.spread_zones
    first = scope_batch(batch, GSI_SCOPE)
    heavy = first.requests.clone()
    nonzero = first.nonzero_requests.clone()
    members = torch.arange(GSI_SCOPE, device=heavy.device)
    revert_rows = members[(members % (GSI_REVERT_EVERY * mix["gang_size"])) == 0]
    heavy[revert_rows, 1] = 5000.0
    nonzero[revert_rows, 0] = 5000.0
    variant = dataclasses.replace(first, requests=heavy, nonzero_requests=nonzero)
    held = {}
    for key, b in (("first", first), ("reverting", variant)):
        got = solver.schedule_batch(state, b, rr, solver.DEFAULT_POLICY, flags, caps,
                                    spread_zones=zones)
        plain = solver.schedule_batch_plain(state, b, rr, solver.DEFAULT_POLICY, flags,
                                            caps)
        compare_solves(torch, got, plain, f"gang_spread_interpod {key}")
        held[key] = [int(plain.gang_placed), int(plain.gang_reverted)]
    if held["reverting"][1] != revert_rows.numel():
        raise AssertionError(f"gang_spread_interpod: reverting variant settled {held}")
    call = scan_call(torch, state, first, flags, caps, zones)
    if call[0] != "assign_scan_spread_interpod_gang" or call[4] is not None:
        raise AssertionError(f"gang_spread_interpod: the batch runs {call[0]}")
    entry = scoped(norm_entry(torch, call, launches["assign_scan_spread_interpod_gang"]),
                   GSI_SCOPE)
    whole = scan_call(torch, state, batch, flags, caps, zones)
    encode_ms = 1e3 * sum(sched.encode_seconds)
    solve_ms = 1e3 * sum(sched.solve_seconds)
    line = {"phase": "gang_spread_interpod", "nodes": HEADLINE_NODES, "pods": GSI_PODS,
            "services": len(services), **mix, "caps": [caps.num_nodes, caps.batch_pods],
            **run_fields(result), "encode_ms": encode_ms, "solve_ms": solve_ms,
            "remainder_ms": 1e3 * result.seconds - encode_ms - solve_ms,
            "groups": result.gang_groups, "groups_placed": result.gang_placed,
            "groups_reverted": result.gang_reverted, "nodes_used": len(load),
            "anti_affinity_nodes": len(anti_nodes), "launches": launches,
            "scope_pods": GSI_SCOPE, "scope_groups_placed_reverted": held,
            **timed(torch, lambda: whole[1](*whole[3]), 5, "first_batch_whole_ms"),
            "device_ledgers_equal_host": True, "scope_equals_plain": True}
    return line, entry


def gang_cells_phase(torch, dev, kernels) -> tuple[dict, list]:
    """The first batch of the spread and interpod cells with their pods in
    all-or-nothing groups of 8, each without and with one PreferNoSchedule
    taint (on node 0, which no pod tolerates), and of the
    gang_spread_interpod cell with that taint, through
    Scheduler(device="cuda"): each runs its build with the gang carry, once,
    with the flag where the taint is. Each build is held against its plain
    version on the batch's first GSI_SCOPE pods and timed there. Returns
    (the phase line, the kernels-line entries)."""
    from kubernetes_tpu_torch.ops import solver
    from kubernetes_tpu_torch.perf.fixtures import make_nodes, make_pods, make_services
    from kubernetes_tpu_torch.perf.harness import (GANG_SPREAD_INTERPOD_PODS,
                                                   default_caps, measure, warm)
    from kubernetes_tpu_torch.scheduler import Scheduler, driver

    spread_mix = {"app_groups": SPREAD_GROUPS, "gang_size": GANG_SIZE}
    interpod_mix = {**INTERPOD_MIX, "gang_size": GANG_SIZE}
    cells = (("spread_gang", HEADLINE_NODES, HEADLINE_PODS, spread_mix, SPREAD_GROUPS,
              "assign_scan_spread_gang", False),
             ("spread_gang+norm", HEADLINE_NODES, HEADLINE_PODS, spread_mix,
              SPREAD_GROUPS, "assign_scan_spread_gang", True),
             ("interpod_gang", INTERPOD_NODES, INTERPOD_PODS, interpod_mix, 0,
              "assign_scan_interpod_gang", False),
             ("interpod_gang+norm", INTERPOD_NODES, INTERPOD_PODS, interpod_mix, 0,
              "assign_scan_interpod_gang", True),
             ("spread_interpod_gang+norm", HEADLINE_NODES, GSI_PODS,
              GANG_SPREAD_INTERPOD_PODS, SPREAD_GROUPS, "assign_scan_spread_interpod_gang",
              True))
    line: dict = {"phase": "gang_cells"}
    entries = []
    for cell, n_nodes, n_pods, mix, n_svc, build, flag in cells:
        caps = default_caps(n_nodes, n_pods)
        nodes = make_nodes(n_nodes, zones=3, prefer_taint_every=n_nodes if flag else 0)
        pods = make_pods(caps.batch_pods - caps.batch_pods % GANG_SIZE, **mix)
        warm(caps, solver.DEFAULT_POLICY, dev, n_svc, mix)
        sched = Scheduler(caps, device=dev)
        sched.add_nodes(nodes)
        for svc in make_services(n_svc):
            sched.add_service(svc)
        seen = []
        solve = record_solves(torch, driver, (0,), seen)
        _count_launches(kernels, reset=True)
        try:
            result = measure(sched, pods)
        finally:
            driver.schedule_batch = solve
        launches, norm_launches = _count_launches(kernels)
        want = {name: 0 for name in launches}
        want.update({"static_mask": 1, build: 1})
        if launches != want or norm_launches[build] != flag:
            raise AssertionError(f"gang_cells {cell}: launches {launches}, with the "
                                 f"flag {norm_launches}")
        (state, batch, _rr, flags), _got = seen[0]
        if not flags.gang or flags.tt != flag:
            raise AssertionError(f"gang_cells {cell}: the batch raises {flags}")
        call = scan_call(torch, state, scope_batch(batch, GSI_SCOPE), flags, caps,
                         sched.statedb.table.spread_zones)
        if call[0] != build or (call[4] is not None) != flag:
            raise AssertionError(f"gang_cells {cell}: the batch runs {call[0]}")
        entry = scoped(norm_entry(torch, call, (norm_launches if flag else launches)[build]),
                       GSI_SCOPE)
        entries.append(entry)
        line[cell] = {"caps": [caps.num_nodes, caps.batch_pods], "placed": result.scheduled,
                      "groups_placed": result.gang_placed, "launches": launches,
                      "norm_launches": norm_launches, "ms": entry["ms"],
                      "plain_ms": entry["plain_ms"], "kernel_equals_plain": True,
                      **{k: entry[k] for k in ("norm_misses", "norm_exchanging_pods")
                         if k in entry}}
        del sched, seen, state, batch, call
    return line, entries


def tt_na_first_batch(torch, dev, n_nodes=HEADLINE_NODES, n_pods=HEADLINE_PODS):
    """The tt_na cell's first batch, encoded through a Scheduler on the
    cell's cluster and flushed (with `n_nodes` and `n_pods`, the cluster
    and pods of another cell's size): (caps, state, batch, flags)."""
    from kubernetes_tpu_torch.ops import solver
    from kubernetes_tpu_torch.perf.fixtures import make_nodes, make_pods
    from kubernetes_tpu_torch.perf.harness import TT_NA_NODES, TT_NA_PODS, default_caps
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.state.convert import batch_from_numpy
    from kubernetes_tpu_torch.state.pod_batch import encode_pods

    caps = default_caps(n_nodes, n_pods)
    ref = Scheduler(caps, device=dev)
    ref.add_nodes(make_nodes(n_nodes, **TT_NA_NODES))
    host = encode_pods(make_pods(caps.batch_pods, **TT_NA_PODS), caps,
                       ref.statedb.table, ctx=ref.encode_cache.ctx)
    state = ref.statedb.flush()
    batch = batch_from_numpy(host, dev)
    return caps, state, batch, solver.batch_flags(state, batch)


def tt_na_words(torch, dev, n_nodes: int, n_pods: int):
    """NormInputs of the tt_na cell's alternating words at another cell's
    size: TT_NA_NODES on its n_nodes nodes and TT_NA_PODS' 16 classes on
    the first batch of its n_pods pods (class i % 16 for pod i), as the
    solver packs them."""
    from kubernetes_tpu_torch.ops import solver

    _caps, state, batch, flags = tt_na_first_batch(torch, dev, n_nodes, n_pods)
    return solver.scan_norm_inputs(state, batch, solver.check_supported(
        solver.DEFAULT_POLICY, flags))


def one_taint_norm(torch, dev, p: int, n: int):
    """NormInputs of one PreferNoSchedule taint on node 0 that no pod of a
    p-pod batch tolerates, no preferred term: TaintToleration alone."""
    from kubernetes_tpu_torch.ops.assign_scan import NORM_SLOTS, NormInputs

    node_taint = torch.zeros((n,), dtype=torch.int64, device=dev)
    node_taint[0] = 1
    return NormInputs(
        w_tt=1.0, w_na=0.0, node_taint=node_taint, node_req=torch.zeros_like(node_taint),
        pod_untol=torch.ones((p,), dtype=torch.int64, device=dev),
        pod_terms=torch.zeros((p, NORM_SLOTS), dtype=torch.int64, device=dev),
        pod_weights=torch.zeros((p, NORM_SLOTS), dtype=torch.float32, device=dev))


def norm_bound(base, masked, norm) -> tuple[float, str]:
    """A build's bound with the normalization flag: the bytes and
    operations its own bound counts (`base()` calls its *_bound
    function), plus the words read once (N * 16 + P * 64 bytes),
    NORM_TT_OPS per statically feasible pair of a pod with an untolerated
    taint and w_tt set, and NORM_NA_OPS per such pair of a pod with a
    weighted term and w_na set."""
    base()
    nbytes, ops = BOUND_PARTS[-1]
    p, n = masked.shape
    feasible = (masked > float("-inf")).sum(1).double()
    tt = (norm.pod_untol != 0) & bool(norm.w_tt)
    na = (norm.pod_weights > 0).any(1) & bool(norm.w_na)
    ops += float(NORM_TT_OPS * feasible[tt].sum() + NORM_NA_OPS * feasible[na].sum())
    return bound(nbytes + 16 * n + 64 * p, ops)


def scan_call(torch, state, batch, flags, caps, zones=None, policy=None):
    """The scan build the solver dispatches for one batch under `policy`
    (default DEFAULT_POLICY), with its operands as the solver makes them
    (rr 0): (its wrapper's name, the wrapper, its plain version, the
    arguments before the flag, the flag's NormInputs or None, the
    comparison of two results, and its bound without the flag as a
    function of the plain result)."""
    from kubernetes_tpu_torch.ops import assign_scan as scan
    from kubernetes_tpu_torch.ops import solver

    policy = policy or solver.DEFAULT_POLICY
    g = solver.check_supported(policy, flags)
    masked = solver.masked_static_scores(state, batch, policy, g)
    args = (masked, batch.requests, batch.nonzero_requests, state.allocatable,
            state.requested, state.nonzero_requested, 0, float(g.w_lr),
            float(g.w_ba))
    norm = solver.scan_norm_inputs(state, batch, g)
    u = caps.domain_universe
    if flags.gang and (g.use_terms or g.w_ss):
        gang = scan.GangInputs(gang_id=batch.gang_id.contiguous(),
                               gang_min=batch.gang_min.contiguous())
        if g.use_terms and g.w_ss:
            sp, ip = solver.spread_interpod_inputs(state, batch, g, u, zones)
            name, extra = "assign_scan_spread_interpod_gang", (sp, ip)
            compare = lambda t, a, b: compare_interpod(t, a, b, "spread_interpod_gang")  # noqa: E731
            base = lambda: spread_interpod_bound(torch, args, sp, ip)  # noqa: E731
        elif g.use_terms:
            ip = solver.interpod_inputs(state, batch, g, u)
            name, extra = "assign_scan_interpod_gang", (ip,)
            compare = lambda t, a, b: compare_interpod(t, a, b, "interpod_gang")  # noqa: E731
            base = lambda: interpod_bound(torch, args, ip)  # noqa: E731
        else:
            sp = solver.spread_inputs(state, batch, g, u, zones)
            name, extra, compare = "assign_scan_spread_gang", (sp,), compare_spread
            base = lambda: spread_bound(args, sp)  # noqa: E731
        return (name, getattr(scan, name), getattr(scan, f"{name}_plain"),
                (*args, *extra, gang), norm, compare,
                lambda res: gang_carry_bound(base, gang, res))
    if g.use_terms and g.w_ss:
        sp, ip = solver.spread_interpod_inputs(state, batch, g, u, zones)
        return ("assign_scan_spread_interpod", scan.assign_scan_spread_interpod,
                scan.assign_scan_spread_interpod_plain, (*args, sp, ip), norm,
                lambda t, a, b: compare_interpod(t, a, b, "spread_interpod"),
                lambda _res: spread_interpod_bound(torch, args, sp, ip))
    if g.use_terms:
        ip = solver.interpod_inputs(state, batch, g, u)
        return ("assign_scan_interpod", scan.assign_scan_interpod,
                scan.assign_scan_interpod_plain, (*args, ip), norm, compare_interpod,
                lambda _res: interpod_bound(torch, args, ip))
    if g.w_ss:
        sp = solver.spread_inputs(state, batch, g, u, zones)
        return ("assign_scan_spread", scan.assign_scan_spread,
                scan.assign_scan_spread_plain, (*args, sp), norm, compare_spread,
                lambda _res: spread_bound(args, sp))
    if g.use_ext:
        # (a tree from before the EXT variant's volumes: its ports and fit)
        ext = (solver.ext_inputs(state, batch, g) if hasattr(solver, "ext_inputs") else
               scan.ExtInputs(use_ports=g.use_ports,
                              port_onehot=batch.port_onehot.contiguous(),
                              port_count=state.port_count))
        if flags.gang:
            gang = scan.GangInputs(gang_id=batch.gang_id.contiguous(),
                                   gang_min=batch.gang_min.contiguous())
            return ("assign_scan_gang_ext", scan.assign_scan_gang_ext,
                    scan.assign_scan_gang_ext_plain, (*args, ext, gang), norm, compare_ext,
                    lambda res: ext_bound(lambda: gang_bound(args, gang, int(
                        ((res.assignments >= 0) & (gang.gang_id > 0)).sum())), args, ext))
        return ("assign_scan_ext", scan.assign_scan_ext, scan.assign_scan_ext_plain,
                (*args, ext), norm, compare_ext,
                lambda _res: ext_bound(lambda: scan_bound(*args[:6]), args, ext))
    if flags.gang:
        gang = scan.GangInputs(gang_id=batch.gang_id.contiguous(),
                               gang_min=batch.gang_min.contiguous())
        return ("assign_scan_gang", scan.assign_scan_gang, scan.assign_scan_gang_plain,
                (*args, gang), norm, compare_scan,
                lambda res: gang_bound(args, gang, int(
                    ((res.assignments >= 0) & (gang.gang_id > 0)).sum())))
    return ("assign_scan", scan.assign_scan, scan.assign_scan_plain, args, norm,
            compare_scan, lambda _res: scan_bound(*args[:6]))


# the kernels-line names of the builds with the gang carry and of the EXT
# variant's
GANG_CARRY_ROWS = {"assign_scan_spread_gang": "assign_scan_spread+gang",
                   "assign_scan_interpod_gang": "assign_scan_interpod+gang",
                   "assign_scan_spread_interpod_gang": "assign_scan_spread_interpod+gang",
                   "assign_scan_ext": "assign_scan+ext",
                   "assign_scan_gang_ext": "assign_scan_gang+ext"}
EXT_BUILDS = ("assign_scan_ext", "assign_scan_gang_ext")


def norm_entry(torch, call, launches: int, reps: int = 5, also=None) -> dict:
    """The kernels-line entry of a build on one batch (`scan_call`), with
    the normalization flag where the call has its operands: the build held
    against its plain version, timed beside it (the plain version's one
    call that is compared), and its bound from the batch. `also`, if
    given, is called with the plain version's result."""
    name, kern, plain, args, norm, compare, base = call
    got = kern(*args, norm)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain(*args, norm)
    end.record()
    end.synchronize()
    if also is not None:
        also(want)
    entry = {"name": GANG_CARRY_ROWS.get(name, name) + ("+norm" if norm else ""),
             "route": "cuda", "source": "kubernetes_tpu_torch/csrc/assign_scan.cu",
             "replaces": "kubernetes_tpu/ops/solver.py:" + (
                 "733" if name in EXT_BUILDS else "568" if norm else "738"),
             "launches": launches, "max_abs_err": compare(torch, got, want),
             **timed(torch, lambda: kern(*args, norm), reps),
             "plain_ms": start.elapsed_time(end), "library_ms": None,
             "shape": list(args[0].shape)}
    if norm is None:
        entry["bound_ms"], entry["bound_by"] = base(want)
        return entry
    entry["bound_ms"], entry["bound_by"] = norm_bound(lambda: base(want), args[0], norm)
    if name in NORM_GUESS_BUILDS + EXT_BUILDS:   # (not on the kernels line)
        entry["norm_misses"], entry["norm_exchanging_pods"] = norm_misses(
            name, args, norm, got)
    return entry


def scoped(entry: dict, scope: int) -> dict:
    """A kernels-line entry held and timed on a batch's first `scope` pods."""
    return {**entry, "scope": (f"ms, plain_ms, bound_ms and max_abs_err on the batch's "
                               f"first {scope} pods; launches on the whole run")}


def norm_build_phase(torch, rng, dev) -> dict:
    """Every build of the scan with the normalization flag against its
    plain version at every RUN (NORM_SHAPES) on norm_test_inputs' hazards:
    a zero maximum with an exchange, the largest counts on a statically
    infeasible node, ties, padding nodes and odd N (the spread build's pods
    in runs, some without an entry: the flag's maxima sent alone); at the
    first shape also
    TaintToleration alone (w_na = 0) and NodeAffinity alone (w_tt = 0) at
    other weights; and the builds that guess the flag's maxima (main,
    spread, interpod, gang) on norm_miss_inputs' traffics, whose guesses
    miss (the host replay's misses of each, which must be some, in the
    line). Returns the phase line."""
    from kubernetes_tpu_torch.ops import assign_scan as scan

    errs: dict = {}
    misses: dict = {}
    for p_, n_ in NORM_SHAPES:
        sargs = list(scan_inputs(torch, rng, dev, p_, n_))
        sargs[0], norm = norm_test_inputs(torch, rng, dev, sargs[0])
        ip = interpod_inputs(torch, rng, dev, n_, p_)
        sp_, ip_ = with_spread(torch, rng, ip, zones=3)
        builds = (
            ("assign_scan", scan.assign_scan, scan.assign_scan_plain, (), compare_scan),
            ("assign_scan_spread", scan.assign_scan_spread, scan.assign_scan_spread_plain,
             (spread_inputs(torch, rng, dev, n_, p_, no_entry=0.3),), compare_spread),
            ("assign_scan_interpod", scan.assign_scan_interpod,
             scan.assign_scan_interpod_plain, (ip,), compare_interpod),
            ("assign_scan_spread_interpod", scan.assign_scan_spread_interpod,
             scan.assign_scan_spread_interpod_plain, (sp_, ip_),
             lambda t, a, b: compare_interpod(t, a, b, "spread_interpod")),
            ("assign_scan_gang", scan.assign_scan_gang, scan.assign_scan_gang_plain,
             (random_gang(torch, rng, dev, p_),), compare_scan))
        variants = [norm] + ([dataclasses.replace(norm, w_tt=2.0, w_na=0.0),
                              dataclasses.replace(norm, w_tt=0.0, w_na=3.0)]
                             if (p_, n_) == NORM_SHAPES[0] else [])
        for name, kern, plain, extra, compare in builds:
            for v in variants:
                err = compare(torch, kern(*sargs, 1.0, 1.0, *extra, v),
                              plain(*sargs, 1.0, 1.0, *extra, v))
                errs[name] = max(errs.get(name, 0.0), err)
        # the builds that guess the flag's maxima on traffics that force
        # their guess to miss, each miss counted by the host replay of the
        # table
        for kind in NORM_MISS_KINDS:
            margs, mnorm = norm_miss_inputs(torch, rng, dev,
                                            scan_inputs(torch, rng, dev, p_, n_), kind)
            gang = random_gang(torch, rng, dev, p_)
            for name, kern, plain, extra, compare in (
                    ("assign_scan", scan.assign_scan, scan.assign_scan_plain, (),
                     compare_scan),
                    ("assign_scan_spread", scan.assign_scan_spread,
                     scan.assign_scan_spread_plain,
                     (spread_inputs(torch, rng, dev, n_, p_, no_entry=0.3),),
                     compare_spread),
                    ("assign_scan_interpod", scan.assign_scan_interpod,
                     scan.assign_scan_interpod_plain,
                     (interpod_inputs(torch, rng, dev, n_, p_),), compare_interpod),
                    ("assign_scan_gang", scan.assign_scan_gang,
                     scan.assign_scan_gang_plain, (gang,), compare_scan)):
                args = (*margs, 1.0, 1.0, *extra)
                got = kern(*args, mnorm)
                err = compare(torch, got, plain(*args, mnorm))
                errs[name] = max(errs.get(name, 0.0), err)
                m, x = norm_misses(name, args, mnorm, got)
                key = f"{name}_{kind}"
                got_m, got_x = misses.get(key, (0, 0))
                misses[key] = (got_m + m, got_x + x)
    runs = sorted({scan.node_run(n_) for _, n_ in NORM_SHAPES})
    if runs != list(scan.RUNS):
        raise AssertionError(f"norm_build checked {runs}, built {scan.RUNS}")
    if not all(m > 0 for m, _x in misses.values()):
        raise AssertionError(f"norm_build: a forced-miss traffic missed nothing {misses}")
    return {"phase": "norm_build", "shapes": [list(x) for x in NORM_SHAPES],
            "runs": runs, "max_abs_err": errs, "kernel_equals_plain": True,
            "forced_misses_of_exchanging_pods": {k: list(v) for k, v in misses.items()}}


def _count_launches(kernels, reset: bool = False) -> tuple[dict, dict]:
    """Each wrapper's launches, and the scan wrappers' launches with the
    normalization flag (set to 0 first with `reset`)."""
    scans = [k for k in kernels if hasattr(k, "norm_launches")]
    if reset:
        for k in kernels:
            k.launches = 0
        for k in scans:
            k.norm_launches = 0
    return ({k.__name__: k.launches for k in kernels},
            {k.__name__: k.norm_launches for k in scans})


def tt_na_phase(torch, caps, dev, kernels) -> tuple[dict, dict]:
    """The tt_na cell through Scheduler(device="cuda"): every pod placed
    within allocatable, the main build launched once a batch, always with
    the normalization flag (and no other build), and the first and last
    batch equal to the plain path on the state and batch the driver solved
    them on; the flag's main build timed on the first batch against its
    plain version, and the main build on it without the flag. Returns
    (the phase line, the kernels-line entry)."""
    from kubernetes_tpu_torch.ops import solver
    from kubernetes_tpu_torch.ops.assign_scan import assign_scan
    from kubernetes_tpu_torch.perf.fixtures import make_nodes, make_pods
    from kubernetes_tpu_torch.perf.harness import TT_NA_NODES, TT_NA_PODS, measure, warm
    from kubernetes_tpu_torch.scheduler import Scheduler, driver

    nodes = make_nodes(HEADLINE_NODES, **TT_NA_NODES)
    pods = make_pods(HEADLINE_PODS, **TT_NA_PODS)
    warm(caps, solver.DEFAULT_POLICY, dev, pod_kwargs=TT_NA_PODS)
    sched = Scheduler(caps, device=dev)
    sched.add_nodes(nodes)
    seen = []
    # every batch's inputs, for the misses a batch (the first and the last
    # are also held against the plain path)
    solve = record_solves(torch, driver, range(HEADLINE_PODS), seen)
    _count_launches(kernels, reset=True)
    try:
        result = measure(sched, pods)
    finally:
        driver.schedule_batch = solve
    launches, norm_launches = _count_launches(kernels)
    if result.scheduled != HEADLINE_PODS:
        raise AssertionError(f"tt_na: placed {result.scheduled}/{HEADLINE_PODS}")
    want = {name: 0 for name in launches}
    want.update(static_mask=result.batches, assign_scan=result.batches)
    if launches != want or norm_launches["assign_scan"] != result.batches:
        raise AssertionError(f"tt_na: launches {launches}, with the flag "
                             f"{norm_launches}, over {result.batches} batches")
    load = check_load(pods, result.placements, nodes)
    for k in TT_NA_CHECKED:
        (state, batch, rr, flags), got = seen[k]
        if not (flags.tt and flags.na):
            raise AssertionError(f"tt_na: batch {k} raises {flags}")
        compare_scan(torch, got, solver.schedule_batch_plain(
            state, batch, rr, solver.DEFAULT_POLICY, flags, caps))
    # the main build's second rounds a batch: the host replay of its maxima
    # table over the maxima the batch's placements give
    misses = []
    for (state, batch, _rr, flags), got in seen:
        name, _k, _p, args, norm, _c, _b = scan_call(torch, state, batch, flags, caps)
        misses.append(norm_misses(name, args, norm, got))
        del args
    # where the pods went: the odd groups do not tolerate the taint, and
    # every group prefers zone-{g % 3}
    tainted = {n.metadata.name for n in nodes if n.spec.taints}
    zone_of = {n.metadata.name: n.metadata.labels[
        "failure-domain.beta.kubernetes.io/zone"] for n in nodes}
    group = {p.key: int(p.metadata.labels["app"].split("-")[1]) for p in pods}
    untolerating = sum(group[p.key] % 2 == 1 and result.placements[p.key] in tainted
                       for p in pods)
    tolerating = sum(group[p.key] % 2 == 0 and result.placements[p.key] in tainted
                     for p in pods)
    preferred = sum(zone_of[result.placements[p.key]] == f"zone-{group[p.key] % 3}"
                    for p in pods)
    (state, batch, _rr, flags), _got = seen[0]
    call = scan_call(torch, state, batch, flags, caps)
    if call[0] != "assign_scan" or call[4] is None:
        raise AssertionError(f"tt_na: the first batch runs {call[0]}")
    entry = norm_entry(torch, call, norm_launches["assign_scan"])
    args = call[3]
    line = {"phase": "tt_na", "nodes": HEADLINE_NODES, "pods": HEADLINE_PODS,
            "tainted_nodes": len(tainted), **run_fields(result),
            "nodes_used": len(load), "launches": launches,
            "norm_launches": norm_launches,
            "untolerating_pods_on_tainted_nodes": untolerating,
            "tolerating_pods_on_tainted_nodes": tolerating,
            "pods_in_preferred_zone": preferred,
            "checked_batches_equal_plain": list(TT_NA_CHECKED),
            "norm_misses_per_batch": [m for m, _x in misses],
            "norm_exchanging_pods_per_batch": [x for _m, x in misses],
            "first_batch_norm_ms": entry["ms"],
            **timed(torch, lambda: assign_scan(*args), 5, "first_batch_flag_off_ms")}
    return line, entry


def norm_cells_phase(torch, dev, kernels) -> tuple[dict, list]:
    """The first batch of the spread, gang, interpod and spread_interpod
    cells with one PreferNoSchedule taint added (on node 0, which no pod
    tolerates), through Scheduler(device="cuda"): each runs its cell's
    build, once, with the normalization flag (TaintToleration on every
    pod). The spread and gang builds with the flag are held against their
    plain versions and timed on the whole batch, the interpod and
    spread+interpod builds on its first NORM_PREFIX pods. Returns (the
    phase line, the kernels-line entries)."""
    from kubernetes_tpu_torch.ops import solver
    from kubernetes_tpu_torch.perf.fixtures import make_nodes, make_pods, make_services
    from kubernetes_tpu_torch.perf.harness import default_caps, measure, warm
    from kubernetes_tpu_torch.scheduler import Scheduler, driver

    cells = (("spread", HEADLINE_NODES, HEADLINE_PODS, {"app_groups": SPREAD_GROUPS},
              SPREAD_GROUPS, "assign_scan_spread", None),
             ("gang", GANG_NODES, GANG_PODS, {"gang_size": GANG_SIZE}, 0,
              "assign_scan_gang", None),
             ("interpod", INTERPOD_NODES, INTERPOD_PODS, INTERPOD_MIX, 0,
              "assign_scan_interpod", NORM_PREFIX),
             ("spread_interpod", HEADLINE_NODES, HEADLINE_PODS, SI_MIX, SPREAD_GROUPS,
              "assign_scan_spread_interpod", NORM_PREFIX))
    line: dict = {"phase": "norm_cells"}
    entries = []
    for cell, n_nodes, n_pods, mix, n_svc, build, prefix in cells:
        caps = default_caps(n_nodes, n_pods)
        nodes = make_nodes(n_nodes, zones=3, prefer_taint_every=n_nodes)
        pods = make_pods(caps.batch_pods, **mix)
        warm(caps, solver.DEFAULT_POLICY, dev, n_svc, mix)
        sched = Scheduler(caps, device=dev)
        sched.add_nodes(nodes)
        for svc in make_services(n_svc):
            sched.add_service(svc)
        seen = []
        solve = record_solves(torch, driver, (0,), seen)
        _count_launches(kernels, reset=True)
        try:
            result = measure(sched, pods)
        finally:
            driver.schedule_batch = solve
        launches, norm_launches = _count_launches(kernels)
        want = {name: 0 for name in launches}
        want.update({"static_mask": 1, build: 1})
        if launches != want or norm_launches[build] != 1:
            raise AssertionError(f"norm_cells {cell}: launches {launches}, with the "
                                 f"flag {norm_launches}")
        (state, batch, _rr, flags), _got = seen[0]
        if not flags.tt or flags.na:
            raise AssertionError(f"norm_cells {cell}: the batch raises {flags}")
        if prefix:
            batch = dataclasses.replace(batch, **{
                f.name: getattr(batch, f.name)[:prefix]
                for f in dataclasses.fields(batch)})
        call = scan_call(torch, state, batch, flags, caps,
                         getattr(sched.statedb.table, "spread_zones", None))
        if call[0] != build or call[4] is None:
            raise AssertionError(f"norm_cells {cell}: the batch runs {call[0]}")
        entry = norm_entry(torch, call, norm_launches[build])
        if prefix:
            entry["scope"] = (f"ms, plain_ms, bound_ms and max_abs_err on the batch's "
                              f"first {prefix} pods; launches on the whole batch")
        entries.append(entry)
        line[cell] = {"caps": [caps.num_nodes, caps.batch_pods], "placed": result.scheduled,
                      "launches": launches, "norm_launches": norm_launches,
                      "held_shape": entry["shape"], "ms": entry["ms"],
                      "plain_ms": entry["plain_ms"], "kernel_equals_plain": True,
                      **{k: entry[k] for k in ("norm_misses", "norm_exchanging_pods")
                         if k in entry}}
        del sched, seen, state, batch, call
    return line, entries


def ext_bound(base, args, ext) -> tuple[float, str]:
    """The bound of a build with the EXT variant: its build's bytes and
    operations (`base()`; they already count every column of the requests,
    allocatable and requested once), plus the port words, read once a node
    and a pod and written once a node (N * 16 + P * 8 bytes), and
    EXT_OPS_PER_PAIR per statically feasible pair; where the batch runs
    NoDiskConflict or MaxPDVolumeCount, the volume words too (N * 48 + P *
    32 bytes: three a node read and written, four a pod), VOL_DISK_OPS per
    feasible pair of a pod with conflict atoms and VOL_ATTACH_OPS per
    attach limit and feasible pair of a pod with attach atoms."""
    base()
    nbytes, ops = BOUND_PARTS[-1]
    p, n = args[0].shape
    feasible = args[0] > float("-inf")
    nbytes, ops = nbytes + 16 * n + 8 * p, ops + EXT_OPS_PER_PAIR * float(feasible.sum())
    if ext.use_nodisk or ext.attach_maxes:
        nbytes += 48 * n + 32 * p
        per_pod = feasible.sum(1).double()
        if ext.use_nodisk:
            disk = ((ext.vol_want_rw != 0) | (ext.vol_want_ro != 0)).any(1)
            ops += VOL_DISK_OPS * float(per_pod[disk].sum())
        if ext.attach_maxes:
            att = (ext.att_onehot != 0).any(1)
            ops += VOL_ATTACH_OPS * len(ext.attach_maxes) * float(per_pod[att].sum())
    return bound(nbytes, ops)


# the EXT variant's carried ledgers (ScanResult and SolverResult fields)
EXT_LEDGERS = ("new_port_count", "new_vol_any", "new_vol_rw", "new_attach")


def compare_ext(torch, got, want) -> float:
    """compare_scan plus the host-port, conflict and attach counts."""
    err = compare_scan(torch, got, want)
    for f in EXT_LEDGERS:
        a, b = getattr(got, f), getattr(want, f)
        if (a is None) != (b is None) or (a is not None and not torch.equal(a, b)):
            raise AssertionError(f"assign_scan EXT kernel != plain on {f}")
        if a is not None:
            err = max(err, max_abs_err(torch, [(a, b)]))
    return err


def ext_hazard_inputs(torch, rng, dev, n, p, hot=False):
    """A seeded kernel-2 batch for the EXT variant (scan_inputs' requests in
    runs, changed): a third of the nodes with 1 or 2 GPUs (some holding one
    already), scratch on most, overlay allocatable on half (the rest take
    overlay requests from scratch); a GPU, scratch or overlay request on a
    pod drawn a pod, not a run, so that consecutive pods equal in cpu and
    memory differ in them (the term cache's key), with half the pods
    repeating the previous pod's (hits); pods asking only a GPU or only
    scratch (cpu = memory = 0); host ports mostly from three ids (1, 37 and
    63: a high word and its sign bit), one listed twice on some pods, and
    accounted counts of 1 to 3 on a node. With `hot`, every pod fits only
    six nodes, whose GPUs, scratch and ports run out mid-batch. Returns
    (the scan arguments, ExtInputs)."""
    from kubernetes_tpu_torch.ops.assign_scan import ExtInputs

    ms, reqs, nz, alloc, requested, nonzero, rr = scan_inputs(torch, rng, dev, p, n)
    a, q, r = alloc.cpu().numpy(), requested.cpu().numpy(), reqs.cpu().numpy()
    gpu_nodes = rng.random(n) < 0.33
    a[:, 3] = np.where(gpu_nodes, rng.integers(1, 3, n), 0)
    q[:, 3] = np.where(gpu_nodes & (rng.random(n) < 0.3), 1, 0)
    a[:, 4] = np.where(rng.random(n) < 0.85, rng.integers(1, 9, n) * 1024, 0)
    a[:, 5] = np.where(rng.random(n) < 0.5, rng.integers(1, 5, n) * 1024, 0)
    q[:, 4] = np.floor(a[:, 4] * rng.random(n) * 0.5)
    q[:, 5] = np.floor(a[:, 5] * rng.random(n) * 0.5)
    r[:, 3] = rng.random(p) < 0.35
    r[:, 4] = np.where(rng.random(p) < 0.25, rng.choice([512, 1024, 2048], p), 0)
    r[:, 5] = np.where(rng.random(p) < 0.2, rng.choice([256, 512, 1024], p), 0)
    only = np.flatnonzero(rng.random(p) < 0.1)
    r[only, 1:3] = 0
    r[only, 3] = only % 2
    r[only, 4] = np.where(only % 2, 0, 1024)
    r[only, 5] = 0
    onehot = np.zeros((p, EXT_PORTS), np.float32)
    want = np.flatnonzero(rng.random(p) < 0.4)
    port = np.where(rng.random(want.size) < 0.8, rng.choice([1, 37, 63], want.size),
                    rng.integers(0, EXT_PORTS, want.size))
    onehot[want, port] = np.where(rng.random(want.size) < 0.1, 2.0, 1.0)
    same = np.flatnonzero(rng.random(p) < 0.5)
    same = same[same > 0]
    for i in same:   # ascending: a run copies its first pod's
        r[i, 3:] = r[i - 1, 3:]
        onehot[i] = onehot[i - 1]
    counts = np.where(rng.random((n, EXT_PORTS)) < 0.04,
                      rng.integers(1, 4, (n, EXT_PORTS)), 0).astype(np.float32)
    ms = ms.clone()
    if hot:
        nodes = rng.choice(n, 6, replace=False)
        keep = ms[:, nodes].clone()
        ms[:] = float("-inf")
        ms[:, nodes] = torch.where(keep > float("-inf"), keep, 20.0)
        a[nodes, 0] = 64
        a[nodes, 1:3] = [64000, 65536]
        q[nodes, :3] = 0

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)

    return ((ms, t(r), nz, t(a), t(q), nonzero, rr),
            ExtInputs(use_ports=True, port_onehot=t(onehot), port_count=t(counts)))


def ext_shared_node_gang(torch, rng, dev, n, p):
    """A seeded EXT batch with gang groups that revert on a node two or
    more members share, in blocks of 10 rows: a group of 4 at quorum 4
    whose first three members fit one roomy node only (its GPUs, scratch
    and overlay, no overlay allocatable), each asking a GPU, 1Gi of scratch
    or 512Mi of overlay and a host port of its own, and whose fourth fits
    nowhere (reverted after three members on one node), then 6 pods fitting
    only that node that ask the same GPUs and ports (they fit only if the
    revert gave them back); the last rows one more group, open at the end.
    Returns (the scan arguments, ExtInputs, GangInputs)."""
    from kubernetes_tpu_torch.ops.assign_scan import GangInputs

    (ms, reqs, nz, alloc, requested, nonzero, rr), ext = ext_hazard_inputs(
        torch, rng, dev, n, p)
    ms = ms.clone()
    alloc, requested, reqs = alloc.clone(), requested.clone(), reqs.clone()
    onehot = ext.port_onehot.clone()
    gid = np.zeros(p, np.int32)
    gmin = np.zeros(p, np.int32)
    k = 0
    for start in range(0, p - 10 + 1, 10):
        k += 1
        roomy = int(rng.integers(0, n))
        rows = torch.arange(start, start + 10, device=dev)
        ms[rows] = float("-inf")
        ms[rows, roomy] = 100020.0
        ms[start + 3] = float("-inf")   # the fourth member fits nowhere
        alloc[roomy] = torch.tensor([16.0, 64000.0, 65536.0, 3.0, 4096.0, 0.0], device=dev)
        requested[roomy] = 0.0
        ext.port_count[roomy] = 0.0
        gid[start:start + 4], gmin[start:start + 4] = k, 4
        for j in range(10):
            m = j % 4 if j < 4 else (j - 4) % 3
            reqs[start + j, 3:] = torch.tensor(
                [[1.0, 0.0, 0.0], [0.0, 1024.0, 0.0], [0.0, 0.0, 512.0],
                 [1.0, 1024.0, 0.0]][m], device=dev)
            onehot[start + j] = 0.0
            onehot[start + j, 10 + m] = 1.0
    tail = p - (p // 10) * 10 or 2
    gid[-tail:], gmin[-tail:] = k + 1, tail

    def t(a):
        return torch.from_numpy(a).to(dev)

    return ((ms, reqs, nz, alloc, requested, nonzero, rr),
            dataclasses.replace(ext, port_onehot=onehot),
            GangInputs(gang_id=t(gid), gang_min=t(gmin)))


def ext_hazards_phase(torch, rng, dev) -> dict:
    """The main and gang builds with the EXT variant against their plain
    versions at every RUN (EXT_SHAPES), without and with the normalization
    flag (norm_test_inputs), max_abs_err 0, on: ext_hazard_inputs' batch
    (GPUs exhausted mid-batch on nodes with 1 or 2, many pods on few ports,
    a port listed twice, accounted counts up to 3, pods asking only a GPU
    or only scratch, nodes with and without overlay allocatable,
    consecutive pods equal in cpu and memory but not in GPU or ports) and
    its hot variant (six nodes take every pod), each also with the gang
    carry on groups that revert (with_reverts); ext_shared_node_gang's
    reverts on a node three members share; and, at the first shape, the
    traffics that force the flag's guess to miss (norm_miss_inputs, with
    the EXT variant over them), each miss counted by the host replay, which
    takes the EXT fit. Returns the phase line."""
    from kubernetes_tpu_torch.ops import assign_scan as scan
    from kubernetes_tpu_torch.ops import solver

    errs: dict = {}
    reverted = 0
    misses: dict = {}

    def held(args, ext, gang=None, norm=None):
        nonlocal reverted
        name = "assign_scan_ext" if gang is None else "assign_scan_gang_ext"
        extra = (ext,) if gang is None else (ext, gang)
        got = getattr(scan, name)(*args, 1.0, 1.0, *extra, norm)
        want = getattr(scan, f"{name}_plain")(*args, 1.0, 1.0, *extra, norm)
        key = name + ("+norm" if norm is not None else "")
        errs[key] = max(errs.get(key, 0.0), compare_ext(torch, got, want))
        if gang is not None:
            reverted += int(solver.gang_member_mask(gang.gang_id, gang.gang_min,
                                                    want.assignments, want.scores)[3])
        return name, (*args, 1.0, 1.0, *extra), got

    for p_, n_ in EXT_SHAPES:
        cases = [ext_hazard_inputs(torch, rng, dev, n_, p_),
                 ext_hazard_inputs(torch, rng, dev, n_, p_, hot=True)]
        for args, ext in cases:
            gargs, gang = with_reverts(torch, rng, dev, args)
            for a_, g_ in ((args, None), (gargs, gang)):
                held(a_, ext, g_)
                ms_, norm_ = norm_test_inputs(torch, rng, dev, a_[0])
                held((ms_, *a_[1:]), ext, g_, norm_)
        sargs, ext, gang = ext_shared_node_gang(torch, rng, dev, n_, p_)
        held(sargs, ext, gang)
        ms_, norm_ = norm_test_inputs(torch, rng, dev, sargs[0])
        held((ms_, *sargs[1:]), ext, gang, norm_)
    p_, n_ = EXT_SHAPES[0]
    for kind in NORM_MISS_KINDS:
        base, ext = ext_hazard_inputs(torch, rng, dev, n_, p_)
        margs, mnorm = norm_miss_inputs(torch, rng, dev, base, kind)
        gargs, gang = with_reverts(torch, rng, dev, margs)
        for a_, g_ in ((margs, None), (gargs, gang)):
            name, args, got = held(a_, ext, g_, mnorm)
            m, x = norm_misses(name, args, mnorm, got)
            misses[f"{name}_{kind}"] = [m, x]
    runs = sorted({scan.node_run(n_) for _, n_ in EXT_SHAPES})
    if runs != list(scan.RUNS):
        raise AssertionError(f"ext_hazards checked {runs}, built {scan.RUNS}")
    if reverted == 0:
        raise AssertionError("ext_hazards: no group reverted")
    if not all(m > 0 for m, _x in misses.values()):
        raise AssertionError(f"ext_hazards: a forced-miss traffic missed nothing {misses}")
    return {"phase": "ext_hazards", "shapes": [list(x) for x in EXT_SHAPES], "runs": runs,
            "max_abs_err": errs, "groups_reverted": reverted,
            "forced_misses_of_exchanging_pods": misses, "kernels_equal_plain": True}


def vol_hazard_inputs(torch, rng, dev, n, p, hot=False):
    """ext_hazard_inputs' batch (GPUs, storage and host ports, with `hot`
    its six nodes that take every pod) with volumes over universes of
    VOL_UNIVERSE conflict and attach atoms, drawn mostly from atoms 0, 1,
    31, 32 and 63 (both halves of the word and its sign bit): nodes holding
    1 or 2 conflict atoms (a third of them one read-write) and 1 or 2
    attach atoms, counts up to 2; pods mounting an atom read-write (a disk
    listed twice on some) or read-only, or both, wanting 1 or 2 attach
    atoms, a few with the attach fail bit, half of the pods repeating the
    previous pod's volumes (the term cache's hits); attach types cycled
    over EBS, GCE, Azure and ANY, the limits VOL_LIMITS (which bite on the
    hot nodes). Returns (the scan arguments, ExtInputs)."""
    args, ext = ext_hazard_inputs(torch, rng, dev, n, p, hot)
    u = VOL_UNIVERSE
    hot_atoms = np.array([0, 1, 31, 32, 63])

    def atoms(k):
        return np.where(rng.random(k) < 0.7, rng.choice(hot_atoms, k),
                        rng.integers(0, u, k))

    nodes = np.arange(n)
    vol_any = np.zeros((n, u), np.float32)
    vol_rw = np.zeros((n, u), np.float32)
    attach = np.zeros((n, u), np.float32)
    held = rng.random(n) < 0.3
    first = atoms(n)
    np.add.at(vol_any, (nodes[held], first[held]), rng.integers(1, 3, n)[held])
    two = held & (rng.random(n) < 0.3)
    np.add.at(vol_any, (nodes[two], atoms(n)[two]), 1.0)
    rw = held & (rng.random(n) < 0.35)
    vol_rw[nodes[rw], first[rw]] = vol_any[nodes[rw], first[rw]]
    present = rng.random(n) < 0.4
    np.add.at(attach, (nodes[present], atoms(n)[present]), rng.integers(1, 3, n)[present])
    two = present & (rng.random(n) < 0.4)
    np.add.at(attach, (nodes[two], atoms(n)[two]), 1.0)
    pods = np.arange(p)
    want_rw = np.zeros((p, u), np.float32)
    want_ro = np.zeros((p, u), np.float32)
    att = np.zeros((p, u), np.float32)
    kind = rng.random(p)
    rwp, rop = kind < 0.2, (kind >= 0.2) & (kind < 0.45)
    both = rwp & (rng.random(p) < 0.2)
    want_rw[pods[rwp], atoms(p)[rwp]] = np.where(rng.random(p) < 0.1, 2.0, 1.0)[rwp]
    want_ro[pods[rop | both], atoms(p)[rop | both]] = 1.0
    attp = rng.random(p) < 0.4
    att[pods[attp], atoms(p)[attp]] = 1.0
    two = attp & (rng.random(p) < 0.4)
    att[pods[two], atoms(p)[two]] = 1.0
    fail = rng.random(p) < 0.03
    for i in np.flatnonzero(rng.random(p) < 0.5):
        if i > 0:   # ascending: a run copies its first pod's
            want_rw[i], want_ro[i], att[i], fail[i] = (want_rw[i - 1], want_ro[i - 1],
                                                       att[i - 1], fail[i - 1])

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    return args, dataclasses.replace(
        ext, use_nodisk=True, vol_want_rw=t(want_rw), vol_want_ro=t(want_ro),
        vol_any=t(vol_any), vol_rw=t(vol_rw), attach_maxes=VOL_LIMITS,
        att_onehot=t(att), att_fail=t(fail, torch.bool), attach_count=t(attach),
        attach_type=t(np.arange(u) % 4, torch.int32))


def vol_shared_node_gang(torch, rng, dev, n, p):
    """ext_shared_node_gang's groups (three members on one roomy node, the
    fourth fitting nowhere, so the group reverts; then 6 pods fitting only
    that node) with volumes on empty ledgers: member m of a group mounts
    conflict atom 10 + m read-write and wants attach atom 20 + m (of types
    EBS, GCE and Azure), and the 6 pods after it ask the same, pod k for
    member k % 3's: the first three fit only if the revert gave the words
    back, the last three then conflict on the disk. Returns (the scan
    arguments, ExtInputs, GangInputs)."""
    args, ext, gang = ext_shared_node_gang(torch, rng, dev, n, p)
    u = VOL_UNIVERSE
    want_rw = np.zeros((p, u), np.float32)
    att = np.zeros((p, u), np.float32)
    for start in range(0, p - 10 + 1, 10):
        for j in (0, 1, 2, 4, 5, 6, 7, 8, 9):
            m = j if j < 4 else (j - 4) % 3
            want_rw[start + j, 10 + m] = 1.0
            att[start + j, 20 + m] = 1.0

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    zeros = np.zeros((n, u), np.float32)
    return args, dataclasses.replace(
        ext, use_nodisk=True, vol_want_rw=t(want_rw), vol_want_ro=t(np.zeros_like(want_rw)),
        vol_any=t(zeros), vol_rw=t(zeros), attach_maxes=VOL_LIMITS, att_onehot=t(att),
        att_fail=t(np.zeros(p, np.bool_), torch.bool), attach_count=t(zeros),
        attach_type=t(np.arange(u) % 4, torch.int32)), gang


def vol_hazards_phase(torch, rng, dev) -> dict:
    """The main and gang builds with the EXT variant's volumes against their
    plain versions at every RUN (EXT_SHAPES), without and with the
    normalization flag (norm_test_inputs), max_abs_err 0, on
    vol_hazard_inputs' batch and its hot variant (the universes filled to
    64 atoms, atoms run out mid-batch, disks listed twice, fail bits,
    consecutive pods equal but in their volumes), each also with the gang
    carry on groups that revert (with_reverts); vol_shared_node_gang's
    reverts on a node three members share, which must give the words back;
    and, at the first shape, the traffics that force the flag's guess to
    miss (norm_miss_inputs over the volume batch), each miss counted by the
    host replay, which takes the volume fit. Every pod with the fail bit
    must be left out, and some pod must be refused by the disk check.
    Returns the phase line."""
    from kubernetes_tpu_torch.ops import assign_scan as scan
    from kubernetes_tpu_torch.ops import solver

    errs: dict = {}
    reverted = 0
    misses: dict = {}
    refused = 0

    def held(args, ext, gang=None, norm=None):
        nonlocal reverted
        name = "assign_scan_ext" if gang is None else "assign_scan_gang_ext"
        extra = (ext,) if gang is None else (ext, gang)
        got = getattr(scan, name)(*args, 1.0, 1.0, *extra, norm)
        want = getattr(scan, f"{name}_plain")(*args, 1.0, 1.0, *extra, norm)
        key = name + ("+norm" if norm is not None else "")
        errs[key] = max(errs.get(key, 0.0), compare_ext(torch, got, want))
        if bool((want.assignments[ext.att_fail] >= 0).any()):
            raise AssertionError("vol_hazards: a pod with the attach fail bit placed")
        if gang is not None:
            reverted += int(solver.gang_member_mask(gang.gang_id, gang.gang_min,
                                                    want.assignments, want.scores)[3])
        return name, (*args, 1.0, 1.0, *extra), got, want

    for p_, n_ in EXT_SHAPES:
        for hot in (False, True):
            args, ext = vol_hazard_inputs(torch, rng, dev, n_, p_, hot)
            gargs, gang = with_reverts(torch, rng, dev, args)
            for a_, g_ in ((args, None), (gargs, gang)):
                held(a_, ext, g_)
                ms_, norm_ = norm_test_inputs(torch, rng, dev, a_[0])
                held((ms_, *a_[1:]), ext, g_, norm_)
        sargs, ext, gang = vol_shared_node_gang(torch, rng, dev, n_, p_)
        _name, _args, _got, want = held(sargs, ext, gang)
        # the last three of each block's six conflict on the disk
        last = torch.tensor([s + j for s in range(0, p_ - 9, 10) for j in (7, 8, 9)],
                            device=dev)
        refused += int((want.assignments[last] < 0).sum())
        ms_, norm_ = norm_test_inputs(torch, rng, dev, sargs[0])
        held((ms_, *sargs[1:]), ext, gang, norm_)
    p_, n_ = EXT_SHAPES[0]
    for kind in NORM_MISS_KINDS:
        base, ext = vol_hazard_inputs(torch, rng, dev, n_, p_)
        margs, mnorm = norm_miss_inputs(torch, rng, dev, base, kind)
        gargs, gang = with_reverts(torch, rng, dev, margs)
        for a_, g_ in ((margs, None), (gargs, gang)):
            name, args, got, _want = held(a_, ext, g_, mnorm)
            misses[f"{name}_{kind}"] = list(norm_misses(name, args, mnorm, got))
    runs = sorted({scan.node_run(n_) for _, n_ in EXT_SHAPES})
    if runs != list(scan.RUNS):
        raise AssertionError(f"vol_hazards checked {runs}, built {scan.RUNS}")
    if reverted == 0 or refused == 0:
        raise AssertionError(f"vol_hazards: {reverted} groups reverted, {refused} pods "
                             f"refused by a disk")
    if not all(m > 0 for m, _x in misses.values()):
        raise AssertionError(f"vol_hazards: a forced-miss traffic missed nothing {misses}")
    return {"phase": "vol_hazards", "shapes": [list(x) for x in EXT_SHAPES], "runs": runs,
            "universes": [VOL_UNIVERSE, VOL_UNIVERSE], "limits": [list(x) for x in VOL_LIMITS],
            "max_abs_err": errs, "groups_reverted": reverted,
            "disk_refusals_after_a_revert": refused,
            "forced_misses_of_exchanging_pods": misses, "kernels_equal_plain": True}


def volumes_batch_pods(caps, group: bool = False, revert: bool = False):
    """The volumes cell's first batch of pods; with `group` in all-or-nothing
    groups of VOLUMES_GANG at full quorum, and with `revert` the last member
    of every VOLUMES_REVERT_EVERY-th group also mounting an unbound claim
    (its attach fails: the group reverts and gives its volumes back)."""
    from kubernetes_tpu_torch.gang import GROUP_MIN_ANNOTATION, GROUP_NAME_ANNOTATION
    from kubernetes_tpu_torch.perf.harness import volumes_pods

    pods = volumes_pods(caps.batch_pods)
    if group:
        for i, pod in enumerate(pods):
            pod.metadata.annotations = {
                GROUP_NAME_ANNOTATION: f"volumes-{i // VOLUMES_GANG}",
                GROUP_MIN_ANNOTATION: str(VOLUMES_GANG)}
        if revert:
            stride = VOLUMES_GANG * VOLUMES_REVERT_EVERY
            for pod in pods[VOLUMES_GANG - 1::stride]:
                pod.spec.volumes = pod.spec.volumes + [
                    {"name": "late", "persistentVolumeClaim": {"claimName": "unbound-0"}}]
    return pods


def volumes_fresh_cluster(caps, dev, taint=False, tight=False, node_affinity=0):
    """A fresh volumes cluster (perf/harness.py volumes_cluster): with
    `taint` one PreferNoSchedule taint on node 0, with `tight` a Scheduler
    made under KUBE_MAX_PD_VOLS=VOLUMES_TIGHT_LIMIT, with `node_affinity`
    that many PVs with node affinity and the VolumeNode gate on."""
    import os

    from kubernetes_tpu_torch.perf.harness import volumes_cluster

    if tight:
        os.environ["KUBE_MAX_PD_VOLS"] = str(VOLUMES_TIGHT_LIMIT)
    try:
        return volumes_cluster(HEADLINE_NODES, caps, dev, node_kwargs={
            "prefer_taint_every": HEADLINE_NODES} if taint else None,
            node_affinity_pvs=node_affinity)
    finally:
        os.environ.pop("KUBE_MAX_PD_VOLS", None)


def volumes_first_batch(torch, dev, group=False, revert=False, taint=False, tight=False):
    """The volumes cell's first batch (volumes_batch_pods) as the driver
    solves it on a fresh cluster (volumes_fresh_cluster): (caps, state,
    batch, flags, the Scheduler's policy)."""
    from kubernetes_tpu_torch.perf.harness import volumes_caps

    caps = volumes_caps(HEADLINE_NODES, HEADLINE_PODS)
    sched = volumes_fresh_cluster(caps, dev, taint, tight)
    chunk, gang_id, gang_min = next(iter(sched.batches(
        volumes_batch_pods(caps, group, revert))))
    state, batch, flags, _victims, _slots = sched.prepare_chunk(chunk, gang_id, gang_min)
    return caps, state, batch, flags, sched.policy


def unplaceable(pod) -> bool:
    """A volumes-cell pod no node can take: a claim not found, or not bound."""
    return any(v.get("persistentVolumeClaim", {}).get("claimName", "").startswith(
        ("missing-", "unbound-")) for v in pod.spec.volumes)


def check_volume_placements(sched, pods, placements, node_affinity: int = 0) -> dict:
    """The volumes cell's placements held on the host: the unplaceable pods
    (`unplaceable`) and only they left out; no pod mounting a dataset disk
    read-only on a node whose bound pod holds it read-write; every claim's
    pod in its PV's zone (claim-k's PV is in zone-{k % 3}) and, for the
    `node_affinity` PVs with node affinity, on a node it names (nodes k %
    3, k % 3 + 9, ... below 30); no node past its distinct GCE PDs under
    the Scheduler's limit (the host attach counts); and the device's
    conflict and attach counts after a flush equal to the host's. Returns
    the counts."""
    from kubernetes_tpu_torch.perf.harness import (VOLUMES_BOUND_EVERY, VOLUMES_DATA_DISKS,
                                                   ZONE_LABEL)
    from kubernetes_tpu_torch.state.layout import VolType

    db = sched.statedb
    left = sorted(k for k, v in placements.items() if v is None)
    want_left = sorted(p.key for p in pods if unplaceable(p))
    if left != want_left:
        raise AssertionError(f"volumes: unplaced {left[:8]}, want {want_left[:8]}")
    row_of = db.table.row_of
    zone_of = {name: db.table.labels_of[row][ZONE_LABEL] for name, row in row_of.items()}
    read_only = claims = 0
    for pod in pods:
        node = placements[pod.key]
        if node is None:
            continue
        i = int(node.split("-")[1])
        for v in pod.spec.volumes:
            gce = v.get("gcePersistentDisk")
            if gce and gce.get("readOnly"):
                read_only += 1
                if i % VOLUMES_BOUND_EVERY == 0 and gce["pdName"] == (
                        f"data-{(i // VOLUMES_BOUND_EVERY) % VOLUMES_DATA_DISKS}"):
                    raise AssertionError(f"volumes: {pod.key} mounts {gce['pdName']} "
                                         f"read-only on {node}, which holds it read-write")
            claim = v.get("persistentVolumeClaim")
            if claim:
                claims += 1
                k = int(claim["claimName"].split("-")[1])
                if zone_of[node] != f"zone-{k % 3}":
                    raise AssertionError(f"volumes: {pod.key} in {zone_of[node]}, its PV "
                                         f"in zone-{k % 3}")
                if k < node_affinity and i not in range(k % 3, 30, 9):
                    raise AssertionError(f"volumes: {pod.key} on {node}, outside its PV's "
                                         f"node affinity")
    host = db.host
    gce = np.array([db.table.attach_types.get(a) in (VolType.GCE, VolType.ANY)
                    for a in range(host.attach_count.shape[1])])
    per_node = (host.attach_count[:, gce] > 0).sum(1)
    if per_node.max() > sched.policy.max_gce_pd_volumes:
        raise AssertionError(f"volumes: a node holds {per_node.max()} GCE PDs, the limit "
                             f"is {sched.policy.max_gce_pd_volumes}")
    dev = db.flush()
    for f in ("vol_any", "vol_rw", "attach_count"):
        if not np.array_equal(getattr(dev, f).cpu().numpy(), getattr(host, f)):
            raise AssertionError(f"volumes: the device's {f} != the host's")
    return {"unplaced": len(left), "read_only_mounts": read_only, "claims": claims,
            "max_gce_pds_on_a_node": int(per_node.max()),
            "conflict_atoms": len(db.table.vol_atoms),
            "attach_atoms": len(db.table.attach_atoms)}


def volumes_phase(torch, dev, kernels) -> tuple[dict, list]:
    """The volumes cell (perf/harness.py volumes_cluster, volumes_pods:
    bench[headline]'s 15,000 nodes, 24 zonal GCE PVs bound by claims and 4
    unbound claims, a bound pod holding a dataset disk read-write on every
    10th node; 30,000 pods with a token secret and an emptyDir, every 4th
    mounting a dataset disk read-only, every 8th a claim, 4 a claim not
    found and 4 an unbound claim) through Scheduler(device="cuda"), the
    universes at 64: the 8 unplaceable pods left out and every other placed
    (check_volume_placements), the main build with EXT launched once a
    batch (and no other build), the first and last batch equal to the plain
    path on the state and batch the driver solved them on. Then the cell's
    first batch through fresh clusters: with KUBE_MAX_PD_VOLS=1 (a node
    holding a GCE PD takes no second; the main build with EXT, held whole);
    in groups of 8 (the gang build with EXT); that with one member of every
    8th group on an unbound claim (those groups revert and give their
    volumes back); the tight limit with one PreferNoSchedule taint on node
    0 (the main build with EXT and the flag); the groups with the taint
    (the gang build with EXT and the flag); and with the VolumeNode gate on
    and 2 PVs with node affinity (Phase A's VolumeNode) — each launched
    once and held against the plain path (the variants on their first 256
    pods). Returns (the phase line, the kernels-line entries, named with
    `[volumes]`)."""
    from kubernetes_tpu_torch.ops import solver
    from kubernetes_tpu_torch.perf.harness import (measure, volumes_caps, volumes_cluster,
                                                   volumes_pods)
    from kubernetes_tpu_torch.scheduler import driver

    caps = volumes_caps(HEADLINE_NODES, HEADLINE_PODS)
    pods = volumes_pods(HEADLINE_PODS)
    sched = volumes_cluster(HEADLINE_NODES, caps, dev)
    seen = []
    solve = record_solves(torch, driver, VOLUMES_CHECKED, seen)
    _count_launches(kernels, reset=True)
    try:
        result = measure(sched, pods)
    finally:
        driver.schedule_batch = solve
    launches, norm_launches = _count_launches(kernels)
    odd = sum(map(unplaceable, pods))   # VOLUMES_UNPLACEABLE at the cell's 30,000
    if result.scheduled != HEADLINE_PODS - odd:
        raise AssertionError(f"volumes: placed {result.scheduled}/{HEADLINE_PODS}")
    want = {name: 0 for name in launches}
    want.update(static_mask=result.batches, assign_scan_ext=result.batches)
    if launches != want or any(norm_launches.values()):
        raise AssertionError(f"volumes: launches {launches}, with the flag "
                             f"{norm_launches}, over {result.batches} batches")
    checks = check_volume_placements(sched, pods, result.placements)
    for k in VOLUMES_CHECKED[1:]:   # (the first: its kernels-line entry, below)
        (state, batch, rr, flags), got = seen[k]
        if not (flags.vol and flags.attach):
            raise AssertionError(f"volumes: batch {k} raises {flags}")
        head = scope_batch(batch, GPU_PORTS_SCOPE)
        kern = solver.schedule_batch(state, head, rr, sched.policy, flags, caps)
        compare_solves(torch, kern, solver.schedule_batch_plain(
            state, head, rr, sched.policy, flags, caps), f"volumes batch {k}")
        held_solve(torch, got, f"volumes batch {k}", scope=GPU_PORTS_SCOPE)(kern)
    (state, batch, rr, flags), got = seen[0]
    call = scan_call(torch, state, batch, flags, caps)
    if call[0] != "assign_scan_ext" or call[4] is not None or rr != 0:
        raise AssertionError(f"volumes: the first batch runs {call[0]}")
    entry = norm_entry(torch, call, launches["assign_scan_ext"],
                       also=held_solve(torch, got, "volumes batch 0"))
    entries = [{**entry, "name": entry["name"] + "[volumes]"}]
    line = {"phase": "volumes", "nodes": HEADLINE_NODES, "pods": HEADLINE_PODS,
            "caps": [caps.num_nodes, caps.batch_pods, caps.volume_universe,
                     caps.attach_universe], **run_fields(result), "launches": launches,
            "checked_batches_equal_plain": list(VOLUMES_CHECKED), **checks,
            "first_batch_ms": entry["ms"], "first_batch_plain_ms": entry["plain_ms"]}
    del sched, seen, state, batch, call

    def first_batch_run(what, group=False, revert=False, taint=False, tight=False,
                        node_affinity=0):
        """One batch of the cell's first pods through a fresh cluster:
        (the kernels-line entry, the run's line)."""
        batch_pods = volumes_batch_pods(caps, group, revert)
        fresh = volumes_fresh_cluster(caps, dev, taint, tight, node_affinity)
        rec = []
        prev = record_solves(torch, driver, (0,), rec)
        _count_launches(kernels, reset=True)
        try:
            res = measure(fresh, batch_pods)
        finally:
            driver.schedule_batch = prev
        got_launches, got_norm = _count_launches(kernels)
        build = "assign_scan_gang_ext" if group else "assign_scan_ext"
        expect = {name: 0 for name in got_launches}
        expect.update({"static_mask": 1, build: 1})
        if got_launches != expect or got_norm[build] != int(taint):
            raise AssertionError(f"volumes {what}: launches {got_launches}, with the "
                                 f"flag {got_norm}")
        run = {} if group else check_volume_placements(fresh, batch_pods, res.placements,
                                                       node_affinity)
        (state, batch, rr, flags), got = rec[0]
        scope = None if what == "tight" else GPU_PORTS_SCOPE
        call = scan_call(torch, state, batch if scope is None else scope_batch(batch, scope),
                         flags, caps, policy=fresh.policy)
        if call[0] != build or (call[4] is None) == taint or rr != 0:
            raise AssertionError(f"volumes {what}: the batch runs {call[0]}")
        entry = norm_entry(torch, call, got_norm[build] if taint else got_launches[build],
                           also=held_solve(torch, got, f"volumes {what}",
                                           call[3][10] if group else None, scope))
        if scope is not None:
            entry = scoped(entry, scope)
        run.update({"placed": res.scheduled, "ms": entry["ms"], "plain_ms": entry["plain_ms"],
                    "gang_placed": res.gang_placed, "gang_reverted": res.gang_reverted,
                    **{k: entry[k] for k in ("norm_misses", "norm_exchanging_pods")
                       if k in entry}})
        if group:
            groups = caps.batch_pods // VOLUMES_GANG
            reverts = len({i // VOLUMES_GANG for i, pod in enumerate(batch_pods)
                           if unplaceable(pod)})
            if (res.gang_reverted, res.gang_placed) != (reverts, groups - reverts):
                raise AssertionError(f"volumes {what}: {res.gang_placed} groups placed, "
                                     f"{res.gang_reverted} reverted, want {reverts} reverted")
        del fresh, rec, state, batch, call
        return {**entry, "name": entry["name"] + "[volumes]"}, run

    for what, kw in (("tight", {"tight": True}), ("gang", {"group": True}),
                     ("gang_reverting", {"group": True, "revert": True}),
                     ("flag", {"tight": True, "taint": True}),
                     ("gang_flag", {"group": True, "taint": True}),
                     ("volume_node", {"node_affinity": VOLUMES_NODE_AFFINITY_PVS})):
        entry, line[what] = first_batch_run(what, **kw)
        if what in ("gang", "flag", "gang_flag"):
            entries.append(entry)
    return line, entries


def gpu_ports_batch_pods(caps, group: bool = False, revert: bool = False):
    """The gpu_ports cell's first batch of pods; with `group` in
    all-or-nothing groups of GPU_PORTS_GANG at full quorum, and with
    `revert` one member (the last) of every GPU_PORTS_REVERT_EVERY-th group
    asking 9 GPUs, which no node has."""
    from kubernetes_tpu_torch.gang import GROUP_MIN_ANNOTATION, GROUP_NAME_ANNOTATION
    from kubernetes_tpu_torch.perf.fixtures import make_pods
    from kubernetes_tpu_torch.perf.harness import GPU, GPU_PORTS_PODS

    pods = make_pods(caps.batch_pods, **GPU_PORTS_PODS)
    if group:
        for i, pod in enumerate(pods):
            pod.metadata.annotations = {
                GROUP_NAME_ANNOTATION: f"gpu-ports-{i // GPU_PORTS_GANG}",
                GROUP_MIN_ANNOTATION: str(GPU_PORTS_GANG)}
        if revert:
            stride = GPU_PORTS_GANG * GPU_PORTS_REVERT_EVERY
            for pod in pods[GPU_PORTS_GANG - 1::stride]:
                pod.spec.containers[0].requests[GPU] = "9"
    return pods


def gpu_ports_first_batch(torch, dev, group: bool = False, revert: bool = False,
                          taint: bool = False):
    """The gpu_ports cell's first batch (gpu_ports_batch_pods) as the
    driver solves it on the cell's cluster (with `taint`, one
    PreferNoSchedule taint on node 0): (caps, state, batch, flags)."""
    from kubernetes_tpu_torch.perf.harness import default_caps, gpu_ports_cluster

    caps = default_caps(HEADLINE_NODES, HEADLINE_PODS)
    sched = gpu_ports_cluster(HEADLINE_NODES, caps, dev, node_kwargs={
        "prefer_taint_every": HEADLINE_NODES} if taint else None)
    chunk, gang_id, gang_min = next(iter(sched.batches(
        gpu_ports_batch_pods(caps, group, revert))))
    state, batch, flags, _victims, _slots = sched.prepare_chunk(chunk, gang_id, gang_min)
    return caps, state, batch, flags


def held_solve(torch, got, what: str, gang=None, scope: int | None = None):
    """A check for norm_entry: the driver's SolverResult `got` equal to the
    plain scan's result on the batch it solved (the member mask applied
    with `gang`): every field, or with `scope` the assignments, scores and
    feasible counts of the first `scope` pods (the scan is serial, so a
    prefix's are the whole batch's)."""
    from kubernetes_tpu_torch.ops import solver

    def check(want):
        a, sc = want.assignments, want.scores
        if gang is not None:
            a, sc, _placed, _reverted = solver.gang_member_mask(gang.gang_id, gang.gang_min,
                                                                 a, sc)
        n = a.shape[0] if scope is None else scope
        pairs = {"assignments": (got.assignments[:n], a), "scores": (got.scores[:n], sc),
                 "feasible_counts": (got.feasible_counts[:n], want.feasible_counts)}
        if scope is None:
            pairs.update({f: (getattr(got, f), getattr(want, f)) for f in (
                "new_requested", "new_nonzero", "rr_end", *EXT_LEDGERS)})
        for f, (x, y) in pairs.items():
            if (x is None) != (y is None) or (x is not None and not torch.equal(x, y)):
                raise AssertionError(f"{what}: the driver's solve != plain on {f}")
    return check


def gpu_ports_preempt(torch, dev) -> dict:
    """A batch with priorities and GPU requests through the EXT scan and
    then kernel 3 on its ledger, through Scheduler(device="cuda"): the
    gpu_ports cluster at GPU_PREEMPT_NODES nodes (its bound pods the
    victims), a wave of GPU_PREEMPT_PODS pods of 8 GPUs at priority 1000.
    The main build with EXT and kernel 3 launch once each; the driver's
    solve equals schedule_batch_plain with the same VictimTable (verdicts
    included); some pods are placed, some get a verdict. Returns the
    phase's sub-line."""
    from kubernetes_tpu_torch.ops import solver
    from kubernetes_tpu_torch.perf.fixtures import make_pods
    from kubernetes_tpu_torch.perf.harness import GPU, gpu_ports_cluster
    from kubernetes_tpu_torch.scheduler import driver
    from kubernetes_tpu_torch.state.layout import Capacities

    caps = Capacities(num_nodes=1 << (GPU_PREEMPT_NODES - 1).bit_length(),
                      batch_pods=1 << (GPU_PREEMPT_PODS - 1).bit_length())
    sched = gpu_ports_cluster(GPU_PREEMPT_NODES, caps, dev)
    wave = make_pods(GPU_PREEMPT_PODS, name_prefix="gpu-wave", priority=1000,
                     extra_requests=((1, 0, {GPU: "8"}),))
    seen = []
    solve = driver.schedule_batch

    def recording(state, batch, rr, policy, flags, caps_, **kw):
        keep = dataclasses.replace(state, **{f.name: getattr(state, f.name).clone()
                                             for f in dataclasses.fields(state)})
        result = solve(state, batch, rr, policy, flags, caps_, **kw)
        seen.append(((keep, batch, rr, flags, kw.get("victims")), result))
        return result

    driver.schedule_batch = recording
    # (the wrappers the solver launches)
    scan_ext, kernel3 = solver.assign_scan_ext, solver.preemption_pass
    scan_ext.launches = kernel3.launches = 0
    try:
        placed = sched.schedule(wave)
    finally:
        driver.schedule_batch = solve
    launches = (scan_ext.launches, kernel3.launches)
    (state, batch, rr, flags, victims), got = seen[0]
    if len(seen) != 1 or victims is None or not (flags.gpu and flags.preempt) \
            or launches != (1, 1):
        raise AssertionError(f"gpu_ports preempt: {len(seen)} batches, {flags}, "
                             f"launches (EXT scan, kernel 3) {launches}")
    want = solver.schedule_batch_plain(state, batch, rr, solver.DEFAULT_POLICY, flags, caps,
                                       victims=victims)
    for f in ("assignments", "scores", "feasible_counts", "new_requested", "preempt_node",
              "victim_count"):
        if not torch.equal(getattr(got, f), getattr(want, f)):
            raise AssertionError(f"gpu_ports preempt: kernel path != plain on {f}")
    n_placed = sum(v is not None for v in placed.values())
    if not (0 < n_placed < len(wave) and sched.preemptions):
        raise AssertionError(f"gpu_ports preempt: {n_placed} placed, "
                             f"{len(sched.preemptions)} verdicts")
    return {"nodes": GPU_PREEMPT_NODES, "pods": len(wave), "placed": n_placed,
            "verdicts": len(sched.preemptions), "launches": list(launches),
            "kernel_path_equals_plain": True}


def gpu_ports_phase(torch, dev, kernels) -> tuple[dict, list]:
    """The gpu_ports cell (perf/harness.py GPU_PORTS_NODES, GPU_PORTS_PODS,
    gpu_ports_cluster: bench[headline]'s 15,000 nodes, every 4th with 8
    GPUs, every one 100Gi of scratch and no overlay, a bound host-port pod
    on every 10th; 30,000 pods asking GPUs, scratch, overlay and host ports
    8080 and 9100) through Scheduler(device="cuda"): every pod placed, no
    node past its GPUs or scratch (the host's ledger), no host port twice
    on a node (the flushed device counts equal the host's, none above 1),
    the main build with EXT launched once a batch (and no other build), the
    first and last batch equal to the plain path on the state and batch the
    driver solved them on. Then the cell's first batch through a fresh
    cluster: in groups of 8 at quorum 8 (the gang build with EXT); that
    again with one member of every 8th group asking 9 GPUs (those 64 groups
    revert and give back their GPUs, scratch and ports); and with one
    PreferNoSchedule taint on node 0 that no pod tolerates, as it is and in
    groups of 8 (the flag's EXT instances) — each launched once, held
    against the plain path and timed there; and a wave of priority pods
    asking GPUs through the EXT scan and kernel 3 (gpu_ports_preempt).
    Returns (the phase line, the kernels-line entries: main, main with the
    flag, gang, gang with the flag)."""
    from kubernetes_tpu_torch.ops import solver
    from kubernetes_tpu_torch.ops.assign_scan import assign_scan
    from kubernetes_tpu_torch.perf.fixtures import make_pods
    from kubernetes_tpu_torch.perf.harness import (GPU_PORTS_PODS, default_caps,
                                                   gpu_ports_cluster, measure, warm)
    from kubernetes_tpu_torch.scheduler import driver
    from kubernetes_tpu_torch.state.layout import Resource

    caps = default_caps(HEADLINE_NODES, HEADLINE_PODS)
    warm(caps, solver.DEFAULT_POLICY, dev, pod_kwargs=GPU_PORTS_PODS)
    pods = make_pods(HEADLINE_PODS, **GPU_PORTS_PODS)
    sched = gpu_ports_cluster(HEADLINE_NODES, caps, dev)
    seen = []
    solve = record_solves(torch, driver, GPU_PORTS_CHECKED, seen)
    _count_launches(kernels, reset=True)
    try:
        result = measure(sched, pods)
    finally:
        driver.schedule_batch = solve
    launches, norm_launches = _count_launches(kernels)
    if result.scheduled != HEADLINE_PODS:
        raise AssertionError(f"gpu_ports: placed {result.scheduled}/{HEADLINE_PODS}")
    want = {name: 0 for name in launches}
    want.update(static_mask=result.batches, assign_scan_ext=result.batches)
    if launches != want or any(norm_launches.values()):
        raise AssertionError(f"gpu_ports: launches {launches}, with the flag "
                             f"{norm_launches}, over {result.batches} batches")
    host = sched.statedb.host
    if not ((host.requested[:, Resource.GPU] <= host.allocatable[:, Resource.GPU]).all()
            and (host.requested[:, Resource.SCRATCH] + host.requested[:, Resource.OVERLAY]
                 <= host.allocatable[:, Resource.SCRATCH]).all()
            and (host.requested[:, :3] <= host.allocatable[:, :3]).all()):
        raise AssertionError("gpu_ports: a node past its allocatable")
    ports = sched.statedb.flush().port_count.cpu().numpy()
    if not (np.array_equal(ports, host.port_count) and ports.max() == 1.0):
        raise AssertionError("gpu_ports: host ports twice on a node, or the device "
                             "counts differ from the host's")
    for k in GPU_PORTS_CHECKED[1:]:   # (the first: its kernels-line entry, below)
        (state, batch, rr, flags), got = seen[k]
        if not (flags.ports and flags.gpu and flags.storage):
            raise AssertionError(f"gpu_ports: batch {k} raises {flags}")
        head = scope_batch(batch, GPU_PORTS_SCOPE)
        kern = solver.schedule_batch(state, head, rr, solver.DEFAULT_POLICY, flags, caps)
        compare_solves(torch, kern, solver.schedule_batch_plain(
            state, head, rr, solver.DEFAULT_POLICY, flags, caps), f"gpu_ports batch {k}")
        held_solve(torch, got, f"gpu_ports batch {k}", scope=GPU_PORTS_SCOPE)(kern)
    (state, batch, rr, flags), got = seen[0]
    call = scan_call(torch, state, batch, flags, caps)
    if call[0] != "assign_scan_ext" or call[4] is not None or rr != 0:
        raise AssertionError(f"gpu_ports: the first batch runs {call[0]}")
    entries = {"assign_scan+ext": norm_entry(torch, call, launches["assign_scan_ext"],
                                             also=held_solve(torch, got, "gpu_ports batch 0"))}
    line = {"phase": "gpu_ports", "nodes": HEADLINE_NODES, "pods": HEADLINE_PODS,
            "caps": [caps.num_nodes, caps.batch_pods], **run_fields(result),
            "launches": launches, "checked_batches_equal_plain": list(GPU_PORTS_CHECKED),
            "gpus_placed": int(host.requested[:, Resource.GPU].sum()),
            "port_rows_in_use": int((ports > 0).sum()),
            "first_batch_ms": entries["assign_scan+ext"]["ms"],
            "first_batch_plain_ms": entries["assign_scan+ext"]["plain_ms"],
            **timed(torch, lambda: assign_scan(*call[3][:9]), 5,
                    "first_batch_without_ext_ms")}
    del sched, seen, state, batch, call

    def first_batch_run(what, group, revert, taint):
        """One batch of the cell's first pods through a fresh cluster:
        (the kernels-line entry, the run's line)."""
        batch_pods = gpu_ports_batch_pods(caps, group, revert)
        fresh = gpu_ports_cluster(HEADLINE_NODES, caps, dev, node_kwargs={
            "prefer_taint_every": HEADLINE_NODES} if taint else None)
        rec = []
        prev = record_solves(torch, driver, (0,), rec)
        _count_launches(kernels, reset=True)
        try:
            res = measure(fresh, batch_pods)
        finally:
            driver.schedule_batch = prev
        got_launches, got_norm = _count_launches(kernels)
        build = "assign_scan_gang_ext" if group else "assign_scan_ext"
        expect = {name: 0 for name in got_launches}
        expect.update({"static_mask": 1, build: 1})
        if got_launches != expect or got_norm[build] != int(taint):
            raise AssertionError(f"gpu_ports {what}: launches {got_launches}, with the "
                                 f"flag {got_norm}")
        (state, batch, rr, flags), got = rec[0]
        # (with the flag, held and timed on the batch's first pods)
        scope = GPU_PORTS_SCOPE if taint else None
        call = scan_call(torch, state, batch if scope is None else scope_batch(batch, scope),
                         flags, caps)
        if call[0] != build or (call[4] is None) == taint or rr != 0:
            raise AssertionError(f"gpu_ports {what}: the batch runs {call[0]}")
        entry = norm_entry(torch, call, got_norm[build] if taint else got_launches[build],
                           also=held_solve(torch, got, f"gpu_ports {what}",
                                           call[3][10] if group else None, scope))
        if scope is not None:
            entry = scoped(entry, scope)
        run = {"placed": res.scheduled, "ms": entry["ms"], "plain_ms": entry["plain_ms"],
               "gang_placed": res.gang_placed, "gang_reverted": res.gang_reverted,
               **{k: entry[k] for k in ("norm_misses", "norm_exchanging_pods")
                  if k in entry}}
        if group:
            groups = caps.batch_pods // GPU_PORTS_GANG
            reverts = groups // GPU_PORTS_REVERT_EVERY if revert else 0
            if (res.gang_reverted, res.gang_placed) != (reverts, groups - reverts):
                raise AssertionError(f"gpu_ports {what}: {res.gang_placed} groups placed, "
                                     f"{res.gang_reverted} reverted")
        del fresh, rec, state, batch, call
        return entry, run

    for what, group, revert, taint in (("gang", True, False, False),
                                       ("gang_reverting", True, True, False),
                                       ("flag", False, False, True),
                                       ("gang_flag", True, False, True)):
        entry, line[what] = first_batch_run(what, group, revert, taint)
        entries.setdefault(entry["name"], entry)
    line["preempt"] = gpu_ports_preempt(torch, dev)
    return line, list(entries.values())


def preemption_bound(inputs, fits: int) -> tuple[float, str]:
    """Kernel 3's bound on one batch's operands: the VictimTable, the taking
    part pods' static rows, the ledger and allocatable, the pods' columns
    and the two outputs once each; or the operations its data needs (the
    plain pass's count of fit checks, `tally`)."""
    n, s = inputs.victims.prio.shape
    p, r = inputs.requests.shape
    part = inputs.part
    m = int(part.sum())
    feasible = int((inputs.masked_static[part] > float("-inf")).sum())
    nbytes = (n * s * (4 + 4 * r + 1) + m * n * 4 + 2 * n * r * 4
              + p * (4 * r + 4 + 1 + 4) + 2 * p * 4)
    ops = feasible * (PREEMPT_SLOT_OPS * s + r) + fits * (r + PREEMPT_FIT_OPS)
    return bound(nbytes, ops)


def widened(torch, inputs, copies: int, pods: int, seed: int):
    """`inputs` with its node axis tiled `copies` times under one seeded
    permutation (every node-side operand and the static rows alike), the
    batch cut to its first `pods` pods."""
    from kubernetes_tpu_torch.ops.preemption import VictimTable

    n = inputs.allocatable.shape[0]
    perm = torch.randperm(n * copies, generator=torch.Generator().manual_seed(seed))
    perm = perm.to(inputs.allocatable.device)

    def nodes(t, dim=0):
        return torch.cat([t] * copies, dim).index_select(dim, perm).contiguous()

    v = inputs.victims
    return dataclasses.replace(
        inputs, allocatable=nodes(inputs.allocatable),
        base_requested=nodes(inputs.base_requested),
        masked_static=nodes(inputs.masked_static[:pods], 1),
        requests=inputs.requests[:pods].contiguous(),
        priority=inputs.priority[:pods].contiguous(),
        part=inputs.part[:pods].contiguous(), gang_id=inputs.gang_id[:pods].contiguous(),
        victims=VictimTable(nodes(v.prio), nodes(v.req), nodes(v.ok)))


def class_churn(torch, inputs, pods: int, seed: int):
    """`inputs` cut to its first `pods` pods (or all), each pod's (priority, cpu
    request) drawn from PREEMPT_CHURN_PRIORITIES x PREEMPT_CHURN_CPU
    under a seed."""
    from kubernetes_tpu_torch.state.layout import Resource

    rng = np.random.default_rng(seed)
    pods = min(pods, inputs.requests.shape[0])
    cls = rng.integers(0, len(PREEMPT_CHURN_PRIORITIES) * len(PREEMPT_CHURN_CPU), pods)
    dev = inputs.requests.device
    requests = inputs.requests[:pods].clone()
    requests[:, Resource.CPU] = torch.tensor(
        [PREEMPT_CHURN_CPU[c % len(PREEMPT_CHURN_CPU)] for c in cls], device=dev)
    priority = torch.tensor([PREEMPT_CHURN_PRIORITIES[c // len(PREEMPT_CHURN_CPU)]
                             for c in cls], dtype=torch.int32, device=dev)
    return dataclasses.replace(
        inputs, masked_static=inputs.masked_static[:pods].contiguous(),
        requests=requests, priority=priority, part=inputs.part[:pods].contiguous(),
        gang_id=inputs.gang_id[:pods].contiguous())


def revert_reused_nodes(inputs, node, raw_node) -> int:
    """Nodes a reverted gang group booked (its members' raw verdicts, the
    mask hid them) that a later group's raw verdicts name again: the
    revert gave them back, so their verdicts were evaluated again."""
    gid = inputs.gang_id.tolist()
    raw, masked = raw_node.tolist(), node.tolist()
    part = inputs.part.tolist()
    restored, pending, reused, cur = set(), set(), set(), None
    for i, g in enumerate(gid):
        if g != cur:   # the group left: its hidden bookings were reverted
            restored |= pending
            pending, cur = set(), g
        if not part[i] or g <= 0 or raw[i] < 0:
            continue
        if raw[i] in restored:
            reused.add(raw[i])
        if masked[i] < 0:
            pending.add(raw[i])
    return len(reused)


def preemption_phase(torch, dev, kernels) -> tuple[dict, dict]:
    """The preemption cell's drill through the driver, then kernel 3 against
    its plain version on each variant's post-scan operands and on the wide
    one (phase 13 of the module docstring). Returns (the phase line, the
    kernels-line entry)."""
    from kubernetes_tpu_torch.ops.preemption import (
        TAG,
        card_smem_limit,
        gang_verdict_mask,
        pass_schedule,
        preemption_layout,
        preemption_pass,
        preemption_pass_plain,
    )
    from kubernetes_tpu_torch.perf.harness import (
        preemption_caps,
        preemption_cluster,
        preemption_drill,
        preemption_pass_inputs,
    )

    sched, wave = preemption_cluster(PREEMPT_NODES, "uniform", dev)
    # the uniform operands: the drill's first batch, before its removals
    held = {"uniform": preemption_pass_inputs(sched, wave)}
    for k in kernels:
        k.launches = 0
    drill = preemption_drill(sched, wave)
    launches = {k.__name__: k.launches for k in kernels}
    if not all(launches.values()):
        raise AssertionError(f"kernels not launched in the preemption drill: {launches}")
    if drill.verdicts != drill.wave or not set(drill.victim_counts) <= {1, 2}:
        raise AssertionError(f"preemption: {drill.verdicts}/{drill.wave} verdicts, "
                             f"k {sorted(set(drill.victim_counts))}")
    if drill.bound_wave != drill.wave or drill.victims != sum(drill.victim_counts):
        raise AssertionError(f"preemption: {drill.bound_wave}/{drill.wave} landed "
                             f"after removing {drill.victims} victims")
    del sched, wave
    caps = preemption_caps(PREEMPT_NODES)
    line = {"phase": "preemption", "nodes": drill.n_nodes,
            "caps": [caps.num_nodes, caps.batch_pods, caps.victim_slots],
            "wave": drill.wave, "verdicts": drill.verdicts, "victims": drill.victims,
            "k_counts": {str(k): drill.victim_counts.count(k)
                         for k in sorted(set(drill.victim_counts))},
            "bound_wave": drill.bound_wave, "verdict_seconds": drill.verdict_seconds,
            "rebind_seconds": drill.rebind_seconds, "launches": launches}
    entry = {"name": "preemption_pass", "route": "cuda",
             "source": "kubernetes_tpu_torch/csrc/preemption.cu",
             "replaces": "kubernetes_tpu/ops/solver.py:948",
             "launches": launches["preemption_pass"], "library_ms": None}

    def held_against_plain(name, inputs, tally=None):
        """Kernel 3 against the plain pass without the gang mask (a
        group's revert shows in the later groups' verdicts, which the mask
        hides), and with it where the batch has groups. Returns (the masked
        verdicts, the raw ones, the plain pass's seconds, the error)."""
        args = inputs.args()
        got = preemption_pass(*args, False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = preemption_pass_plain(*args, False, tally=tally)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        pairs = [(got, want)]
        if inputs.use_gang:
            pairs.append((preemption_pass(*args, True),
                          gang_verdict_mask(inputs.gang_id, inputs.part, *want)))
        for kind, (g, w) in zip(("raw", "masked"), pairs):
            for a, b, column in zip(g, w, ("preempt_node", "victim_count")):
                if not torch.equal(a, b):
                    raise AssertionError(f"preemption {name}: kernel 3 != plain on "
                                         f"{int((a != b).sum())} pods' {kind} {column}")
        err = max_abs_err(torch, [ab for g, w in pairs for ab in zip(g, w)])
        return pairs[-1][1], want, plain_s, err

    def verdict_stats(inputs, node, count, plain_s) -> dict:
        found = node >= 0
        return {"pods": int(inputs.part.sum()), "verdicts": int(found.sum()),
                "k_counts": {str(k): int((count[found] == k).sum())
                             for k in sorted(set(count[found].tolist()))},
                "plain_seconds": plain_s}

    errs, variants = [], {}
    for variant in PREEMPT_VARIANTS:
        inputs = held.pop(variant, None) or preemption_pass_inputs(
            *preemption_cluster(PREEMPT_NODES, variant, dev))
        tally: dict = {}
        (node, count), (raw_node, _), plain_s, err = held_against_plain(
            variant, inputs, tally)
        errs.append(err)
        stats = verdict_stats(inputs, node, count, plain_s)
        if variant == "gang":
            members = inputs.part & (inputs.gang_id > 0)
            hidden = members & (raw_node >= 0) & (node < 0)
            stats["members_without_verdict"] = int((members & (node < 0)).sum())
            # groups whose members found nodes the mask then hid: past the
            # first reverted group, only on nodes its revert gave back,
            # whose cached verdicts the kernel must have evaluated again
            stats["groups_hidden"] = len(set(inputs.gang_id[hidden].tolist()))
            stats["revert_reused_nodes"] = revert_reused_nodes(inputs, node, raw_node)
            if not (0 < stats["members_without_verdict"] < int(members.sum())
                    and stats["groups_hidden"] >= 2 and stats["revert_reused_nodes"] > 0):
                raise AssertionError(f"preemption gang: no group reverted, none "
                                     f"found sets, or none after a revert: {stats}")
        if variant == "mixed":
            if len(stats["k_counts"]) < 2:
                raise AssertionError(f"preemption mixed: one k only: {stats}")
            mixed = inputs
        if variant != "gang":
            stats.update(timed(torch, lambda: preemption_pass(
                *inputs.args(), inputs.use_gang), reps=5))
            stats["bound_ms"], stats["bound_by"] = preemption_bound(inputs, tally["fits"])
        if variant == "uniform":
            entry.update({k: stats[k] for k in ("ms", "ms_min", "ms_max",
                                                "bound_ms", "bound_by")})
            entry["plain_ms"] = 1e3 * plain_s
        variants[variant] = stats
        del inputs

    # the wide check: the read-only columns read through L2, the bookings
    # in the blocks' arena, which a cluster past 32,768 nodes takes
    wide = widened(torch, mixed, PREEMPT_WIDE_COPIES, PREEMPT_WIDE_PODS, seed=13)
    n_wide, s = wide.victims.prio.shape
    lay = preemption_layout(n_wide, s, wide.requests.shape[1], card_smem_limit(dev))
    if not {"alloc", "base", "prio", "req"} <= set(lay.l2) or "extra" in lay.shared:
        raise AssertionError(f"preemption wide: N = {n_wide} keeps its columns "
                             f"in shared memory: {lay}")
    (node, count), _, plain_s, err = held_against_plain("wide", wide)
    errs.append(err)
    stats = {"nodes": n_wide, "layout": dataclasses.asdict(lay),
             **verdict_stats(wide, node, count, plain_s),
             **timed(torch, lambda: preemption_pass(*wide.args(), False), reps=5)}
    if len(stats["k_counts"]) < 2:
        raise AssertionError(f"preemption wide: one k only: {stats}")
    variants["wide"] = stats
    del wide

    # the class-churn check: more classes than a node's verdict entries
    churn = class_churn(torch, mixed, PREEMPT_CHURN_PODS, seed=17)
    del mixed
    n, s = churn.victims.prio.shape
    lay = preemption_layout(n, s, churn.requests.shape[1], card_smem_limit(dev))
    meta = pass_schedule(churn.requests, churn.priority, churn.part, churn.gang_id,
                         lay.entries)
    classes = len(set((meta[:, 2] & TAG).tolist()))
    if classes <= lay.entries:
        raise AssertionError(f"preemption churn: {classes} classes, "
                             f"{lay.entries} entries")
    (node, count), _, plain_s, err = held_against_plain("churn", churn)
    errs.append(err)
    stats = {"classes": classes, "entries": lay.entries,
             **verdict_stats(churn, node, count, plain_s),
             **timed(torch, lambda: preemption_pass(*churn.args(), False), reps=5)}
    if len(stats["k_counts"]) < 2:
        raise AssertionError(f"preemption churn: one k only: {stats}")
    variants["churn"] = stats
    del churn
    entry["max_abs_err"] = max(errs)
    line.update({"variants": variants, "kernel_equals_plain": True})
    return line, entry


def many_class_pod_dicts(n: int) -> list[dict]:
    """n pending pods, each its own equivalence class: make_pods' spec with
    memory requests 250Mi + k KiB (k < n)."""
    return [{"metadata": {"name": f"distinct-{k}", "namespace": "default"},
             "spec": {"containers": [{
                 "name": "app", "image": "k8s.gcr.io/pause:3.0",
                 "resources": {"requests": {"cpu": "100m",
                                            "memory": f"{256000 + k}Ki"}}}]}}
            for k in range(n)]


def check_load(pods, placements: dict, nodes) -> dict:
    """Recompute every node's pods, cpu and memory from the placements on
    the host; raise if one is over its allocatable. Returns the load."""
    from kubernetes_tpu_torch.api.quantity import parse_quantity

    by_key = {p.key: p for p in pods}
    load: dict[str, list] = {}
    for key, node in placements.items():
        acc = load.setdefault(node, [0, 0, 0])
        requests = by_key[key].spec.containers[0].requests
        acc[0] += 1
        acc[1] += parse_quantity(requests["cpu"])
        acc[2] += parse_quantity(requests["memory"])
    alloc_of = {n.metadata.name: n.status.allocatable for n in nodes}
    for node, (npods, cpu, mem) in load.items():
        a = alloc_of[node]
        if (npods > int(a["pods"]) or cpu > parse_quantity(a["cpu"])
                or mem > parse_quantity(a["memory"])):
            raise AssertionError(f"node {node} over allocatable: "
                                 f"{npods} pods, cpu {cpu}, memory {mem}")
    return load


def run_fields(result) -> dict:
    """The timing fields of a harness ThroughputResult."""
    return {"scheduled": result.scheduled, "seconds": result.seconds,
            "pods_per_sec": result.pods_per_sec, "batches": result.batches,
            "ms_per_solve": result.ms_per_solve,
            "ms_encode_per_batch": result.ms_encode_per_batch,
            "cache_hits": result.cache_hits, "cache_misses": result.cache_misses}


def first_batch(torch, dev):
    """The main path's cluster and its first batch of P pods, encoded and
    through Phase A: (caps, nodes, pods, scheduler, state, batch, the scan's
    arguments)."""
    from kubernetes_tpu_torch.ops import solver
    from kubernetes_tpu_torch.perf.fixtures import make_nodes, make_pods
    from kubernetes_tpu_torch.perf.harness import default_caps, warm
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.state.convert import batch_from_numpy
    from kubernetes_tpu_torch.state.pod_batch import encode_pods

    caps = default_caps(HEADLINE_NODES, HEADLINE_PODS)
    assert (caps.num_nodes, caps.batch_pods) == (N, P), caps
    nodes = make_nodes(HEADLINE_NODES, zones=3)
    pods = make_pods(HEADLINE_PODS)
    warm(caps, solver.DEFAULT_POLICY, dev)
    ref = Scheduler(caps, device=dev)
    ref.add_nodes(nodes)
    host_first = encode_pods(pods[:P], caps, ref.statedb.table)
    state = ref.statedb.flush()
    first = batch_from_numpy(host_first, dev)
    g = solver.check_supported(solver.DEFAULT_POLICY,
                               solver.batch_flags(state, first))
    masked = solver.masked_static_scores(state, first, solver.DEFAULT_POLICY, g)
    scan_args = (masked, first.requests, first.nonzero_requests,
                 state.allocatable, state.requested, state.nonzero_requested, 0)
    return caps, nodes, pods, ref, state, first, scan_args


def packed_batch_phase(torch, caps, nodes, pods, dev) -> dict:
    """The first batch through the cache and the blobs against the fresh
    encoding, field by field; raises on any difference."""
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.state.convert import (
        batch_from_numpy,
        host_blobs,
        upload_blobs,
    )
    from kubernetes_tpu_torch.state.encode_cache import EncodeCache
    from kubernetes_tpu_torch.state.pod_batch import (
        BATCH_FIELDS,
        blob_widths,
        encode_pods,
        unpack_batch,
    )

    sched = Scheduler(caps, device=dev)
    sched.add_nodes(nodes)
    table = sched.statedb.table
    cache = EncodeCache(caps, table)
    fpin, ipin = host_blobs(P, *blob_widths(caps), dev)
    fblob, iblob = fpin.numpy(), ipin.numpy()
    # garbage of earlier phases is collected outside each timed region
    gc.collect()
    t0 = time.perf_counter()
    fresh = batch_from_numpy(encode_pods(pods[:P], caps, table), dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    gc.collect()
    t1b = time.perf_counter()
    for i, pod in enumerate(pods[:P]):
        cache.encode_packed_into(fblob, iblob, i, pod)
    t2 = time.perf_counter()
    packed = unpack_batch(*upload_blobs(fpin, ipin, dev), caps)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    for name in BATCH_FIELDS:
        a, b = getattr(packed, name), getattr(fresh, name)
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"packed batch != fresh encoding on {name}")
    return {"phase": "packed_batch", "pods": P, "fields": len(BATCH_FIELDS),
            "blob_widths": list(blob_widths(caps)),
            "blob_bytes": fblob.nbytes + iblob.nbytes,
            "pinned": bool(fpin.is_pinned()),
            "cache_hits": cache.hits, "cache_misses": cache.misses,
            "fresh_encode_upload_ms": 1e3 * (t1 - t0),
            "cached_encode_ms": 1e3 * (t2 - t1b),
            "upload_unpack_ms": 1e3 * (t3 - t2), "equal": True}


def lifecycle_phase(torch, caps, dev, kernels) -> dict:
    """Bound pods, deletions, node removal and row reuse at 15,000 nodes,
    then one batch through the cache, held against the plain path on the
    same flushed state and against a host recompute of every node."""
    from kubernetes_tpu_torch.api.quantity import parse_quantity
    from kubernetes_tpu_torch.ops import solver
    from kubernetes_tpu_torch.perf.fixtures import make_nodes, make_pods
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.state.convert import batch_from_numpy, host_tensor
    from kubernetes_tpu_torch.state.pod_batch import encode_pods

    removed = [f"node-{k}" for k in range(0, HEADLINE_NODES, 150)]
    all_nodes = make_nodes(HEADLINE_NODES + len(removed), zones=3)
    nodes, extra = all_nodes[:HEADLINE_NODES], all_nodes[HEADLINE_NODES:]
    sched = Scheduler(caps, device=dev)
    sched.add_nodes(nodes)
    db, table = sched.statedb, sched.statedb.table
    bound = make_pods(HEADLINE_NODES, cpu="300m", memory="700Mi",
                      name_prefix="bound")
    on = {}
    for k, pod in enumerate(bound):
        on[pod.key] = nodes[k].metadata.name
        if not sched.add_pod(pod, on[pod.key]):
            raise AssertionError(f"{pod.key} not accounted")
    for pod in bound[::15]:
        sched.remove_pod(pod.key)
        del on[pod.key]
    freed = [table.row_of[name] for name in removed]
    for name in removed:
        sched.remove_node(name)
    on = {k: v for k, v in on.items() if v not in set(removed)}
    sched.add_nodes(extra)
    reused = [table.row_of[n.metadata.name] for n in extra]
    if reused != freed[::-1] or any(db.has_node(name) for name in removed):
        raise AssertionError("new nodes did not take the freed rows last-in first-out")
    if [p.key for p in bound if db.is_accounted(p.key)] != list(on):
        raise AssertionError("accounted bound pods differ from the expected set")

    state0 = dataclasses.replace(db.flush())
    pending = make_pods(P, name_prefix="pending")
    first = batch_from_numpy(encode_pods(pending, caps, table), dev)
    for k in kernels:
        k.launches = 0
    placed = sched.schedule(pending)
    launches = {k.__name__: k.launches for k in kernels}
    if not all(launches.values()):
        raise AssertionError(f"kernels not launched in the lifecycle run: {launches}")
    plain = solver.schedule_batch_plain(state0, first, 0)
    compare_scan(torch, sched.last_result, plain)
    names = [table.name_of[r] if r >= 0 else None for r in plain.assignments.tolist()]
    if names != [placed[p.key] for p in pending]:
        raise AssertionError("lifecycle placements != the plain path's")
    # host recompute of every live node: (pods, cpu milli, memory MiB)
    want = np.zeros((caps.num_nodes, 3), np.float64)
    by_key = {p.key: p for p in bound + pending}
    for key, node in list(on.items()) + list(placed.items()):
        if node is None:
            continue
        req = by_key[key].spec.containers[0].requests
        want[table.row_of[node]] += (1, float(parse_quantity(req["cpu"]) * 1000),
                                     float(parse_quantity(req["memory"]) / 2**20))
    got = db.host.requested[:, :3].astype(np.float64)
    if not np.array_equal(got, want):
        raise AssertionError("host ledger != recompute of bound and placed pods")
    alloc = db.host.allocatable[:, :3]
    if (want > alloc).any():
        raise AssertionError("a node is over its allocatable")
    if not torch.equal(db.flush().requested, host_tensor(db.host.requested).to(dev)):
        raise AssertionError("device ledger != host ledger after the batch")
    return {"phase": "lifecycle", "nodes": HEADLINE_NODES, "bound": len(bound),
            "bound_removed": len(bound[::15]), "nodes_removed": len(removed),
            "nodes_added": len(extra), "accounted_bound": len(on),
            "scheduled": sum(v is not None for v in placed.values()),
            "pods": len(pending), "launches": launches,
            "equals_plain": True, "host_recompute_equal": True}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from kubernetes_tpu_torch.api.objects import Pod
    from kubernetes_tpu_torch.native.build import KERNELS, build, build_log
    from kubernetes_tpu_torch.ops import solver
    from kubernetes_tpu_torch.ops.assign_scan import (
        RUNS,
        assign_scan,
        assign_scan_gang,
        assign_scan_gang_plain,
        assign_scan_interpod,
        assign_scan_interpod_plain,
        assign_scan_plain,
        assign_scan_spread,
        assign_scan_spread_interpod,
        assign_scan_spread_interpod_plain,
        assign_scan_spread_plain,
        node_run,
    )
    from kubernetes_tpu_torch.ops.static_mask import static_mask, static_mask_plain
    from kubernetes_tpu_torch.perf.harness import default_caps, measure
    from kubernetes_tpu_torch.scheduler import Scheduler

    # the plain versions' selector/taint counts are matmuls: full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    # ---- 0: device ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # ---- 1: build ----
    t0 = time.perf_counter()
    per_kernel = build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_seconds": per_kernel,
          "ptxas": {k: ptxas_report(build_log(k)) for k in KERNELS}})

    # ---- 2: static_mask at the headline shape ----
    args = static_mask_inputs(torch, rng, dev)
    got = static_mask(*args)
    want = static_mask_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(
            f"static_mask kernel != plain on {int((got != want).sum())} entries")
    mask_err = max_abs_err(torch, [(got, want)])
    sel_onehot, _, untol, _, _, _, sel_member, hard, _, _, _ = args
    k1 = {
        "name": "static_mask", "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/static_mask.cu",
        "replaces": "kubernetes_tpu/ops/pallas_kernels.py:78",
        "max_abs_err": mask_err,
        **timed(torch, lambda: static_mask(*args), reps=20),
        "plain_ms": time_ms(torch, lambda: static_mask_plain(*args), reps=5)[0],
        "library_ms": time_ms(torch, lambda: (
            torch.matmul(sel_onehot, sel_member.T),
            torch.matmul(untol, hard.T)), reps=5)[0],
    }
    k1["bound_ms"], k1["bound_by"] = static_mask_bound(torch, args)
    emit({"phase": "static_mask", "shape": [P, N, US, UT],
          "feasible_share": float(want.float().mean()), **k1})
    del args, got, want

    # ---- 3: assign_scan at the headline shape ----
    caps, nodes, pods, ref, state, first, scan_args = first_batch(torch, dev)
    plain, plain_ms = timed_call(torch, lambda: assign_scan_plain(*scan_args))
    scan_err = compare_scan(torch, assign_scan(*scan_args), plain)

    het = scan_inputs(torch, rng, dev)
    het_err = compare_scan(torch, assign_scan(*het), assign_scan_plain(*het))
    miss = scan_inputs(torch, rng, dev, all_miss=True)
    miss_err = compare_scan(torch, assign_scan(*miss), assign_scan_plain(*miss))
    k2 = {
        "name": "assign_scan", "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/assign_scan.cu",
        "replaces": "kubernetes_tpu/ops/solver.py:733",
        "max_abs_err": max(scan_err, het_err, miss_err),
        **timed(torch, lambda: assign_scan(*scan_args), reps=5),
        "plain_ms": plain_ms,
        "library_ms": None,
    }
    k2["bound_ms"], k2["bound_by"] = scan_bound(*scan_args[:6])
    emit({"phase": "assign_scan", "shape": [P, N],
          **timed(torch, lambda: assign_scan(*het), 3, "heterogeneous_ms"),
          **timed(torch, lambda: assign_scan(*miss), 3, "all_miss_ms"),
          **k2})
    del het, miss, scan_args

    # ---- 3b: ragged shapes (tile edges, node padding) on both kernels; the
    # scan and its spread, interpod and gang builds at an N for each of their
    # builds (1, 2, 4 and 8 nodes per thread); the one-pod shape with a
    # poisoned carried anti term, which rejects every node, and the
    # 100-pod shape under four policies of the interpod build
    shapes = ((1, 65, 60), (100, 1000, 990), (333, 3000, 2900), (64, 1024, 1024),
              (50, 12000, 11900), (16, 30000, 29000), (16, 40000, 39000),
              (8, 65536, 65536))
    for p_, n_, live_ in shapes:
        args = static_mask_inputs(torch, rng, dev, p_, n_, live_)
        if not torch.equal(static_mask(*args), static_mask_plain(*args)):
            raise AssertionError(f"static_mask kernel != plain at P={p_} N={n_}")
        sargs = scan_inputs(torch, rng, dev, p_, n_)
        sargs[0][0] = float("-inf")   # a pod with no feasible node
        compare_scan(torch, assign_scan(*sargs), assign_scan_plain(*sargs))
        spread = spread_inputs(torch, rng, dev, n_, p_)
        compare_spread(torch, assign_scan_spread(*sargs, 1.0, 1.0, spread),
                       assign_scan_spread_plain(*sargs, 1.0, 1.0, spread))
        ip = interpod_inputs(torch, rng, dev, n_, p_, poisoned=p_ == 1)
        # at one shape, the policies that drop the predicate or the
        # priority, or weigh them otherwise, too
        variants = [ip] + ([dataclasses.replace(ip, use_ipa=False),
                            dataclasses.replace(ip, w_ip=0.0),
                            dataclasses.replace(ip, w_ip=2.0, hard_w=5.0)]
                           if (p_, n_) == (100, 1000) else [])
        for v in variants:
            compare_interpod(torch, assign_scan_interpod(*sargs, 1.0, 1.0, v),
                             assign_scan_interpod_plain(*sargs, 1.0, 1.0, v))
        sp_, ip_ = with_spread(torch, rng, ip, zones=3)
        compare_interpod(torch, assign_scan_spread_interpod(*sargs, 1.0, 1.0, sp_, ip_),
                         assign_scan_spread_interpod_plain(*sargs, 1.0, 1.0, sp_, ip_),
                         "spread_interpod")
        gang = random_gang(torch, rng, dev, p_)
        compare_scan(torch, assign_scan_gang(*sargs, 1.0, 1.0, gang),
                     assign_scan_gang_plain(*sargs, 1.0, 1.0, gang))
    runs = sorted({node_run(n_) for _, n_, _ in shapes})
    if runs != list(RUNS):
        raise AssertionError(f"scan builds checked {runs}, built {RUNS}")
    emit({"phase": "edge_shapes", "shapes": [list(x[:2]) for x in shapes],
          "scan_runs": runs, "spread_runs": runs, "interpod_runs": runs,
          "spread_interpod_runs": runs, "gang_runs": runs, "kernels_equal_plain": True})

    # ---- 3c: the spread build's hazards at every RUN: pods of one
    # selector landing on one thread's nodes pod after pod (the count
    # column loaded a pod ahead), pods without an entry between spread
    # pods (the partials' mbarrier parity), and 0, 1, 3 and 64 zones in
    # use with nodes without a zone and ids past the universe
    hz_shapes = ((120, 60), (120, 12000), (120, 30000), (160, 65536))
    for p_, n_ in hz_shapes:
        cases = [spread_hot_inputs(torch, rng, dev, n_, p_)]
        sargs = scan_inputs(torch, rng, dev, p_, n_)
        cases += [(sargs, spread_inputs(torch, rng, dev, n_, p_, zones=z, no_entry=ne))
                  for z, ne in ((3, 0.5), (0, None), (1, None), (64, 0.3))]
        for hargs, spread in cases:
            compare_spread(torch, assign_scan_spread(*hargs, 1.0, 1.0, spread),
                           assign_scan_spread_plain(*hargs, 1.0, 1.0, spread))
    hz_runs = sorted({node_run(n_) for _, n_ in hz_shapes})
    if hz_runs != list(RUNS):
        raise AssertionError(f"spread hazards checked {hz_runs}, built {RUNS}")
    emit({"phase": "spread_hazards", "shapes": [list(x) for x in hz_shapes],
          "runs": hz_runs, "cases": ["one_thread", "no_entry_runs_3_zones",
                                     "0_zones", "1_zone", "64_zones"],
          "kernel_equals_plain": True})

    # ---- 3d: the interpod build's hazards at every RUN: runs of pods
    # placed on one node and on one thread's nodes (the owner's reductions
    # read back by the next pod), the totals moved by pods of the batch
    # (the first-pod escape, an empty-key and a poisoned anti term carried
    # from mid-batch) before the next pod's count list, domain ids -1 and
    # past the universe in the placed node's message, 5 and 16 topology
    # slots (2 and 4 message chunks), zero-row pods between broadcasting
    # ones and quiet pods between counting ones (both mbarriers' phases)
    ih_cases = (("one_node", 8), ("one_thread", 5), ("wide", 16))
    for p_, n_ in hz_shapes:
        for pool, k_ in ih_cases:
            hargs, ip = interpod_hazard_inputs(torch, rng, dev, n_, p_, k_, pool)
            compare_interpod(torch, assign_scan_interpod(*hargs, 1.0, 1.0, ip),
                             assign_scan_interpod_plain(*hargs, 1.0, 1.0, ip))
    emit({"phase": "interpod_hazards", "shapes": [list(x) for x in hz_shapes],
          "runs": hz_runs, "cases": [f"{pool}_k{k_}" for pool, k_ in ih_cases],
          "kernel_equals_plain": True})

    # ---- 3d': the spread+interpod build's hazards at every RUN
    emit(spread_interpod_hazards_phase(torch, rng, dev, hz_shapes))

    # ---- 3e: the 8-node build's hazards: unaligned rows, empty blocks,
    # the ring wrapping mid-batch, all-miss pods and reverts on one node
    emit(run8_phase(torch, rng, dev))

    # ---- 3f: every build with the normalization flag at every RUN: zero
    # maxima, the largest counts on infeasible nodes, ties, padding, odd N
    emit(norm_build_phase(torch, rng, dev))

    # ---- 3g: the gang carry in the spread, interpod and spread+interpod
    # builds at every RUN on reverting batches, with and without the flag
    emit(gang_carry_hazards_phase(torch, rng, dev))

    # ---- 3h: the main and gang builds with the EXT variant (host ports,
    # the gpu and storage fit) at every RUN, with and without the flag
    emit(ext_hazards_phase(torch, rng, dev))

    # ---- 3i: the EXT variant's volumes (NoDiskConflict, MaxPDVolumeCount)
    # in the main and gang builds at every RUN, with and without the flag
    emit(vol_hazards_phase(torch, rng, dev))

    # ---- 4: the first batch through the cache and the blobs ----
    emit(packed_batch_phase(torch, caps, nodes, pods, dev))

    # ---- 5: the main path ----
    sched = Scheduler(caps, device=dev)
    sched.add_nodes(nodes)
    static_mask.launches = 0
    assign_scan.launches = 0
    result = measure(sched, pods)
    k1["launches"] = static_mask.launches
    k2["launches"] = assign_scan.launches
    if result.scheduled != HEADLINE_PODS:
        raise AssertionError(f"placed {result.scheduled}/{HEADLINE_PODS} pods")
    if result.cache_hits + result.cache_misses != HEADLINE_PODS:
        raise AssertionError(f"{result.cache_hits} hits + {result.cache_misses} "
                             f"misses for {HEADLINE_PODS} pods")
    if not (k1["launches"] > 0 and k2["launches"] > 0):
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{k1['launches']}, {k2['launches']}")
    load = check_load(pods, result.placements, nodes)
    # the first batch against the plain path on the card, same inputs
    kern = solver.schedule_batch(state, first, 0)
    plain = solver.schedule_batch_plain(state, first, 0)
    compare_scan(torch, kern, plain)
    names = ref.statedb.table.name_of
    first_names = [names[r] for r in kern.assignments.tolist()]
    if first_names != [result.placements[p.key] for p in pods[:P]]:
        raise AssertionError("main path's first batch != the solver on its inputs")
    emit({"phase": "main_path", "nodes": HEADLINE_NODES, "pods": HEADLINE_PODS,
          "caps": [caps.num_nodes, caps.batch_pods], **run_fields(result),
          "nodes_used": len(load), "max_pods_per_node": max(v[0] for v in load.values()),
          "launches": {"static_mask": k1["launches"], "assign_scan": k2["launches"]},
          "first_batch_equals_plain": True})
    del result, sched, load

    # ---- 6: the main path where every pod misses the encode cache ----
    distinct = [Pod.from_dict(d) for d in many_class_pod_dicts(HEADLINE_PODS)]
    sched = Scheduler(caps, device=dev)
    sched.add_nodes(nodes)
    static_mask.launches = 0
    assign_scan.launches = 0
    result = measure(sched, distinct)
    launches = {"static_mask": static_mask.launches,
                "assign_scan": assign_scan.launches}
    if result.scheduled != HEADLINE_PODS:
        raise AssertionError(f"many classes: placed {result.scheduled}/{HEADLINE_PODS}")
    if (result.cache_hits, result.cache_misses) != (0, HEADLINE_PODS):
        raise AssertionError(f"many classes: {result.cache_hits} hits, "
                             f"{result.cache_misses} misses")
    if not all(launches.values()):
        raise AssertionError(f"kernels not launched on many classes: {launches}")
    load = check_load(distinct, result.placements, nodes)
    emit({"phase": "many_classes", "nodes": HEADLINE_NODES, "pods": HEADLINE_PODS,
          **run_fields(result), "nodes_used": len(load), "launches": launches})
    del result, sched, load, distinct

    # ---- 7: the StateDB's pod and node lifecycle ----
    emit(lifecycle_phase(torch, caps, dev, (static_mask, assign_scan)))

    # ---- 8: bench[spread] ----
    line, k3 = spread_phase(torch, caps, dev,
                            (static_mask, assign_scan, assign_scan_spread,
                             assign_scan_spread_interpod))
    emit(line)
    emit({"phase": "spread_build", "shape": [P, N], **k3})

    # ---- 9: bench[interpod] ----
    ip_caps = default_caps(INTERPOD_NODES, INTERPOD_PODS)
    line, k4 = interpod_phase(torch, ip_caps, dev,
                              (static_mask, assign_scan, assign_scan_spread,
                               assign_scan_interpod, assign_scan_spread_interpod))
    emit(line)
    emit({"phase": "interpod_build",
          "shape": [ip_caps.batch_pods, ip_caps.num_nodes], **k4})

    # ---- 9b: the spread_interpod cell ----
    line, k6 = spread_interpod_phase(
        torch, caps, dev, (static_mask, assign_scan, assign_scan_spread,
                           assign_scan_interpod, assign_scan_spread_interpod,
                           assign_scan_gang))
    emit(line)
    emit({"phase": "spread_interpod_build", "shape": [P, N], **k6})

    # ---- 10: bench[gang] ----
    line, k5 = gang_phase(torch, dev, (static_mask, assign_scan, assign_scan_spread,
                                       assign_scan_interpod, assign_scan_spread_interpod,
                                       assign_scan_gang))
    emit(line)
    emit({"phase": "gang_build_first_batch", "shape": list(k5.pop("shape")), **k5})

    # ---- 11: the gang build on revert-heavy batches at every RUN ----
    gb_shapes = ((100, 60), (160, 3000), (160, 12000), (120, 30000), (200, 65536))
    reverted = []
    for p_, n_ in gb_shapes:
        gargs, gang = revert_heavy_inputs(torch, rng, dev, n_, p_)
        got = assign_scan_gang(*gargs, 1.0, 1.0, gang)
        want = assign_scan_gang_plain(*gargs, 1.0, 1.0, gang)
        compare_scan(torch, got, want)
        _a, _s, n_placed, n_reverted = solver.gang_member_mask(
            gang.gang_id, gang.gang_min, want.assignments, want.scores)
        if int(n_reverted) == 0:
            raise AssertionError(f"gang_build: no group reverted at P={p_} N={n_}")
        reverted.append([int(n_placed), int(n_reverted)])
    gb_runs = sorted({node_run(n_) for _, n_ in gb_shapes})
    if gb_runs != list(RUNS):
        raise AssertionError(f"gang builds checked {gb_runs}, built {RUNS}")
    emit({"phase": "gang_build", "shapes": [list(x) for x in gb_shapes],
          "runs": gb_runs, "groups_placed_reverted": reverted,
          "kernel_equals_plain": True})

    # ---- 11b: the gang_spread_interpod cell, and the gang carry of every
    # build in its cell's first batch
    from kubernetes_tpu_torch.ops.assign_scan import (
        assign_scan_interpod_gang,
        assign_scan_spread_gang,
        assign_scan_spread_interpod_gang,
    )

    every_scan = (static_mask, assign_scan, assign_scan_spread, assign_scan_interpod,
                  assign_scan_spread_interpod, assign_scan_gang, assign_scan_spread_gang,
                  assign_scan_interpod_gang, assign_scan_spread_interpod_gang)
    line, k10 = gang_spread_interpod_phase(torch, dev, every_scan)
    emit(line)
    line, k11 = gang_cells_phase(torch, dev, every_scan)
    emit(line)

    # ---- 12: the tt_na cell (the main build with the normalization flag)
    # and the flag in the other cells' builds ----
    scans = (static_mask, assign_scan, assign_scan_spread, assign_scan_interpod,
             assign_scan_spread_interpod, assign_scan_gang)
    line, k7 = tt_na_phase(torch, caps, dev, scans)
    emit(line)
    emit({"phase": "tt_na_build", **k7})
    line, k8 = norm_cells_phase(torch, dev, scans)
    emit(line)

    # ---- 12b: the gpu_ports cell (the main and gang builds with the EXT
    # variant, with and without the flag)
    from kubernetes_tpu_torch.ops.assign_scan import assign_scan_ext, assign_scan_gang_ext

    line, k12 = gpu_ports_phase(torch, dev, every_scan + (assign_scan_ext,
                                                          assign_scan_gang_ext))
    emit(line)

    # ---- 12c: the volumes cell (the main and gang builds with the EXT
    # variant's volumes, with and without the flag; VolumeZone and
    # VolumeNode in Phase A)
    line, k13 = volumes_phase(torch, dev, every_scan + (assign_scan_ext,
                                                       assign_scan_gang_ext))
    emit(line)

    # ---- 13: the preemption cell and kernel 3 ----
    from kubernetes_tpu_torch.ops.preemption import preemption_pass

    line, k9 = preemption_phase(torch, dev, (static_mask, assign_scan, preemption_pass))
    emit(line)

    # ---- 14: kernels line, card line, result line ----
    # (and `scope`, where an entry's figures are not all of the same inputs)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{**{k: entry[k] for k in keys},
                       **{k: entry[k] for k in ("scope",) if k in entry}}
                      for entry in (k1, k2, k3, k4, k6, k5, k7, *k8, k10, *k11, *k12,
                                    *k13, k9)]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
