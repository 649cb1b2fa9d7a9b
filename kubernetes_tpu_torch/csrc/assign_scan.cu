// Serial assignment scan (Phase B of the batch solver) in one launch.
//
// Replaces the XLA `lax.scan` of kubernetes_tpu/ops/solver.py::schedule_batch
// (`step`, solver.py:733-811, and `_select_host`, :595-614), which has no
// Pallas source. For each pod p in order, against the ledger carried from
// pods 0..p-1:
//   1. feasible = masked_static[p, n] > -inf and the pod, cpu and memory
//      fit (fits_resources_dyn, predicates.py:93-114);
//   2. score = masked_static[p, n] + w_lr * LeastRequested
//      + w_ba * BalancedAllocation over the non-zero ledger
//      (priorities.py:40-72, FLOOR_EPS floor / trunc);
//   3. best = max score over feasible nodes, ntie = ties at best;
//   4. the (rr mod 2^32 % ntie)-th tie in node order is chosen;
//   5. the pod's requests are added to the chosen node's `requested` and
//      `nonzero` rows, and rr += 1.
// A pod with no feasible node gets assignment -1 and score 0.
//
// Design: one thread-block cluster over the node axis.
//
// - One cluster of CLUSTER = 16 blocks (a non-portable size) of 512
//   threads, launched with cudaLaunchKernelEx. Block b owns the node range
//   [b*NB, (b+1)*NB), NB = 512*RUN, and thread t of it the contiguous run
//   of RUN nodes from b*NB + t*RUN, so node order is (block, thread, j)
//   order and a tie's global rank is the ties of lower blocks, plus those
//   of lower warps, plus the ties of lower lanes. Nodes past N are
//   padding: no allocatable, never feasible.
// - Ledger and term cache in shared memory. Each block loads its nodes'
//   allocatable (pods, cpu, mem), requested (pods, cpu, mem), nonzero
//   (cpu, mem) and the two cached terms into dynamic shared memory once,
//   as columns, and writes the ledger back into the caller's [N, 6] and
//   [N, 2] tensors at the end. A node is only ever read or written by the
//   thread that owns it, so a ledger update needs no barrier. The gpu and
//   storage columns of `requested` are never read by the scan; the owner
//   adds a nonzero request to them in device memory (x + 0 == x, so the
//   main path's zero requests cost no load on the scan's critical path).
// - Rows prefetched asynchronously. masked_static and the pods' requests do
//   not depend on the scan, so the next rows of masked_static are kept in
//   flight with cp.async in a ring of STAGES shared-memory slots, and eight
//   threads copy each pod's requests into a ring of pod slots in the same
//   groups. Pod p+3's copies are issued while pod p's triples travel
//   between the blocks, where the threads would otherwise wait; a slot is
//   refilled with row p+3 after pod p's block barrier, and every thread
//   read its old row p-1 before pod p-1's. The pod slots are waited for
//   one pod early and published to the block by that pod's
//   __syncthreads(). At 1, 2 and 4 nodes a thread, each thread copies its
//   own RUN entries, 4 bytes a copy, into the slot's [P, N] layout, and
//   reads back only what it copied, so cp.async.wait_group orders the row.
//   At 8 nodes a thread those copies were eight a thread a pod, each warp
//   instruction 32 sectors for 128 bytes; instead the block's segment of
//   the row is copied coalesced: its 16-byte chunks (every chunk when the
//   segment starts 16-byte aligned, less a tail of N % 4; none when it
//   does not, as when N % 4 != 0 puts row p at an odd offset) as 16-byte
//   copies, chunk t and t + 512 by thread t, and the rest as 4-byte copies,
//   entry i by thread i % 512. A thread then reads entries other threads
//   copied, so the row, like the pod slot, is published one pod early:
//   the wait at the top of pod p covers the thread's copies of row p+1,
//   and pod p's block barrier makes them visible before pod p+1 reads them
//   (pod 0's row: the wait and the cluster barrier before the loop). A
//   block wholly past N copies nothing and keeps the -inf written at the
//   start. The slot is swizzled: 16-byte chunk c sits at c ^ ((c >> 3) & 1)
//   (slot_at), so when each thread reads its run's two chunks, the eight
//   lanes of a quarter warp hit 32 different banks; unswizzled, thread t's
//   chunks lie 32 bytes from its neighbour's and each read conflicts
//   2-way. One bulk copy of the segment a block a pod (cp.async.bulk onto
//   an mbarrier) was measured against these copies on the H100 and was
//   slower (PERF.md).
// - Per pod: each thread scores its run (best, a bit mask of the run
//   positions tied at it, feasible count). The warp reduces (best key,
//   ties at best, feasible) with three redux.sync, the scores mapped to
//   ints that order as the floats do; lane 0 writes the warp's triple to a
//   shared slot; __syncthreads(); warp 0 reduces the 16 warp triples, and
//   lanes 0..15 send the block's triple to every block of the cluster with
//   st.async, each store completing its bytes on the receiving block's
//   mbarrier. A block then waits on its own mbarrier until all 16 triples
//   have landed: no cluster-wide barrier per pod. Every warp reduces the
//   16 block triples itself: the global best, ntie, the feasible total and
//   its block's tie offset, and k = rr % ntie on uint32. Only the block
//   that holds the k-th tie continues: its warp offsets come from the warp
//   slots, lane offsets from one ballot per bit of the thread's tie count,
//   and the owning thread reads the node off its tie mask, updates its
//   ledger row and recomputes that node's terms. At 8 nodes a thread the
//   run's best and ties are taken as a tree (every position's score, -inf
//   where infeasible, three levels of fmaxf, then one compare each), not
//   the eight dependent steps of the loop; the interpod build keeps the
//   loop, whose registers it needs.
// - Slots and mbarriers are double-buffered by pod parity. A block sends
//   its triple of pod p+2 only after it has received every block's triple
//   of pod p+1, and every block sends that only after its own
//   __syncthreads() of pod p+1, which all of its threads pass only after
//   they are done with pod p's slots. So no triple overwrites one still
//   being read, and a barrier's phase for pod p+2 starts only after its
//   phase for pod p has completed.
//
// Term cache. A node's fit, LeastRequested and BalancedAllocation depend
// only on its ledger row and the pod's requests, and one pod changes one
// row. So the kernel keeps both terms per node (LeastRequested -1 for a
// node the pod does not fit), computed for every node whenever a pod's
// request bits differ from the previous pod's; a pod with the same requests
// (replicas of one workload, which batches are mostly made of) reuses them,
// and the owner of the chosen node recomputes that node's entry after its
// ledger update. A reused term is the value the same arithmetic produced on
// the same inputs, so the score is bit-identical to computing it afresh.
// With the node axis over 16 SMs, a pod whose requests differ recomputes
// 1/16 of the nodes on each SM. At 1, 2 and 4 nodes a thread the terms are
// two shared columns; at 8 nodes a thread they are packed in registers,
// since only their owner thread reads and writes them: byte j % 4 of
// lr1[j / 4] holds run position j's LeastRequested + 1, of bab[j / 4] its
// BalancedAllocation. Range: every request and ledger entry is finite and
// non-negative, so with the fit applied LeastRequested is -1 or
// floorf((u_cpu + u_mem) / 2 + eps) with each unused score u =
// floorf((c - r) * 10 / c + eps) in 0..10 (0 when c == 0 or r > c), hence
// 0..10; BalancedAllocation is 0, or truncf((1 - |cf - mf|) * 10 + eps)
// with both fractions in [0, 1), hence 0..10. Exactness: for an integer k
// in 0..255, 2^23 + k is an exact f32 whose low eight bits are k, so
// __fadd_rn(v, 2^23 + 1) and __fadd_rn(v, 2^23) give the bytes, and the
// f32 with the bits 0x4B0000kk (one byte_perm) less the same bias gives v
// back exactly (both operands and the difference are exact). The owner
// rewrites byte j at a run-time shift, which stays in registers where an
// f32 array indexed by a run-time j would go to local memory. A term
// cache hit then reads no shared memory for its terms (four of the six
// 16-byte reads a pod), and the 8-node carve drops the two columns (32 KiB
// a block), which gives every build four row stages at 8 nodes a thread.
//
// Rounding. Every operation that the reference rounds separately is
// written with a round-to-nearest intrinsic (__fadd_rn, __fmul_rn,
// __fdiv_rn, __fsub_rn) and the file is built with --fmad=false, so no
// multiply-add is contracted and floor((c-r)*10/c + 1e-6) and
// trunc((1-|a-b|)*10 + 1e-6) round exactly as the unfused ops do.
//
// Bound on an H100 SXM: the scan must read masked_static once (P*N*4
// bytes, 268 MB at P=4096, N=16384: 80 us at 3.35 TB/s). The serial
// dependency between pods puts a chain of block barrier, DSMEM exchange
// and reductions under every pod, which at 4096 pods is far above 80 us.
//
// The spread build (SPREAD = true, entry ktpu_assign_scan_spread) adds
// SelectorSpread, the JAX step's `selector_spread` term and its
// `ledger_add` of the pod-selector counts (kubernetes_tpu/ops/solver.py:
// 579-581, ops/spread.py:29 selector_spread, ops/interpod.py:253
// ledger_add). The main build (SPREAD = false) compiles to the same
// instructions, in the same order, as before the spread build existed
// (kernel_times.py compares the SASS of two trees): every addition is
// behind `if constexpr (SPREAD)` or unused by it, and its parameters are
// one trailing empty struct. The pod-selector ledger lives in device
// memory as a transposed [UQ, N] copy (the wrapper makes it and returns
// it as [N, UQ]; a column of the row-major ledger would be a 128-byte
// stride per node, and the ledger, 2 MiB at N = 16,384, does not fit
// beside the shared columns). Its per-pod chain:
//   1. the count column is in registers before the pod starts: right
//      after pod p's block barrier (which publishes pod p+1's slot) and
//      before pod p's triple wait, each thread loads its run's counts of
//      column spread_q(p+1) (none when it is -1). The only ledger change
//      between that load and pod p+1 is pod p's placement, whose owner
//      thread adds the pod's match entry of column spread_q(p+1) to its
//      own register copy, so the copy is exact. The load is an ordinary
//      one (an asynchronous copy would not be ordered before the same
//      thread's later store), and a __syncwarp orders it before the
//      owner's warp adds to the cell;
//   2. when spread_q is -1, every node scores MAX_PRIORITY (spread.py:65)
//      and nothing is exchanged; every block reads the same pod row, so
//      all skip together;
//   3. else each thread keeps its feasible counts (masked_static > -inf
//      and the pod fits, as the main scan decides it), and its warp
//      reduces them in integer arithmetic: the max count, whether a
//      feasible node has a zone (GetZoneKey slot TOPO_SPREAD_ZONE), and
//      one redux.sync add for each zone present among the warp's nodes (a
//      node's zone is fixed for the launch, so each warp's set of zones is
//      taken once, at the start); lane 0 writes them to the warp's slot.
//      No shared atomics;
//   4. one block barrier; warp 0 sums the 16 warp slots, lane d zone d,
//      and sends the block's partial to every block of the cluster
//      (st.async onto a third mbarrier, whose phase is the parity of the
//      spread pods seen so far). The partial holds the max count with the
//      any-zoned flag in bit 30 of one word (counts stay below 2^24), then
//      the sums of the Z zones in use (Z from the host: the spread-zone
//      ids interned so far), 1 + Z words in ceil((1 + Z) / 4) 16-byte
//      chunks: one chunk a block for bench[spread]'s 3 zones, not the 17
//      that 64 zones take;
//   5. every warp reduces the 16 block partials itself, as it does the
//      triples: lane d sums zone d (and zone 32 + d) in integer
//      arithmetic, the warp takes the max count, the max zone sum and
//      whether any block has a zoned feasible node, and a thread reads
//      its nodes' zone sums with __shfl_sync. No second block barrier;
//   6. each thread adds w_ss * SelectorSpread to its feasible nodes'
//      scores, then the main scan's selection follows. Its two divisions
//      a node share their divisors (the max count, the max zone sum), so
//      each thread takes their double reciprocals once a pod and
//      multiplies in double; no __fdiv_rn is left on the chain.
// After the choice, the owner's warp adds the pod's match row (in its pod
// slot) to the chosen node's counts in device memory, a column a lane, as
// reductions whose result is not used (red.global.add.f32), so no lane
// waits for a cell's old value to come back from L2. Column u of a node
// is only ever added to by the same lane of the node's owner warp, and
// read (step 1) only by the node's owner thread after the barriers that
// follow the add, so no barrier guards the ledger. The partials of one
// spread pod are all read before any block sends its triple of that pod,
// and a block sends the next spread pod's partials only after it has
// received every triple, so one slot buffer and one mbarrier suffice; a
// wait that never completes traps as the triples' does. A zone id the
// caller did not count (at least Z, below the universe) traps at the
// start.
//
// Exactness. The counts are integers far below 2^24 (a node holds at most
// its pods' capacity, and a zone's sum is at most the pods placed in it),
// so the integer max and sums, in any order, equal the JAX package's
// one-hot matmul (spread.py:45) and its f32 max, and convert to f32
// exactly; an f32 reduction rounds to nearest as __fadd_rn does, and an
// integer count is never subnormal, so the ledger adds are exact too.
// Zone ids from Z up belong to no node, so JAX's sums for them are 0 and
// cannot raise max_zone; an id at or past the universe has a zero one-hot
// row in JAX and is summed by no lane here, but still counts as a zone
// for have_zones, as there. The score is written with the _rn intrinsics
// in spread.py:50-64's order (--fmad=false), and its constants are JAX's
// weakly typed Python floats cast once to f32: (float)(1.0 - 2.0 / 3.0)
// and (float)(2.0 / 3.0). Each division n / y (n an integer-valued f32, y
// an integer below 2^24, the quotient in [0, 10]) is taken as
// (float)((double)n * r) with r = 1 / y rounded to double: two double
// roundings put that product within 2^-52 relative of n / y, while an f32
// rounding midpoint M * 2^-k (M < 2^25) that n / y does not equal lies at
// least 1 / (y * 2^k) away, over 2^-49 relative; so the product rounds to
// the same f32 as n / y itself. (Nodes whose count exceeds the max are
// infeasible, and their score is never read.)
//
// Bound of the spread build: masked_static read once, plus the
// pod-selector ledger read once and written once (N*UQ*4 bytes each way),
// at 3.35 TB/s.
//
// The interpod build (IPA = true, entry ktpu_assign_scan_interpod) adds
// inter-pod (anti-)affinity, the JAX step's `interpod_feasible`,
// `interpod_counts`, `interpod_score` and the carried-term half of
// `ledger_add` (kubernetes_tpu/ops/solver.py:549-551,574-577,783-784;
// ops/interpod.py:152,208,241,253). Like the spread build it sits behind
// `if constexpr (IPA)` with its arguments in one trailing struct, so the
// main and spread builds keep their instructions. (A batch that needs both
// SelectorSpread and inter-pod affinity runs the spread+interpod build,
// below.) State it keeps:
//   - node-level counts: a transposed [UQ+UE, N] copy of the pod-selector
//     and carried-term ledgers (the wrapper makes it, and returns it as
//     [N, UQ] and [N, UE]); column u of node g is added to only by lane
//     u % 32 of g's owner warp and read only by g's owner thread;
//   - domain aggregates dom[K, D, UQ+UE] (the pods matching selector q, or
//     carrying term e, in domain d of topology slot k): one replica per
//     block in block-private device memory ([CLUSTER, K, D, UQ+UE], 2 MiB
//     at K = 8, D = 64, UQ = UE = 32; one is 128 KiB there and up to 512
//     KiB at the build's limits, more than a block's shared memory), which
//     the block copies from the batch-start aggregates at its start and
//     then reads and writes alone;
//   - the totals total_q / total_e and the term attributes in shared
//     memory (the totals replicated per block and touched by warp 0 only,
//     the attributes loaded once).
// Per pod, after the main build's fit and terms:
//   1. two things at once, then one block barrier that publishes both.
//      Warp 0 adds the previous pod's match and carried-term rows to the
//      totals when that pod was placed, then turns the pod row (it rides
//      the pod ring: the required and preferred term slots, ipaff_fail,
//      the match and carried-term rows) and the term attributes into a
//      list of count entries, each a (column, topology code, role,
//      weight): the active carried required anti terms (role: their counts
//      summed must be 0), the carried terms that weigh the pod
//      symmetrically (match x (weight + hard_w for required affinity)),
//      the pod's own required anti (count 0) and affinity terms (count >
//      0, unless none exists anywhere and the pod matches its own term:
//      then the term holds everywhere), and its preferred terms (ppref_w);
//      a carried poisoned anti term with a carrier, an active carried anti
//      term with TKEY_INVALID and a carrier, and ipaff_fail reject every
//      node. Meanwhile, when the previous pod was placed and its rows are
//      not zero, warps 1-15 wait for the placed node's index (below), read
//      its domain ids and add the rows into the block's replica (a (slot,
//      column) cell a thread, slots 1..k-1);
//   2. each thread evaluates the list on its feasible nodes: a count at
//      topology code k reads the node-level column for slot 0 (hostname),
//      the replica at the node's domain for slots 1..K-1, the inclusion-
//      exclusion union for TKEY_DEFAULT_UNION, and 0 for TKEY_INVALID;
//   3. when the list has a weighted entry (else every node's score is 0
//      and nothing is exchanged; every block reads the same list head, so
//      all skip alike), the min and max count over the feasible nodes,
//      clamped through 0, are reduced over the warp, the block and the
//      cluster (st.async onto a fourth mbarrier, its phase the parity of
//      the counting pods seen); each node adds
//      w_ip * trunc(10 (c - min) / max(max - min, 1) + eps) (0 when max ==
//      min) before `best`.
// After the choice, when the pod's match or carried-term row is not zero,
// the owner's warp first sends the node's index to every block (a block a
// lane, st.async onto a fifth mbarrier), then adds the rows to the node's
// counts, a column a lane, as reductions whose result is not used
// (red.global.add.f32): no lane waits for a cell's old value, and no block
// waits for the owner's L2 round trip before its index arrives.
//
// Ordering. The totals depend only on the previous pods' rows, which
// every block holds in its pod ring, and on whether each was placed,
// which every block reads off the triple exchange (ntie > 0); so warp 0
// needs nothing that the index gates, and it builds pod p+1's list while
// pod p's index travels and the other warps update the replica. Warp 0
// alone reads and writes the totals (a __syncwarp orders its lanes' adds
// before the list reads them). The list and the replica are read only
// after step 1's barrier; the previous pod's list was last read before
// that pod's triple barrier, which warp 0 passed before it rewrites the
// list. A block reads the index before step 1's barrier, and the winner
// of the next broadcasting pod sends only after every block's triple of
// that pod, which follows that barrier, so one slot suffices; thread 32
// re-arms the index's mbarrier after its wait, and the next index can
// only arrive after every warp of the block has passed that barrier, so
// no warp misses a phase. A reduction by a lane of the owner's warp at
// pod p is followed, in that lane's program order, by pod p+1's step-1
// block barrier, which the owner thread passes before it reads the column: __syncthreads makes
// every global memory access made before it, reductions included,
// visible to the block's threads after it, so the owner thread's
// ordinary load returns the sum. (An L1-bypassing ld.global.cg of the
// column, the other way to see a reduction made at L2, cost ~0.3 ms a
// batch on bench[interpod]: the owner re-reads its columns pod after
// pod, and an ordinary load finds them in L1.) chip_smoke.py holds runs
// of consecutive pods placed on one node and on one thread's nodes. The
// 8-node build keeps the per-node loop for the run's best (its registers).
//
// Exactness. Every count and weight is an integer-valued f32 far below
// 2^24 (weights are integers: int(weight) and hardPodAffinityWeight), so
// the counts, their weighted sums, the reductions into the node-level
// counts (in any order) and their min and max (reduced as ints) equal the
// JAX package's einsums; an integer count is never subnormal, so the
// reductions' flush-to-zero changes nothing. The score is written with
// the _rn intrinsics in interpod.py:246-250's order.
//
// Bound of the interpod build: masked_static read once, the node-level
// counts read once and written once, the per-pod rows and the domain
// aggregates read once, at 3.35 TB/s; or the count entries' operations
// at 67 TFLOP/s.
//
// The gang build (GANG = true, entry ktpu_assign_scan_gang) adds the
// all-or-nothing group carry of the JAX step (kubernetes_tpu/ops/
// solver.py:738-764, 795-798, and the close-out of 825-853). Like the
// other builds it sits behind `if constexpr (GANG)` with its arguments in
// one trailing struct, so the main, spread and interpod builds keep their
// instructions. Each pod row carries its batch-local group id and its
// group's quorum (two more words of the pod slot). Per pod, before its
// terms:
//   1. where the pod's group id differs from the group open so far, the
//      open group is settled: if fewer of its members were placed than its
//      quorum, it is reverted (below); then, if the pod opens a group, the
//      group's placed count restarts at 0, its quorum is read from the pod
//      row, its undo log is emptied and rr is kept as the group's entry
//      value. Every block reads the same pod rows and sees the same ntie
//      of every pod, so every thread of the cluster keeps the group id,
//      the placed count, the quorum, the entry rr and its block's log
//      length in registers and decides alike: no exchange is added;
//   2. when the owner of the chosen node places a member, it first appends
//      the node's old ledger row (its shared column, requested pods, cpu
//      and memory, nonzero cpu and memory, and the device-memory gpu and
//      storage columns it is about to change) to its own block's undo log
//      in device memory (48 bytes an entry, [CLUSTER, P, 3] float4s; a
//      group's members fit in one batch, so P entries a block suffice).
//      An undo log, not a snapshot: at 8 nodes a thread there is no room
//      for a copy of the ledger in shared memory, and subtracting the
//      members' requests back in f32 is not exact.
// A revert is a block barrier (the log's newest entries, written by their
// owners in the previous pod, become visible) and then every thread walks
// its block's log from the newest entry to the oldest and restores the
// entries of its own nodes, so a node that took two members ends with its
// oldest value, and the ownership rule holds: no barrier after. rr returns
// to the group's entry value (a reverted member's round-robin bump does
// not survive, as in `_live_ledger`), and the request-keyed term cache is
// dropped, since its terms belong to a ledger that no longer exists (at 8
// nodes a thread the packed terms are recomputed at the next pod). The
// group still open after the last pod is settled the same way before the
// ledger is written back, so the written ledger and rr_end are final.
// Assignments and scores are written as the scan makes them; masking the
// members of a reverted group (solver.py:837-853) is a tensor op after the
// launch. Reverts are rare (a group that does not fit), but the carry is
// not free at 8 nodes a thread on bench[gang]: the group check and the
// undo-log append cost ~0.3 ms a 4,096-pod batch each (PERF.md);
// reading the next pod's group during the exchange, loading the pod's row
// before the check, and appending after the owner's terms did not pay.
//
// The spread+interpod build (SPREAD = IPA = true, entry
// ktpu_assign_scan_spread_interpod) runs both in one scan over one ledger,
// as the JAX step does (solver.py:548-551,574-581,783-785): the predicate
// first, then InterPodAffinityPriority and SelectorSpread, each over the
// nodes the predicate leaves. It is the interpod build's chain with the
// spread build's count column, partial and score added, and it changes no
// other build's instructions (every addition behind `if constexpr`). Where
// the two meet:
//   - the pod slot is the interpod build's, with spread_q in its last word
//     (SI_Q); its match row is the one SelectorSpread's owner patch reads;
//   - one ledger: the spread count column a pod ahead is row spread_q(p+1)
//     of the first UQ rows of the [UQ+UE, N] node-level copy, and the
//     owner's warp adds the match and carried-term rows once, after a
//     __syncwarp that orders its lanes' loads of that column, and after it
//     sends the index (the interpod build's order); the owner patches its
//     register copy of the count column as in the spread build;
//   - feasibility first: SelectorSpread counts, maxes and sums over the
//     nodes that pass the predicate (step 2's list), not over the fit alone;
//   - one exchange: after step 2, the spread partial (1 + Z words, when
//     spread_q >= 0) and the (min, max) chunk (when a weighted entry
//     exists) go out as one message, warp 0's lane l sending chunks l / 16,
//     l / 16 + 2, ... to block l % 16, the (min, max) chunk to its own slot,
//     all on the spread mbarrier, after one block barrier; a pod that needs
//     neither sends nothing, and every block decides from the same pod row.
//     Because the message's size depends on the pod, thread 0 arms the
//     mbarrier for this pod's bytes at the exchange, not after the previous
//     wait: a peer's bytes may land before the arm (the mbarrier's tx-count
//     goes below zero, and the phase cannot complete before the arrival
//     that the arm makes), and no peer sends a pod's message before it has
//     every block's triple of the pod before it, so no phase is skipped;
//   - the score: w_ip * priority, then w_ss * SelectorSpread, each added
//     with __fadd_rn in that order; both divisions keep their builds'
//     schemes (the double reciprocals, __fdiv_rn);
//   - the trap on a zone id in [Z, universe) stays.
// It keeps the per-node loop for the run's best at 8 nodes a thread, as the
// interpod build does (its registers). The spread half's partial, its
// reduction and its score are written out again inside the combined
// exchange rather than shared with the spread build's code, which keeps
// that build's instructions as they were; so are the count loop and the
// replica's update, beside the interpod build's.
//
// Its per-pod chain, redesigned for Hopper (each step priced on the
// spread_interpod cell's first batch, P = 4,096, N = 16,384, 2 nodes a
// thread; PERF.md, section 6):
//   1. the block's domain ids live in shared memory as bytes, [IP_MAX_K]
//      [NB], loaded once at the start (1, 2 and 4 nodes a thread; at 8 they
//      stay in device memory, 64 KiB past the carve's room): an id in
//      [0, nd) is itself, -1 is SI_NO_ID and an id at or past nd SI_PAST,
//      which keeps the union's "no zone and no region" test; a count reads
//      the node's id from shared memory, not from the topology in device
//      memory, before it reads the replica;
//   2. the block's replica holds slots 1..k-1 alone (slot 0 is the
//      hostname, read from the node-level counts) and lives in shared
//      memory after the ids where the block has room for it: (k - 1) * nd *
//      (uq + ue) * 4 bytes, 114,688 at the cell's k = 8, nd = 64, uq = ue =
//      32, beside 140,144 bytes of room at 2 nodes a thread; else it stays
//      in device memory (dom_b points at slot 1 either way). A count is then
//      two shared loads after its entry, and warps 1-15 add the placed
//      node's rows in shared memory, not with an L2 round trip a cell;
//   3. the count loop takes the entries outside and the run's nodes inside,
//      so one entry's loads for the run's nodes are independent; each node
//      still takes its entries in list order (the sums are exact anyway);
//   4. the placed node's message carries its ids of slots 1..8 as bytes,
//      read from the owner block's ids (k <= 9, 1-4 nodes a thread), so
//      warps 1-15 update the replica without loading the node's topology row
//      from device memory; it is still sent after the owner's ledger update
//      and terms, which lie on the owner warp's way to the next pod;
//   5. with at most SI_FAST_ZONES = 4 zones in use, a warp sums its zones
//      in two words, zone 2i + h in bits 16h to 16h + 15 of word i: two
//      redux.sync where the loop took one a zone. A field sums one zone's
//      feasible counts over at most the warp's 32 RUN nodes, each at most
//      the warp's max count wmax, so while wmax * 32 RUN < 2^16 no field
//      reaches 2^16, none carries into the next and the high field stays
//      below 2^32 (counts at or past 2^16 / (32 RUN), rare, take the loop of
//      one redux.sync a zone). Lane 0 of each warp then adds its max count,
//      zoned flag, zone sums, (min, max) and the flag's maxima into the
//      block's words with shared atomics (max, or, add, min: every order
//      gives the same integers), so after the barrier warp 0 reads the
//      block's partial instead of reducing 16 warp slots, and sets the words
//      back to 0 before the triple barrier (no warp adds again before the
//      next pod's first barrier). After the exchange every warp reduces the
//      16 block partials with lane b reading block b, one redux.sync a zone,
//      where each lane summed its zone over the 16 blocks in turn. Past 4
//      zones the spread build's scheme stays (one redux.sync a zone present
//      in the warp, warp 0 summing the warp slots, a serial sum a lane);
//   6. with at most 4 zones the SelectorSpread parts are taken once a lane:
//      lane x the node part of count x (0-31), lane d the zone part of zone
//      d and the other lanes that of a node whose zone is not summed; a node
//      reads its two parts with __shfl_sync, the same arithmetic on the same
//      values, so the same bits (a count past 31 takes its own).
// The double reciprocals stay: their divisors are the cluster's maxima,
// known only after the exchange; priced, an f32 reciprocal in their place
// saved nothing measurable, and an __fdiv_rn a part cost ~1.9 ms a batch.
// Priced and taken out: the index sent before the owner's ledger update
// (+0.6 ms beside the ids in the message: the owner's warp is on the way to
// the next pod's barrier); the next pod's list built by warp 0 while the
// combined message travels, with the replica updated after the counts
// where they read none of its changed cells (+2.9 ms: the list outlasts
// the exchange); ballots for the zoned flags and the zone reductions
// skipped past the zones in use (+0.56 ms); one pass over the carried
// terms where there are at most 32 (+0.08 ms). Not built: each warp
// sending its partial straight to the 16 blocks, which drops the barrier
// before the message but sends 16 times the chunks (256 a block a pod,
// 8 KiB at the cell's two) and leaves every warp 256 partials to reduce
// where it reduces 16; per-warp pairs across the cluster were priced in
// the interpod build's redesign, and did not pay.
// Shared memory of a block, without / with the flag (bytes): the carve
// 47,200 / 48,112 at 1 node a thread, 75,872 / 76,784 at 2, 133,216 /
// 134,128 at 4, 215,136 / 216,048 at 8; then 48 of block words; the ids
// 8,192, 16,384 and 32,768 at 1, 2 and 4 (none at 8); what is left of
// 232,448 for the replica: 177,008 / 176,096, 140,144 / 139,232, 66,416 /
// 65,504 and 17,264 / 16,352. ptxas (registers without / with the flag):
// 128 / 128 at 1 node a thread, 127 / 126 at 2, 128 / 128 at 4, none
// spilled; 128 / 128 at 8 with 124 / 132 bytes of spill stores and 112 of
// spill loads (72 bytes of stack), where the build before this design used
// 94, 128, 126 and 128 registers and spilled 72 bytes at 8.
//
// Bound of the spread+interpod build: masked_static read once, the
// node-level counts read once and written once, the per-pod rows and the
// domain aggregates read once, at 3.35 TB/s.
//
// The gang carry in the spread, interpod and spread+interpod builds (GANG
// with SPREAD, IPA or both; entries ktpu_assign_scan_spread_gang,
// _interpod_gang and _spread_interpod_gang): the JAX step settles a group
// against its whole live ledger (`_live_ledger`, kubernetes_tpu/ops/
// solver.py:357-363, the inter-pod ledger c.ipa included). These builds
// keep the gang build's scheme (group state in registers, every thread
// deciding alike, the undo log of the resource rows, rr and the term cache)
// and their own chains unchanged, with:
//   - the group id and quorum in free words of the build's pod slot (the
//     spread slot's words 78-79, the interpod slot's 165-166), copied with
//     the rest of the row;
//   - each undo-log entry also naming its pod (its second float4's last
//     word);
//   - a revert that subtracts what the group added beyond the resource
//     rows. The counts are integers far below 2^24, so (a + v) - v == a in
//     f32 and no log of old counts is kept: the node-level counts (the
//     [UQ, N] or [UQ+UE, N] copy in device memory), by each node's owner
//     thread from its entries, the member's match (and carried-term) row
//     read from the pod operands and subtracted with red.global.add; in the
//     interpod builds, also every block's totals and replica, from the
//     members' assignments: a cluster barrier first (release and acquire at
//     cluster scope: every owner's assignment write is visible in every
//     block), then thread t subtracts the rows of every placed member but
//     the last from totals column t and from the replica cells (slot, column)
//     it owns, at the member's domains read from the topology. The last
//     member's rows never reached the totals and replica: its node's index
//     is still on its way (they are added at the next pod's step 1), so the
//     revert waits for it on the index's mbarrier, as step 1 would, and
//     drops it. The group's members are the rows before the boundary with
//     its id (consecutive rows), read back from gang_id;
//   - what was prepared for the pod at the boundary before the revert:
//     the spread builds' count column, loaded a pod ahead (and patched by
//     the last member's owner), is loaded again after a block barrier that
//     makes the subtractions visible; the interpod builds' count list and
//     the replica's update are step 1 of that pod, which runs after the
//     boundary is settled; the flag's prepared key, guess, counts and terms
//     hold no ledger state (point (c) below).
// After the last pod the open group is settled the same way, but for the
// totals and replica, which are not returned.
//
// Bound of the gang build: that of the main build, masked_static read once
// (1.07 GB at P = 4,096, N = 65,536: 0.32 ms at 3.35 TB/s) plus the
// ledger; bench[gang] (50,000 nodes, 24,576 pods in groups of 8) launches
// it 6 times, once a 4,096-pod batch.
//
// The normalization flag (every build; the template argument NORM, its
// instance launched when the NormArgs pod words are given) adds
// TaintToleration and NodeAffinity, the JAX step's
// `taint_toleration_from_counts` and `normalized_from_counts` over the
// pod's feasible nodes (kubernetes_tpu/ops/solver.py:568-573, counts of
// :699-705; ops/priorities.py:75,101,112, ops/predicates.py:197). Its
// operands trail the kernel's as a pack of one NormArgs (none without the
// flag), every addition sits behind `if constexpr (NORM)`, and the kernel's
// scope gains no variable, so each build without the flag keeps its PTX and
// its SASS (`kernel_times.py --sass-against`); the 20 instances become 40.
// The counts come from 64-bit words, not from two [P, N] count rows (256 MB
// each at P = 4,096, N = 16,384): a node's PreferNoSchedule membership and
// its satisfied requirements ([N] u64 pairs, read through L1), and per pod
// its untolerated taints (masked by the wrapper to the taints some node
// carries) and up to four preferred terms with their weights (a 64-byte
// row riding the pod ring as the pod rows do, copied by the block's last
// four threads, 16 bytes each). For node g and pod p:
//   - the TaintToleration count is __popcll(taint(g) & untol(p)): the
//     membership rows are 0/1, so JAX's matmul counts the same bits;
//   - the NodeAffinity count is the sum of the weights of the terms t with
//     (req(g) & t) == t: JAX counts the term's satisfied requirements
//     against pref_count, the number of its distinct requirement ids, which
//     is the term word's popcount; a slot of weight 0 (unused, invalid or
//     non-positive) never scores, as there.
// Per pod, when its counts can be nonzero (an untolerated word and w_tt, a
// weighted term and w_na; every block reads the same row, so all decide
// alike): each thread packs its feasible nodes' counts (taints in bits 0-7,
// at most 64; the weight sum above, weights are integers up to 65,535 and
// any other traps) and takes their maxima, the warp reduces them with
// redux.sync.max.u32, and the block's two maxima cross the cluster: in the
// main, gang, spread and interpod builds in the triple's free word, behind
// a guess (below); in the spread+interpod build in the free words of the
// (min, max) chunk of its combined exchange, which then runs for a pod that
// needs any of its parts. Feasible means after the ledger fit and, in the
// interpod builds, after the predicate, as in JAX. Each node then adds w_tt
// * trunc((1 - c / M) * 10 + eps) (10 when M = 0) and w_na * trunc(c * 10 /
// M + eps) (0 when M = 0) in JAX's order, --fmad=false, dividing by
// multiplying with the double reciprocal of M as the spread build does
// (exact: norm_score). A pod whose counts are all 0 scores 10 and 0 without
// an exchange. Every term of the score is an integer-valued f32 far below
// 2^24 (weights are integers, every normalized term is in 0..10), so the
// score's f32 sum is exact in any order: one block a pod adds the run's
// flag terms to its masked static scores (-inf stays -inf), before
// LeastRequested and the other terms rather than at JAX's place between
// BalancedAllocation and InterPodAffinityPriority, and the score loops are
// those of the builds without the flag.
//
// The main, gang, spread and interpod builds guess the maxima, and the
// triple checks the guess (an exchange of the maxima before the score, a
// block barrier and a cluster round, cost about half the flag's time in the
// main and gang builds; in the spread build it was one more chunk of every
// pod's partial and an exchange for a pod without an entry, in the interpod
// build a (min, max) round for a pod that does not count):
//   - the guess. A table maps a pod's row of 16 ints to the maxima last
//     found for it: NM_TABLE entries (key, maxima | NM_VALID), one a lane of
//     every warp, in shared memory (a warp reads its 32 entries with one
//     ballot; a lane reads and writes only its own entry, so no barrier
//     guards it). The key is a multiply-add over the row's ints, a lane an
//     int, one redux (NM_MIX). A key not in the table guesses maxima 0 and,
//     once checked, takes the entry after the last one taken (first in,
//     first out); a key in it keeps its entry. Every warp of every block
//     keeps the same table: it is a function of the rows and the cluster's
//     true maxima of the exchanging pods so far, which every warp sees
//     alike. A collision costs a miss, never a wrong result;
//   - the check. Each warp takes its true maxima over its feasible nodes
//     (s.nm_w) before the triple's barrier (in the interpod build after the
//     predicate), and warp 0 packs the block's into the triple's free word,
//     mt | mn << 8 (mt <= 64, mn <= 4 * 65,535 < 2^18: a non-negative int
//     below 2^26). After the triple's wait every warp takes the cluster's
//     maxima from the 16 free words, records them in its table and compares
//     them with the guess. On a hit the selection reads the triples as
//     without the flag. On a miss each thread reads its run's static scores
//     again from the ring (the slot is refilled with row p + STAGES only
//     after pod p + 1's barrier), adds the flag's terms of the true maxima
//     (its counts taken again into registers of its own, its LeastRequested
//     and BalancedAllocation from the term cache, and in the spread and
//     interpod builds SelectorSpread, or the predicate and the priority of
//     the inter-pod terms, kept in registers from the first round), and the
//     block's second triple goes round on the sixth mbarrier into
//     s.nm_slot (its parity sp_phase, or ip_phase in the spread build,
//     whose sp_phase is its partial's); every block copies the 16 into its
//     slots of this pod's parity, passes one more block barrier, and the
//     selection reads them;
//   - so a pod exchanges what it exchanged without the flag: the spread
//     build's partial keeps its size without the flag (one 16-byte chunk a
//     block at 3 zones), and a pod without an entry sends none; the
//     interpod build's pod that does not count (no weighted entry) runs no
//     (min, max) round;
//   - the preparation. What a pod needs but the ledger is done while the
//     pod before it waits for its triples (norm_prepare, after that pod's
//     barrier, which publishes the next row): the weight checks and flags,
//     the counts, the key and the table's guess, and the run's flag terms
//     of the guess, kept a node in shared memory (nm_flag). A spread pod
//     with an entry prepares the next pod but its terms earlier, while its
//     partials travel (after its spread barrier, which publishes the row),
//     and the terms after sending its triple (norm_late_terms); an
//     interpod pod that counts prepares the next pod while its (min, max)
//     travels (after step 1's barrier). Priced on one untolerated taint and
//     on tt_na's alternating words (PERF.md, section 6, PR 20): the spread
//     build's terms in its partial's round cost more than they saved, the
//     interpod build's after its triple more than in its round. That guess is
//     read before the pod before it records its maxima, so after the record
//     it is mended to what a lookup after it finds: the pod's word where
//     the keys are equal, 0 where the record took the entry it found (and
//     the terms again where the guess moved). A row equal to the previous
//     pod's skips the checks, flags, key and lookup, which hold. So a pod's
//     own chain before its barrier holds its feasible maxima and the
//     addition of its terms alone;
//   - the counts are cached across pods: a node's raw packed count depends
//     only on its words, fixed for the launch, and the pod's row (not on
//     the ledger, nor on the interpod build's predicate), so a thread keeps
//     its run's (one unsigned a node, norm_counts' packing) and takes them
//     again only when the row differs from the previous pod's (a lane
//     compares an int, one vote) or that pod did not exchange; feasibility
//     is applied at use, to the maxima and the selection. At 1, 2 and 4
//     nodes a thread the run's node words are loaded once a launch into
//     registers (4 a node), and where no word of the pod has a bit past 31
//     the counts take the low halves alone;
//   - the kept terms (norm_score's, in nm_flag) are reused while the row
//     and the guess repeat: a run of one workload's replicas takes its
//     nodes' terms once;
//   - the registers a thread keeps from pod to pod ride the flag's operand
//     (NormMain, taken by value), so no other build's source changes; the
//     table and nm_flag add NM_TABLE_BYTES + NB * 4 bytes a block (20 KiB
//     at 8 nodes a thread), which the spread and interpod builds fit at
//     every RUN: 230,272 and 228,752 of 232,448 bytes at 8.
//   Priced and not kept (PERF.md, section 6, PR 20): in the spread build,
//   the maxima in one more word of an entry pod's partial, checked after
//   the partials' wait and re-scored locally on a miss, the triple's guess
//   left to pods without an entry (faster on alternating words, slower on
//   one taint: two chunks a block at 3 zones); in the spread and interpod
//   builds, the warps' maxima gathered by shared atomics and the hit read
//   from flag bits of the free word (one redux for two; slower).
// Why this is the plain version's result:
//   (a) No slot is overwritten while it is read. A block sends its second
//       triple of pod p only after it has received every block's first
//       triple of pod p, and a block sends that only after its first
//       barrier of pod p, which its threads pass only after they are done
//       with any earlier pod's second triples; so s.nm_slot and the sixth
//       mbarrier, single-buffered, are free when the next redo's bytes come,
//       and the mbarrier was re-armed by then (thread 0 arms it right after
//       its wait), as the parity argument above says for the triples. The
//       copy into the pod's own triple slots comes after the redo's first
//       barrier, which every warp passes after its check has read them,
//       and before any block can send pod p + 2's triples there (after its
//       wait for this block's triple of pod p + 1). The spread build's
//       partials of pod p and the interpod build's (min, max) of pod p are
//       read before the pod's first triple is sent; the next pod's come
//       only after every block's first (and second) triples of pod p, and
//       the placed node's index of pod p after its second round, so the
//       redo moves none of their slots or mbarriers. Nothing else the guess
//       adds is shared: a thread alone reads and writes its table entry, its
//       counts and its columns of nm_flag, and the rows it reads are
//       published by the barriers the pod ring already has.
//   (b) Hit and miss give the plain version's assignment, score, feasible
//       count and rr. Feasibility (the static row and the ledger fit, and the
//       predicate) does not depend on the guess, so the true maxima and the
//       feasible count are the same in both rounds, and every block decides
//       alike: the same 16 words, the same table. A hit scored every node
//       with the true maxima; a miss discards the guess's round, scores
//       again with the true maxima and selects on that round alone;
//       SelectorSpread and the inter-pod priority do not depend on the
//       flag, so the first round's are the second's; the terms are
//       norm_score's, added in any order, as above.
//   (c) The gang build's revert needs nothing more: it restores the ledger
//       and rr, and the next pod's feasible set, whatever it is, gives the
//       true maxima that the check compares; the table, the counts and the
//       kept terms hold no ledger state. In the interpod build a pod's
//       maxima depend on the predicate, and the predicate on the carried
//       terms of the pods placed before it, which both rounds read from one
//       ledger, untouched until the pod's selection.
//
// Bound of the flag: its build's bytes plus the words, N * 16 + P * 64
// bytes (0.26 MB at N = 16,384 and 4,096 pods), negligible beside the
// [P, N] row.
//
// The EXT variant (the template argument EXT, on the main and gang builds
// only; entries ktpu_assign_scan_ext and ktpu_assign_scan_gang_ext, with
// and without the flag: 16 instances beside the 64) adds host ports and the
// gpu and storage fit against the running ledger, the JAX step's
// `fits_host_ports` on its `port_count` carry and `fits_resources_dyn` with
// `dyn_gpu` and `dyn_storage` (kubernetes_tpu/ops/solver.py:537-539,
// 780-781; ops/predicates.py:57,93,135). Without it the solver hoists the
// gpu and storage compares into Phase A, which holds only while no pod of
// the batch requests those columns. A widening of the main and gang builds,
// not a new design:
//   - the fit folds into the term cache. The cache keeps LeastRequested -1
//     for a node the pod does not fit; under EXT that fit also holds the
//     node's host-port word against the pod's ((node & pod) == 0) and, unless
//     the pod requests nothing (the all-zero shortcut over all five
//     columns, which the port check does not take), the gpu column and the
//     storage fit (alloc >= request + requested, the overlay request
//     falling through to scratch, (r_scratch + r_overlay) + (q_overlay +
//     q_scratch), on a node with no overlay allocatable), every add
//     __fadd_rn in JAX's order. At 1, 2 and 4 nodes a thread the node's
//     gpu, scratch and overlay allocatable and running requested and its
//     port word are kept in registers (ExtMain, the operand's room: loaded
//     once, updated by the owner beside the requested columns in device
//     memory, restored by a revert), so a miss and the owner's recompute
//     read no memory for them; at 8 nodes a thread (no room in registers or
//     shared memory) a miss reads them from device memory, where the owner
//     keeps them (the allocatable through L1). A first design that read
//     device memory at every RUN took 15.5 ms of kernel on the gpu_ports
//     cell's first batch (PERF.md, section 6). The owner's recompute after its
//     update covers its node;
//   - the cache key also holds the pod's gpu, scratch and overlay request
//     bits and its port word (ExtArgs, in the by-value operand that rides
//     the flag's pack: a thread's key from pod to pod, so no build gains a
//     variable of the kernel's scope), so a pod whose cpu and memory equal
//     the previous pod's but whose gpu, storage or ports differ recomputes.
//     Replicas of one workload share all of them, so hits cost what they
//     cost without EXT;
//   - ports as one 64-bit word a node: bit u set where the node's count of
//     port u is not 0 (the wrapper packs it, UP <= 64), and a pod's word bit
//     u where it wants port u (in free words 10-11 of the gang build's
//     12-word pod slot, which the main build takes under EXT). Counts and
//     the pod's row are non-negative, so (word & pod) != 0 exactly where
//     JAX's count @ onehot is not 0. The owner ORs the pod's word into its
//     node's (owner-only; in registers, or device memory at 8 nodes a
//     thread). The counts after the batch
//     are summed by the wrapper from the assignments (members of reverted
//     groups left out): integers below 2^24, so equal to JAX's carry;
//   - the gang build's undo entry keeps a node's old word (its second
//     float4's last word and its third's, bit 3 of `changed`), and a revert
//     restores it with the requested columns, newest entry first, so a node
//     two members share ends with its word before the group.
// The variant also takes volumes, the JAX step's `no_disk_conflict` and
// `max_attach_ok` on its `vol_any`, `vol_rw` and `attach_count` carry
// (kubernetes_tpu/ops/solver.py:541-547,786-792; ops/predicates.py:230-263),
// in the same shape as the port word:
//   - NoDiskConflict as two 64-bit words a node, bit u of `any` set where
//     the node's count of conflict atom u is not 0 and of `rw` where its
//     read-write count is not 0, and two a pod, the atoms it mounts
//     read-write and read-only (the wrapper packs them, UV <= 64). A node
//     conflicts where (any & want_rw) | (rw & want_ro) != 0: exactly JAX's
//     any @ want_rw + rw @ want_ro != 0, the counts being non-negative (a
//     disk listed twice counts 2; an EBS atom is always read-write);
//   - MaxPDVolumeCount as one word a node, bit u where the node's count of
//     attach atom u is not 0, one a pod, its atoms, and its fail bit (a
//     claim that does not resolve: no node). For each of the batch's at
//     most three (type mask, limit) pairs (a table in the four words
//     before node 0's; a mask holds the atoms of the type or ANY, from the
//     atoms' types at the batch's flush), a
//     pod may take a node where popcount(pod & mask) == 0 (JAX's quick
//     return), or popcount(node & mask) + popcount(pod & ~node & mask) <=
//     limit;
//   - the node words live in device memory at every RUN ([N][4]: any, rw,
//     attach and the port word, which the registers hold at 1, 2 and 4
//     nodes a thread), read only on a miss, and only for a pod with such
//     words (a branch uniform over the cluster): a pod without volumes, as
//     on the gpu_ports cell, reads none. In registers beside the port word
//     they would add six registers a node, 24 at 4 nodes a thread, to a
//     build that already spills there with the flag. A node's words and a
//     pod's are one array each, so the operand keeps PR 24's two pointers
//     (a first layout with four and the limits by value cost the gpu_ports
//     cell's pods, which have no volumes, 8-15%: PERF.md, section 6);
//   - a pod's words ride words 12-17 of a 20-word EXT pod slot (two
//     16-byte copies), with a flag word 18 the wrapper computes: the fail
//     bit, whether the pod has conflict or attach words, and whether its
//     words equal the previous pod's. A pod without volume words is one
//     load and one test on a miss; the term cache's key takes the flag
//     word's EXT_SAME bit (the cached terms are always of the previous pod,
//     or there are none), so the key keeps no register for the words;
//   - the owner ORs the pod's words into its node's, and the gang build's
//     undo entry (5 float4s under EXT) keeps the node's old words (bits 4
//     and 5 of `changed`), restored newest first by a revert.
// Every addition sits behind `if constexpr (EXT)`, and the 64 instances
// without it keep their SASS (kernel_times.py --sass-against).
//
// Bound of the EXT instances: their build's bytes, which already count
// every column of the requests, allocatable and requested once, plus the
// port words, N * 8 read and N * 8 written, and P * 8 read, and the volume
// words, N * 24 read and N * 24 written, and P * 32 read.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 16;          // blocks of the cluster (non-portable)
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 4;            // ring slots of masked_static rows
constexpr int STAGES_MAIN = STAGES;
constexpr int POD_SLOTS = 8;         // ring slots of pod rows (> STAGES)
constexpr int POD_ROW = 8;           // floats of a pod slot: requests, nonzero
constexpr int POD_ROW_MAIN = POD_ROW;
constexpr int COLUMNS = 10;          // shared node columns (see Smem)
constexpr int MAX_SMEM = 232448;     // opt-in shared memory of one block
constexpr int R = 6;                 // resource columns of requests / requested
constexpr int PODS = 0, CPU = 1, MEM = 2, GPU = 3, SCRATCH = 4, OVERLAY = 5;
constexpr float FLOOR_EPS = 1e-6f;
constexpr float MAX_PRIORITY = 10.0f;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned TRIPLE_BYTES = 16;            // one st.async.v4 per block
constexpr long long WAIT_LIMIT = 1LL << 33;      // cycles (seconds): a lost triple

static_assert(WARPS <= 32 && CLUSTER <= 32, "one warp reduces the slots");

// ---- the 8-node build's terms
constexpr float LR_BIAS = 8388609.0f;   // 2^23 + 1: LeastRequested + 1 in a byte
constexpr float BA_BIAS = 8388608.0f;   // 2^23: BalancedAllocation in a byte
constexpr unsigned BIAS_BITS = 0x4B000000u;   // the bits of 2^23
static_assert(POD_SLOTS > STAGES && R + 2 == POD_ROW, "pod ring");

// ---- the spread build's layout
constexpr int MAX_DOMAINS = 64;      // zone ids summed (two a lane)
constexpr int MAX_UQ = 64;           // pod-selector columns
constexpr int SP_Q = R + 2;          // pod-slot word: spread_q
constexpr int SP_M = R + 3;          // pod-slot words: the match row
constexpr int SP_POD_ROW = 80;       // floats of a spread pod slot
constexpr int SP_WORDS = 1 + MAX_DOMAINS;   // max count | any zoned << 30, zone sums
constexpr int SP_ZONED = 1 << 30;               // the any-zoned bit of word 0
constexpr int SP_CHUNKS = (SP_WORDS + 3) / 4;   // 16-byte chunks of a partial
constexpr int SP_SLOT = 4 * SP_CHUNKS;          // ints of a block's slot
constexpr float ZONE_SHARE = (float)(2.0 / 3.0);        // zoneWeighting
constexpr float NODE_SHARE = (float)(1.0 - 2.0 / 3.0);
static_assert(MAX_DOMAINS == 2 * 32 && SP_M + MAX_UQ <= SP_POD_ROW
              && SP_POD_ROW % 4 == 0 && WARPS * SP_WORDS % 4 == 0,
              "spread layout");   // counts stay below 2^24, clear of SP_ZONED

// ---- the interpod build's layout
constexpr int IP_SLOTS = 4;          // required (and preferred) term slots
constexpr int IP_MAX_UQ = 64;        // pod-selector columns
constexpr int IP_MAX_UE = 64;        // carried-term columns
constexpr int IP_MAX_U = IP_MAX_UQ + IP_MAX_UE;
constexpr int IP_MAX_K = 16;         // topology slots
constexpr int IP_MAX_D = 64;         // domains of a non-hostname slot
// per-pod words (i32; the float ones as bits) after requests and nonzero
constexpr int IPW_FAIL = 0, IPW_PAFF_Q = 1, IPW_PAFF_TK = 5, IPW_PANTI_Q = 9,
              IPW_PANTI_TK = 13, IPW_PREF_Q = 17, IPW_PREF_TK = 21,
              IPW_PREF_W = 25, IPW_ROWS = 29;   // then match[uq], carry[ue]
constexpr int IP_POD_ROW = 168;      // floats of an interpod pod slot
constexpr int IP_MAX_ENTRIES = 2 * IP_MAX_UE + 3 * IP_SLOTS;
constexpr int TKEY_INVALID = -1, TKEY_DEFAULT_UNION = -2;
constexpr int TOPO_ZONE = 1, TOPO_REGION = 2, TOPO_ZONE_REGION = 3;
constexpr int ANTI_REQ = 0, AFF_REQ = 1;           // TermKind
// count-entry roles
constexpr int ROLE_SCORE = 0, ROLE_CARRIED_ANTI = 1, ROLE_ANTI = 2, ROLE_AFF = 3;
constexpr unsigned IP_BYTES = 16;    // one block's (min, max), one st.async.v4
static_assert(POD_ROW_MAIN + IPW_ROWS + IP_MAX_U <= IP_POD_ROW
              && IP_POD_ROW % 4 == 0 && IP_POD_ROW <= THREADS, "interpod layout");

// ---- the spread+interpod build's layout: the interpod pod slot (its match
// row serves SelectorSpread too), spread_q in its last word
constexpr int SI_Q = IP_POD_ROW - 1;
static_assert(POD_ROW_MAIN + IPW_ROWS + IP_MAX_U <= SI_Q && MAX_UQ == IP_MAX_UQ,
              "spread+interpod layout");
// the block's domain ids as bytes, [IP_MAX_K][NB] at 1, 2 and 4 nodes a
// thread: an id in [0, nd) itself, SI_NO_ID for none (-1), SI_PAST for one
// at or past nd
constexpr int SI_IDS_MAX_RUN = 4;
constexpr unsigned SI_NO_ID = 0xffu, SI_PAST = 0xfeu;
// zones whose warp sums ride packed lanes, two 16-bit fields a word
constexpr int SI_FAST_ZONES = 4;
constexpr unsigned SI_FIELD = 1u << 16;   // a field's bound (see the header)
// topology slots 1..SI_MSG_SLOTS whose ids ride the placed node's message
constexpr int SI_MSG_SLOTS = 8;
static_assert(IP_MAX_D < (int)SI_PAST && SI_FAST_ZONES + 1 <= SP_SLOT,
              "spread+interpod ids and packed zones");

// ---- the gang build's layout
constexpr int GW_ID = POD_ROW_MAIN;       // pod-slot word: the group id
constexpr int GW_MIN = POD_ROW_MAIN + 1;  // and the group's quorum
constexpr int GANG_POD_ROW = 12;          // floats of a gang pod slot
constexpr int UNDO_WORDS = 3;             // float4s of an undo-log entry
static_assert(GW_MIN < GANG_POD_ROW && GANG_POD_ROW % 4 == 0, "gang layout");
// the gang carry in the spread and interpod slots: the group id and quorum
// in free words past the slot's rows (the spread slot's match row ends at
// word 73, the interpod slot's rows at 165, its word 167 is SI_Q)
constexpr int SP_GW_ID = SP_POD_ROW - 2;
constexpr int IP_GW_ID = SI_Q - 2;
static_assert(SP_M + MAX_UQ <= SP_GW_ID && SP_GW_ID + 1 < SP_POD_ROW
              && POD_ROW_MAIN + IPW_ROWS + IP_MAX_U <= IP_GW_ID && IP_GW_ID + 1 < SI_Q,
              "gang words in the spread and interpod slots");

// ---- the EXT variant's layout: the pod's host-port word (an int pair) in
// the free words of the gang build's pod slot, then its volume words (the
// conflict atoms it mounts read-write, read-only, its attach atoms, int
// pairs) and its flag word, in an EXT pod slot of 20 words, which the main
// and gang builds take under EXT
constexpr int EXT_PW = GW_MIN + 1;
constexpr int EXT_VW = EXT_PW + 2;
constexpr int EXT_FLAGS = EXT_VW + 6;  // the flag word: the fail bit, which words,
constexpr unsigned EXT_FAIL = 1u, EXT_DISK = 2u, EXT_ATT = 4u;
constexpr unsigned EXT_SAME = 8u;      // and whether they equal the previous pod's
constexpr int EXT_POD_ROW = 20;
constexpr int EXT_PORTS = 1 << 3;    // `changed` bits of an undo entry: the port word,
constexpr int EXT_VOLS = 1 << 4;     // the conflict words
constexpr int EXT_ATTACH = 1 << 5;   // and the attach word
constexpr int EXT_UNDO_WORDS = 5;    // float4s of an EXT undo-log entry
constexpr int EXT_MAX_ATTACH = 3;    // (type mask, limit) pairs of MaxPDVolumeCount
// the words of a node (any, rw, attach, ports) and of a pod (ports, 0, rw,
// ro, attach, flags), 64-bit
constexpr int EXT_NODE_WORDS = 4, EXT_NODE_ATT = 2, EXT_NODE_PORT = 3;
constexpr int EXT_POD_WORDS = 6, EXT_POD_VOL = 2;
static_assert(EXT_PW + 1 < GANG_POD_ROW && EXT_VW % 4 == 0 && EXT_VW + 8 == EXT_POD_ROW
              && EXT_POD_ROW % 4 == 0, "EXT layout");

// ---- the normalization flag's layout: a pod's row of ints, the untolerated
// word, NM_SLOTS term words (u64, little-endian int pairs), their weights
// (f32 bits), padding
constexpr int NM_SLOTS = 4;
constexpr int NM_W = 2 + 2 * NM_SLOTS;     // the weights' first int
constexpr int NM_ROW = 16;                 // ints of a pod's row, 64 bytes
constexpr int NM_COPIERS = NM_ROW / 4;     // threads copying it, 16 bytes each
constexpr float NM_MAX_WEIGHT = 65535.0f;  // weight sums stay below 2^24
constexpr size_t NM_SMEM = (size_t)POD_SLOTS * NM_ROW * sizeof(int)
                           + (size_t)CLUSTER * sizeof(int4)
                           + (size_t)WARPS * sizeof(int2) + 2 * sizeof(uint64_t);
static_assert(NM_W + NM_SLOTS <= NM_ROW && NM_SMEM % 16 == 0, "norm layout");
// the maxima table of the builds that guess (NM_GUESS; see the header): one
// entry a lane of every warp, (a row's key, its maxima | NM_VALID), after NM_SMEM
constexpr int NM_TABLE = 32;
constexpr unsigned NM_VALID = 1u << 31;
constexpr unsigned NM_STALE = ~0u;     // no packed maxima: nm_flag's terms are stale
constexpr size_t NM_TABLE_BYTES = (size_t)WARPS * NM_TABLE * sizeof(int2);
// a row's key: the sum over its NM_ROW ints x_l of x_l * (2 l + 1) * NM_MIX,
// mod 2^32 (lane l takes one product, one redux.sync adds them)
constexpr unsigned NM_MIX = 0x9E3779B9u;
// the packed maxima, mt | mn << 8: mt at most 64 taints, mn at most
// NM_SLOTS weights of 65,535
static_assert(NM_TABLE == 32 && 64u < 256u
              && (64u | (NM_SLOTS * 65535u) << 8) < (1u << 26), "norm table");

// Row-ring slots and pod-slot width of one build.
template <int RUN, bool SPREAD, bool IPA, bool GANG, bool EXT = false>
struct Build {
  static constexpr int STAGES = STAGES_MAIN;
  // no term columns: the terms are packed in registers (8 nodes a thread)
  static constexpr bool PACKED = RUN == 8;
  static constexpr int POD_ROW = IPA ? IP_POD_ROW
                                 : SPREAD ? SP_POD_ROW
                                 : EXT ? EXT_POD_ROW
                                 : GANG ? GANG_POD_ROW : POD_ROW_MAIN;
  // float4s of an undo-log entry (gang builds)
  static constexpr int UNDO = EXT ? EXT_UNDO_WORDS : UNDO_WORDS;
  // the pod-slot words of spread_q and of the match row (spread builds;
  // named at their uses: kernel-local copies moved the spread build's
  // register allocation at 1, 2 and 4 nodes a thread)
  [[maybe_unused]] static constexpr int SPQ = IPA ? SI_Q : SP_Q;
  [[maybe_unused]] static constexpr int SPM = IPA ? POD_ROW_MAIN + IPW_ROWS : SP_M;
  // the pod-slot words of the group id and quorum (gang builds)
  [[maybe_unused]] static constexpr int GWI = IPA ? IP_GW_ID : SPREAD ? SP_GW_ID : GW_ID;
  [[maybe_unused]] static constexpr int GWM = GWI + 1;
};

// What the spread build reads beyond the main operands.
struct SpreadArgs {
  float* podsel_t;            // [UQ, N] counts, updated in place
  const int* spread_q;        // [P] union entry, -1 = none
  const float* pod_matches;   // [P, UQ] match rows
  const int* zone;            // [N] TOPO_SPREAD_ZONE domain id, -1 = none
  int uq;
  int nz;                     // zones in use: ids below nz are summed
  int nd;                     // the zone universe: no id lies in [nz, nd)
  float w_ss;
};
struct NoSpread {};
template <bool SPREAD>
using SpreadParam = typename std::conditional<SPREAD, SpreadArgs, NoSpread>::type;

// What the interpod build reads beyond the main operands.
struct IpaArgs {
  float* node_t;              // [uq + ue, N] node-level counts, updated in place
  const float* dom0;          // [k, nd, uq + ue] batch-start domain aggregates
  float* dom;                 // [CLUSTER, k, nd, uq + ue] replicas (scratch)
  const float* totals;        // [uq + ue] batch-start total_q, total_e
  const int* pod_ip;          // [P, IPW_ROWS + uq + ue] per-pod words
  const int* topology;        // [N, k] domain ids, -1 = none
  const int* term_attr;       // [5, ue]: term_q, term_tkey, term_kind,
                              // term_weight (f32 bits), term_poison
  int uq;
  int ue;
  int k;                      // topology slots
  int nd;                     // domains of a non-hostname slot
  int use_ipa;                // MatchInterPodAffinity in the policy
  float w_ip;                 // InterPodAffinityPriority's weight
  float hard_w;               // hardPodAffinityWeight
};
struct NoIpa {};
template <bool IPA>
using IpaParam = typename std::conditional<IPA, IpaArgs, NoIpa>::type;

// What the gang build reads beyond the main operands.
struct GangArgs {
  const int* gang_id;         // [P] batch-local group id, 0 = none
  const int* gang_min;        // [P] the group's quorum
  float4* undo;               // [CLUSTER, P, UNDO_WORDS] undo logs, one a block
};
struct NoGang {};
template <bool GANG>
using GangParam = typename std::conditional<GANG, GangArgs, NoGang>::type;

// What the normalization flag reads (every build with NORM).
struct NormArgs {
  const ulonglong2* node_w;   // [N] (PreferNoSchedule taints, satisfied requirements)
  const int* pod_w;           // [P, NM_ROW] per-pod words (see the layout)
  float w_tt;                 // TaintTolerationPriority's weight
  float w_na;                 // NodeAffinityPriority's weight
};
// The kernel takes them as a pack of one NormArgs, or of none without the
// flag: an empty struct operand, as the other builds take, moved the spread
// build's instructions at 1, 2 and 4 nodes a thread (so did three more
// variables of the kernel's scope; the flag keeps none).
__device__ __forceinline__ const NormArgs& norm_of(const NormArgs& nm) { return nm; }

// What the EXT variant reads beyond its build's operands, and what a thread
// keeps from pod to pod: the term cache's key beyond the main build's (the
// gpu, scratch and overlay requests and the port word of the pod the cached
// terms are of). It rides the kernel's pack after the flag's NormArgs, so no
// build gains a variable of the kernel's scope.
struct ExtArgs {
  // [N][EXT_NODE_WORDS] a node's conflict atoms in use, in use read-write,
  // attach atoms present and host ports, updated in place; the four words
  // before node 0 hold MaxPDVolumeCount's type masks and packed limits
  unsigned long long* node;
  // [P][EXT_POD_WORDS] a pod's host ports, 0, the atoms it mounts
  // read-write, read-only, its attach atoms and its flags (EXT_FAIL, ...)
  const unsigned long long* pod;
  float r_gpu, r_scr, r_ovl;        // the key: the pod's requests
  unsigned long long port;          // and its port word
};
// At 1, 2 and 4 nodes a thread (EXT_REGS) the operand also keeps the run's
// gpu, scratch and overlay allocatable and running requested and its port
// words in registers, which the owner updates with device memory and a
// revert restores; at 8 they stay in device memory.
template <int RUN>
constexpr bool EXT_REGS = RUN <= 4;
template <int RUN>
struct ExtMain : ExtArgs {
  float a[EXT_REGS<RUN> ? RUN : 1][3];   // allocatable gpu, scratch, overlay
  float q[EXT_REGS<RUN> ? RUN : 1][3];   // requested gpu, scratch, overlay
  unsigned long long w[EXT_REGS<RUN> ? RUN : 1];
};
template <int RUN>
__device__ __forceinline__ ExtMain<RUN>& ext_of(ExtMain<RUN>& x) { return x; }
template <typename N, int RUN>
__device__ __forceinline__ ExtMain<RUN>& ext_of(N&, ExtMain<RUN>& x) { return x; }
__device__ __forceinline__ const NormArgs& norm_of(const NormArgs& nm, const ExtArgs&) {
  return nm;
}

// The builds that guess the flag's maxima (main, gang, spread, interpod:
// NM_GUESS, below) take the flag's operand with room for what a thread
// keeps from pod to pod (the kernel's copy of its by-value operand, in
// registers), so the kernel's scope gains no variable in any build: the
// run's raw packed counts for the words of the pod they were taken for,
// whether that was the last pod prepared; the flags, key, guess and table
// entry of the pod being scored and of the next pod, prepared while this
// one's triples travel; the table entry the next new key replaces; the
// maxima the prepared flag terms are of; and at 1, 2 and 4 nodes a thread
// the run's node words.
template <int RUN>
struct NormMain : NormArgs {
  unsigned cnt[RUN];
  bool cnt_ok;                         // cnt is of the last pod prepared
  bool tt, na;                         // the pod scored: its flags
  bool x_n, tt_n, na_n;                // and the next pod, prepared
  unsigned key, guess, key_n, guess_n;
  int at, at_n;                        // their keys' entries, -1 = none
  unsigned next;
  unsigned t_word;                     // the maxima nm_flag's terms are of
  ulonglong2 w[RUN <= 4 ? RUN : 1];
};
template <int RUN>
__device__ __forceinline__ NormMain<RUN>& keep_of(NormMain<RUN>& k) { return k; }
template <int RUN>
__device__ __forceinline__ NormMain<RUN>& keep_of(NormMain<RUN>& k, ExtArgs&) { return k; }

// The builds whose flag guesses the maxima and checks them in the triple
// (see the header), taking NormMain: every build with the flag but the
// spread+interpod build.
template <bool SPREAD, bool IPA, bool NORM>
constexpr bool NM_GUESS = NORM && !(SPREAD && IPA);

// One pod's words: its untolerated taints, its terms and their integer
// weights (0: the slot never scores), and whether each count can be
// nonzero with its weight set.
struct NormPod {
  unsigned long long untol;
  unsigned long long term[NM_SLOTS];
  unsigned wt[NM_SLOTS];
  bool tt, na;
};

struct Triple {      // a partial reduction: best score's key, ties at it, feasible
  int key;
  int ties;
  int feas;
};

// No nodes: a key below every score's.
__device__ __forceinline__ Triple empty() { return Triple{INT_MIN, 0, 0}; }

// An int that orders as the float does, for the warp's integer max
// (redux.sync). Scores are never NaN, and -0 is made +0 before, so equal
// keys are exactly equal scores.
__device__ __forceinline__ int order_key(float x) {
  const int b = __float_as_int(x);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

// Dynamic shared memory of one block, NB = THREADS * RUN nodes. The spread
// build's regions follow the main build's.
struct Smem {
  float* a_pods; float* a_cpu; float* a_mem;     // allocatable
  float* r_pods; float* r_cpu; float* r_mem;     // requested
  float* z_cpu; float* z_mem;                    // nonzero
  float* t_lr; float* t_ba;                      // cached terms (not 8 nodes a thread)
  float* ring;                                   // [STAGES][NB]
  uint64_t* bar;                                 // [2] mbarriers
  int4* cslot;                                   // [2][CLUSTER] block triples
  float* pods;                                   // [POD_SLOTS][POD_ROW]
  Triple* wslot;                                 // [2][WARPS] warp triples
  int4* sp_slot;                                 // [CLUSTER][SP_CHUNKS] block partials
  int4* sp_out;                                  // [SP_CHUNKS] this block's
  int* sp_w;                                     // [WARPS][SP_WORDS] warp partials
  uint64_t* bar_sp;                              // the partials' mbarrier
  // the interpod build's regions follow the main build's
  int4* ip_list;                                 // [IP_MAX_ENTRIES] count entries
  int4* ip_head;                                 // entries, reject, counting, row != 0
  int* t_attr;                                   // [5][IP_MAX_UE] term attributes
  float* totals;                                 // [IP_MAX_U] total_q, total_e
  int4* ip_slot;                                 // [CLUSTER] block (min, max)
  int2* ip_w;                                    // [WARPS] warp (min, max)
  int4* win_slot;                                // the placed node's index
  uint64_t* bar_ip;                              // the (min, max) mbarrier
  uint64_t* bar_win;                             // the placed node's mbarrier
  // the normalization flag's regions follow every build's own
  int* nm_pods;                                  // [POD_SLOTS][NM_ROW] pod words
  int4* nm_slot;                                 // [CLUSTER] second triples (NM_GUESS)
  int2* nm_w;                                    // [WARPS] warp maxima
  uint64_t* bar_nm;                              // their mbarrier (NM_GUESS)
};

template <bool SPREAD, bool IPA = false, bool PACKED = false, bool NORM = false>
__host__ __device__ constexpr size_t smem_bytes(int nb, int STAGES, int POD_ROW) {
  return (size_t)(COLUMNS - (PACKED ? 2 : 0) + STAGES) * nb * sizeof(float)
         + 2 * sizeof(uint64_t)
         + (size_t)2 * CLUSTER * sizeof(int4)
         + (size_t)POD_SLOTS * POD_ROW * sizeof(float)
         + (size_t)2 * WARPS * sizeof(Triple)
         + (SPREAD ? (size_t)(CLUSTER + 1) * SP_CHUNKS * sizeof(int4)
                         + (size_t)WARPS * SP_WORDS * sizeof(int)
                         + 2 * sizeof(uint64_t)
                   : 0)
         + (IPA ? (size_t)(IP_MAX_ENTRIES + 1) * sizeof(int4)
                      + (size_t)5 * IP_MAX_UE * sizeof(int)
                      + (size_t)IP_MAX_U * sizeof(float)
                      + (size_t)(CLUSTER + 1) * sizeof(int4)
                      + (size_t)WARPS * sizeof(int2) + 2 * sizeof(uint64_t)
                : 0)
         + (NORM ? NM_SMEM : 0)
         + (NM_GUESS<SPREAD, IPA, NORM> ? NM_TABLE_BYTES + (size_t)nb * sizeof(float) : 0);
}

template <bool SPREAD, int STAGES, int POD_ROW, bool IPA = false>
__device__ Smem carve(float* base, int nb) {
  Smem s;
  s.a_pods = base;
  s.a_cpu = base + nb;
  s.a_mem = base + 2 * nb;
  s.r_pods = base + 3 * nb;
  s.r_cpu = base + 4 * nb;
  s.r_mem = base + 5 * nb;
  s.z_cpu = base + 6 * nb;
  s.z_mem = base + 7 * nb;
  s.t_lr = base + 8 * nb;
  s.t_ba = base + 9 * nb;
  s.ring = base + (size_t)COLUMNS * nb;
  // nb is a multiple of 512: everything below stays 16-byte aligned
  s.bar = reinterpret_cast<uint64_t*>(s.ring + (size_t)STAGES * nb);
  s.cslot = reinterpret_cast<int4*>(s.bar + 2);
  s.pods = reinterpret_cast<float*>(s.cslot + 2 * CLUSTER);
  s.wslot = reinterpret_cast<Triple*>(s.pods + POD_SLOTS * POD_ROW);
  if constexpr (SPREAD) {   // every size below is a multiple of 16 bytes
    s.sp_slot = reinterpret_cast<int4*>(s.wslot + 2 * WARPS);
    s.sp_out = s.sp_slot + CLUSTER * SP_CHUNKS;
    s.sp_w = reinterpret_cast<int*>(s.sp_out + SP_CHUNKS);
    s.bar_sp = reinterpret_cast<uint64_t*>(s.sp_w + WARPS * SP_WORDS);
  }
  if constexpr (IPA) {   // every size below is a multiple of 16 bytes
    if constexpr (SPREAD)   // after the spread build's regions
      s.ip_list = reinterpret_cast<int4*>(s.bar_sp + 2);
    else
      s.ip_list = reinterpret_cast<int4*>(s.wslot + 2 * WARPS);
    s.ip_head = s.ip_list + IP_MAX_ENTRIES;
    s.t_attr = reinterpret_cast<int*>(s.ip_head + 1);
    s.totals = reinterpret_cast<float*>(s.t_attr + 5 * IP_MAX_UE);
    s.ip_slot = reinterpret_cast<int4*>(s.totals + IP_MAX_U);
    s.win_slot = s.ip_slot + CLUSTER;
    s.ip_w = reinterpret_cast<int2*>(s.win_slot + 1);
    s.bar_ip = reinterpret_cast<uint64_t*>(s.ip_w + WARPS);
    s.bar_win = s.bar_ip + 1;
  }
  // after the build's last region (16-byte aligned, as above)
  if constexpr (IPA)
    s.nm_pods = reinterpret_cast<int*>(s.bar_win + 1);
  else if constexpr (SPREAD)
    s.nm_pods = reinterpret_cast<int*>(s.bar_sp + 2);
  else
    s.nm_pods = reinterpret_cast<int*>(s.wslot + 2 * WARPS);
  s.nm_slot = reinterpret_cast<int4*>(s.nm_pods + POD_SLOTS * NM_ROW);
  s.nm_w = reinterpret_cast<int2*>(s.nm_slot + CLUSTER);
  s.bar_nm = reinterpret_cast<uint64_t*>(s.nm_w + WARPS);
  return s;
}

// The maxima table of the builds that guess, past the flag's regions (its
// entry t is thread t's: lane t % 32 of warp t / 32), then the next pod's
// flag terms a node (the run's at column c0, as the term columns).
__device__ __forceinline__ int2* nm_table(const Smem& s) {
  return reinterpret_cast<int2*>(s.bar_nm + 2);
}
__device__ __forceinline__ float* nm_flag(const Smem& s) {
  return reinterpret_cast<float*>(nm_table(s) + WARPS * NM_TABLE);
}

// The 8-node carve: carve's layout without the two term columns, the ring
// and all after it two columns lower.
template <bool SPREAD, int STAGES, int POD_ROW, bool IPA = false>
__device__ Smem carve_packed(float* base, int nb) {
  Smem s = carve<SPREAD, STAGES, POD_ROW, IPA>(base - 2 * nb, nb);
  s.a_pods = base;
  s.a_cpu = base + nb;
  s.a_mem = base + 2 * nb;
  s.r_pods = base + 3 * nb;
  s.r_cpu = base + 4 * nb;
  s.r_mem = base + 5 * nb;
  s.z_cpu = base + 6 * nb;
  s.z_mem = base + 7 * nb;
  s.t_lr = s.t_ba = nullptr;
  return s;
}

// The spread+interpod build's shared memory past its carve: the block's
// partial words, then the block's domain ids as bytes (at most
// SI_IDS_MAX_RUN nodes a thread), then, where it fits, the block's replica
// of topology slots 1..k-1. The words, every one 0 between pods: the max
// count, whether a feasible node has a zone, the SI_FAST_ZONES zone sums,
// the (min, max) of the interpod counts, the flag's two maxima, padding.
constexpr int SI_BLOCK_WORDS = 12;
constexpr size_t SI_HEAD_BYTES = SI_BLOCK_WORDS * sizeof(int);
static_assert(2 + SI_FAST_ZONES + 4 <= SI_BLOCK_WORDS && SI_HEAD_BYTES % 16 == 0,
              "spread+interpod block words");
template <int RUN>
constexpr bool SI_HAS_IDS = RUN <= SI_IDS_MAX_RUN;

template <int RUN>
__host__ __device__ constexpr size_t si_ids_bytes() {
  return SI_HAS_IDS<RUN> ? (size_t)IP_MAX_K * THREADS * RUN : 0;
}

__host__ __device__ inline size_t si_rep_bytes(int k, int nd, int u) {
  return (size_t)(k - 1) * nd * u * sizeof(float);
}

// Whether the replica lives in shared memory: the carve's `base` bytes, the
// ids and the replica within a block's shared memory.
template <int RUN>
__host__ __device__ inline bool si_rep_shared(size_t base, int k, int nd, int u) {
  return base + SI_HEAD_BYTES + si_ids_bytes<RUN>() + si_rep_bytes(k, nd, u) <= (size_t)MAX_SMEM;
}

// ---- PTX: cp.async, mbarriers and st.async to another block of the cluster

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// This thread's cp.async groups but the newest `pending` have landed.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// The address of this block's shared `addr` in block `rank` of the cluster.
__device__ __forceinline__ unsigned map_rank(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// One arrival that also expects `bytes` of stores for the barrier's phase.
__device__ __forceinline__ void mbar_arm(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred P;\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P;\n"
      "}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait for the phase of `bar` with this parity. A phase that never
// completes is a fault: trap, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  const long long start = clock64();
  while (!mbar_try_wait(a, parity))
    if (clock64() - start > WAIT_LIMIT) __trap();
}

// 16 bytes into another block's shared memory; the store completes its
// bytes on that block's mbarrier.
__device__ __forceinline__ void st_async_v4(unsigned remote, int4 v,
                                            unsigned remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.s32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(remote),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(remote_bar)
      : "memory");
}

// ---- the scoring arithmetic

__device__ __forceinline__ float unused_score(float req, float cap) {
  // floor((cap - req) * 10 / safe_cap + eps); 0 when cap == 0 or req > cap
  const float safe = (cap == 0.0f) ? 1.0f : cap;
  const float s = floorf(__fadd_rn(
      __fdiv_rn(__fmul_rn(__fsub_rn(cap, req), MAX_PRIORITY), safe), FLOOR_EPS));
  return (cap == 0.0f || req > cap) ? 0.0f : s;
}

struct Pod {
  float r_cpu, r_mem, nz_cpu, nz_mem;
  bool all_zero;
};

// The terms of shared node column `c` for the pod's requests and the
// current ledger: *lr = LeastRequested, or -1 when the pod does not fit;
// *ba = BalancedAllocation.
__device__ __forceinline__ void node_terms(const Smem& s, const Pod& pod, int c,
                                           float* lr_out, float* ba_out) {
  const float a_pods = s.a_pods[c];
  const float a_cpu = s.a_cpu[c];
  const float a_mem = s.a_mem[c];
  *lr_out = -1.0f;
  *ba_out = 0.0f;
  if (!(__fadd_rn(s.r_pods[c], 1.0f) <= a_pods)) return;
  if (!pod.all_zero && !(a_cpu >= __fadd_rn(pod.r_cpu, s.r_cpu[c])
                         && a_mem >= __fadd_rn(pod.r_mem, s.r_mem[c])))
    return;

  const float tc = __fadd_rn(s.z_cpu[c], pod.nz_cpu);
  const float tm = __fadd_rn(s.z_mem[c], pod.nz_mem);
  *lr_out = floorf(__fadd_rn(
      __fdiv_rn(__fadd_rn(unused_score(tc, a_cpu), unused_score(tm, a_mem)),
                2.0f),
      FLOOR_EPS));
  const float cf = __fdiv_rn(tc, a_cpu == 0.0f ? 1.0f : a_cpu);
  const float mf = __fdiv_rn(tm, a_mem == 0.0f ? 1.0f : a_mem);
  const float diff = fabsf(__fsub_rn(cf, mf));
  const float ba = truncf(__fadd_rn(
      __fmul_rn(__fsub_rn(1.0f, diff), MAX_PRIORITY), FLOOR_EPS));
  *ba_out = (cf >= 1.0f || mf >= 1.0f || a_cpu == 0.0f || a_mem == 0.0f)
                ? 0.0f : ba;
}

// The EXT variant's fit of node g beyond node_terms' (see the header): no
// host port of the pod's word in use there, and unless the pod requests
// nothing, the gpu column and the storage fit against the node's running
// requested columns (device memory, the owner's), in JAX's order
// (predicates.py:57-67,93-114).
// A node's gpu, scratch and overlay allocatable (a) and requested (q) and
// its port word (w).
struct ExtNode {
  float a[3], q[3];
  unsigned long long w;
};

__device__ __forceinline__ bool ext_fits(const ExtArgs& x, const ExtNode& n, bool all_zero) {
  if ((n.w & x.port) != 0ull) return false;
  if (all_zero) return true;
  if (!(n.a[0] >= __fadd_rn(x.r_gpu, n.q[0]))) return false;
  if (n.a[2] == 0.0f)   // no overlay allocatable: overlay falls through to scratch
    return n.a[1] >= __fadd_rn(__fadd_rn(x.r_scr, x.r_ovl), __fadd_rn(n.q[2], n.q[1]));
  return n.a[1] >= __fadd_rn(x.r_scr, n.q[1]) && n.a[2] >= __fadd_rn(x.r_ovl, n.q[2]);
}

// A pod's volume words: its EXT pod slot and the slot's flag word.
struct ExtPod {
  const float* pr;
  unsigned flags;   // EXT_FAIL, EXT_DISK, EXT_ATT, EXT_SAME
};

__device__ __forceinline__ unsigned long long slot_word(const float* pr, int w) {
  return (unsigned long long)__float_as_uint(pr[w])
         | (unsigned long long)__float_as_uint(pr[w + 1]) << 32;
}

__device__ __forceinline__ ExtPod ext_pod(const float* pr) {
  return ExtPod{pr, __float_as_uint(pr[EXT_FLAGS])};
}

// The volume half of the EXT fit of node g (see the header): the fail bit,
// then NoDiskConflict and MaxPDVolumeCount on the node's words in device
// memory, each read (with the pod's words, from its slot) only where the
// pod's flags say it has words for it.
__device__ __forceinline__ bool ext_vol_fits(const ExtArgs& x, const ExtPod& v, int g) {
  if ((v.flags & (EXT_FAIL | EXT_DISK | EXT_ATT)) == 0u) return true;
  if (v.flags & EXT_FAIL) return false;
  if (v.flags & EXT_DISK) {
    const ulonglong2 w = reinterpret_cast<const ulonglong2*>(x.node)[2 * (size_t)g];
    if (((w.x & slot_word(v.pr, EXT_VW)) | (w.y & slot_word(v.pr, EXT_VW + 2))) != 0ull)
      return false;
  }
  if (v.flags & EXT_ATT) {
    const unsigned long long have = x.node[EXT_NODE_WORDS * (size_t)g + EXT_NODE_ATT];
    const unsigned long long att = slot_word(v.pr, EXT_VW + 4);
    // the table before node 0: three type masks, then the limits, 16 bits
    // each, and their count in bits 48-49
    const unsigned long long limits = __ldg(x.node - 1);
#pragma unroll
    for (int k = 0; k < EXT_MAX_ATTACH; ++k) {
      const unsigned long long mask = __ldg(x.node - EXT_NODE_WORDS + k);
      const unsigned long long want = att & mask;
      if (k < (int)(limits >> 48) && want != 0ull
          && __popcll(have & mask) + __popcll(want & ~have) > (int)((limits >> (16 * k)) & 0xffffu))
        return false;
    }
  }
  return true;
}

// Run position j's (node g's) EXT columns: from the registers at
// EXT_REGS (j may be a run-time index: each position is selected, so the
// arrays stay in registers), else from device memory (the allocatable
// through L1).
template <int RUN>
__device__ __forceinline__ ExtNode ext_node(const ExtMain<RUN>& x, int j, int g,
                                            const float* allocatable, const float* requested) {
  ExtNode n;
  if constexpr (EXT_REGS<RUN>) {
    n = ExtNode{{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}, 0ull};
#pragma unroll
    for (int i = 0; i < RUN; ++i) {
      if (i != j) continue;
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        n.a[f] = x.a[i][f];
        n.q[f] = x.q[i][f];
      }
      n.w = x.w[i];
    }
  } else {
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      n.a[f] = __ldg(allocatable + (size_t)g * R + GPU + f);
      n.q[f] = requested[(size_t)g * R + GPU + f];
    }
    n.w = x.node[EXT_NODE_WORDS * (size_t)g + EXT_NODE_PORT];
  }
  return n;
}

// node_terms with the EXT variant's fit: LeastRequested -1 and
// BalancedAllocation 0 where the pod fits the pods, cpu and memory columns
// but not the rest, as node_terms' own early return gives them.
template <int RUN>
__device__ __forceinline__ void ext_terms(const Smem& s, const Pod& pod, const ExtPod& v,
                                          int c, int g, int j, const ExtMain<RUN>& x,
                                          const float* allocatable, const float* requested,
                                          float* lr_out, float* ba_out) {
  node_terms(s, pod, c, lr_out, ba_out);
  if (*lr_out >= 0.0f
      && !(ext_fits(x, ext_node<RUN>(x, j, g, allocatable, requested), pod.all_zero)
           && ext_vol_fits(x, v, g))) {
    *lr_out = -1.0f;
    *ba_out = 0.0f;
  }
}

// The owner's update of run position j (node g) for a placed pod with
// requests rq and volume words v: the requested gpu, scratch and overlay
// columns in device memory (x + 0 == x: a zero request is skipped), the
// port word, at EXT_REGS the registers too (the device word is then never
// read again), and the node's volume words in device memory.
template <int RUN>
__device__ __forceinline__ void ext_place(ExtMain<RUN>& x, int j, int g, const float (&rq)[R],
                                          const ExtPod& v, float* requested) {
  if (v.flags & EXT_DISK) {
    const unsigned long long rw = slot_word(v.pr, EXT_VW);
    x.node[EXT_NODE_WORDS * (size_t)g] |= rw | slot_word(v.pr, EXT_VW + 2);
    x.node[EXT_NODE_WORDS * (size_t)g + 1] |= rw;
  }
  if (v.flags & EXT_ATT)
    x.node[EXT_NODE_WORDS * (size_t)g + EXT_NODE_ATT] |= slot_word(v.pr, EXT_VW + 4);
  if constexpr (EXT_REGS<RUN>) {
#pragma unroll
    for (int i = 0; i < RUN; ++i) {
      if (i != j) continue;
#pragma unroll
      for (int f = 0; f < 3; ++f)
        if (rq[GPU + f] != 0.0f) {
          x.q[i][f] = __fadd_rn(x.q[i][f], rq[GPU + f]);
          requested[(size_t)g * R + GPU + f] = x.q[i][f];
        }
      x.w[i] |= x.port;
    }
  } else {
#pragma unroll
    for (int f = GPU; f < R; ++f)
      if (rq[f] != 0.0f)
        requested[(size_t)g * R + f] = __fadd_rn(requested[(size_t)g * R + f], rq[f]);
    if (x.port != 0ull) x.node[EXT_NODE_WORDS * (size_t)g + EXT_NODE_PORT] |= x.port;
  }
}

// The gang build's undo entry (EXT) of run position j (shared column c,
// node g) before the owner's update for a member with requests rq and
// volume words v: the node's old ledger row (as the gang build logs it),
// its old gpu, scratch and overlay columns where the member changes them,
// its old port word where the member has ports (`changed` bit EXT_PORTS;
// its low half in the second float4's last word, its high half in the
// third's), its old conflict words where the member has conflict atoms
// (EXT_VOLS; the fourth float4) and its old attach word where it has
// attach atoms (EXT_ATTACH; the fifth's first two words).
template <int RUN>
__device__ __forceinline__ void ext_log(const ExtMain<RUN>& x, float4* e, const Smem& s, int c,
                                        int j, int g, const float (&rq)[R], const ExtPod& v,
                                        const float* allocatable, const float* requested) {
  const ExtNode n = ext_node<RUN>(x, j, g, allocatable, requested);
  int changed = 0;
  float4 e2 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (rq[GPU] != 0.0f) { changed |= 1; e2.x = n.q[0]; }
  if (rq[SCRATCH] != 0.0f) { changed |= 2; e2.y = n.q[1]; }
  if (rq[OVERLAY] != 0.0f) { changed |= 4; e2.z = n.q[2]; }
  float lo = 0.0f;
  if (x.port != 0ull) {
    changed |= EXT_PORTS;
    lo = __uint_as_float((unsigned)n.w);
    e2.w = __uint_as_float((unsigned)(n.w >> 32));
  }
  if (v.flags & EXT_DISK) {
    changed |= EXT_VOLS;
    const ulonglong2 w = reinterpret_cast<const ulonglong2*>(x.node)[2 * (size_t)g];
    e[3] = make_float4(__uint_as_float((unsigned)w.x), __uint_as_float((unsigned)(w.x >> 32)),
                       __uint_as_float((unsigned)w.y), __uint_as_float((unsigned)(w.y >> 32)));
  }
  if (v.flags & EXT_ATT) {
    changed |= EXT_ATTACH;
    const unsigned long long w = x.node[EXT_NODE_WORDS * (size_t)g + EXT_NODE_ATT];
    e[4] = make_float4(__uint_as_float((unsigned)w), __uint_as_float((unsigned)(w >> 32)),
                       0.0f, 0.0f);
  }
  e[0] = make_float4(__int_as_float(c), s.r_pods[c], s.r_cpu[c], s.r_mem[c]);
  e[1] = make_float4(s.z_cpu[c], s.z_mem[c], __int_as_float(changed), lo);
  if (changed != 0) e[2] = e2;
}

// A revert's restore (EXT) of run position j (node g) from its undo entry
// e (e1, e2 read; the device columns are restored by the gang build's
// code): the node's conflict and attach words, the port word, and at
// EXT_REGS the registers.
template <int RUN>
__device__ __forceinline__ void ext_restore(ExtMain<RUN>& x, int j, int g, int changed,
                                            float4 e1, float4 e2, const float4* e) {
  if (changed & EXT_VOLS) {
    const float4 e3 = e[3];
    x.node[EXT_NODE_WORDS * (size_t)g] = (unsigned long long)__float_as_uint(e3.x)
                                         | (unsigned long long)__float_as_uint(e3.y) << 32;
    x.node[EXT_NODE_WORDS * (size_t)g + 1] = (unsigned long long)__float_as_uint(e3.z)
                                             | (unsigned long long)__float_as_uint(e3.w) << 32;
  }
  if (changed & EXT_ATTACH) {
    const float4 e4 = e[4];
    x.node[EXT_NODE_WORDS * (size_t)g + EXT_NODE_ATT] =
        (unsigned long long)__float_as_uint(e4.x) | (unsigned long long)__float_as_uint(e4.y) << 32;
  }
  const unsigned long long w = (unsigned long long)__float_as_uint(e1.w)
                               | (unsigned long long)__float_as_uint(e2.w) << 32;
  if constexpr (EXT_REGS<RUN>) {
#pragma unroll
    for (int i = 0; i < RUN; ++i) {
      if (i != j) continue;
      if (changed & 1) x.q[i][0] = e2.x;
      if (changed & 2) x.q[i][1] = e2.y;
      if (changed & 4) x.q[i][2] = e2.z;
      if (changed & EXT_PORTS) x.w[i] = w;
    }
  } else {
    if (changed & EXT_PORTS) x.node[EXT_NODE_WORDS * (size_t)g + EXT_NODE_PORT] = w;
  }
}

// The term cache's reuse with the EXT variant's key: `same`, the main
// build's key compare, and (EXT) the pod's gpu, scratch and overlay request
// bits and port word equal to those of the pod the terms are of, which the
// key then takes, and its volume words equal to the previous pod's (its
// flag EXT_SAME; the cached terms, if any, are of the previous pod).
template <bool EXT, typename... Norm>
__device__ __forceinline__ bool ext_reuse(bool same, const float* pr, Norm&... nm) {
  if constexpr (EXT) {
    ExtArgs& x = ext_of(nm...);
    same = same && (__float_as_uint(pr[EXT_FLAGS]) & EXT_SAME) != 0u;
    const float r_gpu = pr[GPU], r_scr = pr[SCRATCH], r_ovl = pr[OVERLAY];
    const unsigned long long port =
        (unsigned long long)__float_as_uint(pr[EXT_PW])
        | (unsigned long long)__float_as_uint(pr[EXT_PW + 1]) << 32;
    same = same && __float_as_uint(r_gpu) == __float_as_uint(x.r_gpu)
           && __float_as_uint(r_scr) == __float_as_uint(x.r_scr)
           && __float_as_uint(r_ovl) == __float_as_uint(x.r_ovl) && port == x.port;
    x.r_gpu = r_gpu;
    x.r_scr = r_scr;
    x.r_ovl = r_ovl;
    x.port = port;
  }
  return same;
}

// An integer-valued term v, v + bias in [2^23, 2^23 + 255], as a byte: the
// low bits of the f32 2^23 + k are k.
__device__ __forceinline__ unsigned term_byte(float v, float bias) {
  return __float_as_uint(__fadd_rn(v, bias)) & 0xffu;
}

// Byte k (0..3) of w back to the term: 2^23 + byte as f32 bits, less the
// bias.
__device__ __forceinline__ float byte_term(unsigned w, int k, float bias) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, BIAS_BITS, 0x7650 + k)), bias);
}

// w with its byte k (a run-time 0..3) replaced by b.
__device__ __forceinline__ unsigned put_byte(unsigned w, unsigned b, int k) {
  const unsigned sh = 8u * (unsigned)k;
  return (w & ~(0xffu << sh)) | (b << sh);
}

// Where entry i of a block's row segment sits in its ring slot at 8 nodes a
// thread: 16-byte chunk c at c ^ ((c >> 3) & 1), so the first chunks of a
// quarter warp's eight runs fall on 32 different banks.
__device__ __forceinline__ int slot_at(int i) { return i ^ (((i >> 5) & 1) << 2); }

// RUN consecutive floats from shared memory, as vector loads.
template <int RUN>
__device__ __forceinline__ void load_run(const float* p, float (&v)[RUN]) {
  if constexpr (RUN % 4 == 0) {
#pragma unroll
    for (int j = 0; j < RUN; j += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + j);
      v[j] = x.x; v[j + 1] = x.y; v[j + 2] = x.z; v[j + 3] = x.w;
    }
  } else if constexpr (RUN == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else {
#pragma unroll
    for (int j = 0; j < RUN; ++j) v[j] = p[j];
  }
}

// The warp's (best key, ties at it, feasible) in three redux.sync.
__device__ __forceinline__ Triple warp_reduce(Triple v) {
  Triple r;
  r.key = __reduce_max_sync(FULL, v.key);
  r.ties = __reduce_add_sync(FULL, v.key == r.key ? v.ties : 0);
  r.feas = __reduce_add_sync(FULL, v.feas);
  return r;
}

// Sum of v over the lanes below this one, for 0 <= v <= RUN (a thread's
// ties): one ballot per bit of v.
template <int RUN>
__device__ __forceinline__ int exclusive_sum_small(int v, int lane) {
  const unsigned below = (1u << lane) - 1u;
  int sum = 0;
#pragma unroll
  for (int i = 0; (1 << i) <= RUN; ++i)
    sum += __popc(__ballot_sync(FULL, (v >> i) & 1) & below) << i;
  return sum;
}

// A pod's words from its row in the ring; traps on a weight that is not an
// integer up to NM_MAX_WEIGHT (the packed counts' range).
__device__ __forceinline__ NormPod norm_pod(const NormArgs& nm, const int* row) {
  NormPod q;
  const unsigned long long* w = reinterpret_cast<const unsigned long long*>(row);
  q.untol = w[0];
  bool weighted = false;
#pragma unroll
  for (int k = 0; k < NM_SLOTS; ++k) {
    q.term[k] = w[1 + k];
    const float f = __int_as_float(row[NM_W + k]);
    q.wt[k] = 0u;
    if (f > 0.0f) {
      if (f != truncf(f) || f > NM_MAX_WEIGHT) __trap();
      q.wt[k] = (unsigned)f;
      weighted = true;
    }
  }
  q.tt = nm.w_tt != 0.0f && q.untol != 0ull;
  q.na = nm.w_na != 0.0f && weighted;
  return q;
}

// The run's counts, packed (untolerated PreferNoSchedule taints in bits
// 0-7, the weights of the terms the node meets from bit 8), at its feasible
// positions; *mt and *mn, their maxima there.
template <int RUN>
__device__ __forceinline__ void norm_counts(const NormArgs& nm, const NormPod& q,
                                            int g0, const bool (&fe)[RUN],
                                            unsigned (&nc)[RUN], unsigned* mt,
                                            unsigned* mn) {
  unsigned a = 0u, b = 0u;
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    nc[j] = 0u;
    if (!fe[j]) continue;   // feasible: a node below N
    const ulonglong2 w = nm.node_w[g0 + j];
    const unsigned ct = q.tt ? (unsigned)__popcll(w.x & q.untol) : 0u;
    unsigned cn = 0u;
    if (q.na) {
#pragma unroll
      for (int k = 0; k < NM_SLOTS; ++k)
        cn += (w.y & q.term[k]) == q.term[k] ? q.wt[k] : 0u;
    }
    nc[j] = ct | (cn << 8);
    a = max(a, ct);
    b = max(b, cn);
  }
  *mt = a;
  *mn = b;
}

// A pod's words for its counts from its row in the ring, whose weights the
// warp has checked (norm_pod's traps) and whose flags it has taken.
__device__ __forceinline__ NormPod norm_words(const int* row, bool tt, bool na) {
  NormPod q;
  const unsigned long long* w = reinterpret_cast<const unsigned long long*>(row);
  q.untol = w[0];
#pragma unroll
  for (int k = 0; k < NM_SLOTS; ++k) {
    q.term[k] = w[1 + k];
    const float f = __int_as_float(row[NM_W + k]);
    q.wt[k] = f > 0.0f ? (unsigned)f : 0u;
  }
  q.tt = tt;
  q.na = na;
  return q;
}

// The run's raw counts for pod words q at every node below N whatever its
// feasibility (0 past N), packed as norm_counts packs them (untolerated
// taints in bits 0-7, the met terms' weights from bit 8): the node words
// from kp.w at 1, 2 and 4 nodes a thread, else through L1; the low 32 bits
// alone where the pod's words have no higher bit (LO32).
template <int RUN, bool LO32>
__device__ __forceinline__ void norm_raw_counts(const NormArgs& nm, const NormPod& q,
                                                int g0, int N, const NormMain<RUN>& kp,
                                                unsigned (&out)[RUN]) {
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    unsigned c = 0u;
    if (g0 + j < N) {
      ulonglong2 w;
      if constexpr (RUN <= 4) w = kp.w[j];
      else w = nm.node_w[g0 + j];
      unsigned ct = 0u, cn = 0u;
      if (q.tt)
        ct = LO32 ? (unsigned)__popc((unsigned)w.x & (unsigned)q.untol)
                  : (unsigned)__popcll(w.x & q.untol);
      if (q.na) {
#pragma unroll
        for (int k = 0; k < NM_SLOTS; ++k) {
          const bool met = LO32 ? ((unsigned)w.y & (unsigned)q.term[k]) == (unsigned)q.term[k]
                                : (w.y & q.term[k]) == q.term[k];
          cn += met ? q.wt[k] : 0u;
        }
      }
      c = ct | (cn << 8);
    }
    out[j] = c;
  }
}

// The run's counts for a pod's row (x: lane l's int l of it) into out: the
// 32-bit form where no word of the pod has a bit past 31.
template <int RUN>
__device__ __forceinline__ void norm_count_row(const NormMain<RUN>& kp, const int* row,
                                               int x, int lane, bool tt, bool na, int g0,
                                               int N, unsigned (&out)[RUN]) {
  const NormPod q = norm_words(row, tt, na);
  if (__all_sync(FULL, !(lane < NM_W && (lane & 1)) || x == 0))
    norm_raw_counts<RUN, true>(kp, q, g0, N, kp, out);
  else
    norm_raw_counts<RUN, false>(kp, q, g0, N, kp, out);
}

// The run's masked static scores from its ring slot (`at`: the slot's
// column c0), as the pod loop reads them.
template <int RUN>
__device__ __forceinline__ void load_scores(const float* at, int lane, float (&ms)[RUN]) {
  if constexpr (RUN == 8) {
    const int sw = ((lane >> 2) & 1) << 2;
    const float4 a = *reinterpret_cast<const float4*>(at + sw);
    const float4 b = *reinterpret_cast<const float4*>(at + (4 - sw));
    ms[0] = a.x; ms[1] = a.y; ms[2] = a.z; ms[3] = a.w;
    ms[4] = b.x; ms[5] = b.y; ms[6] = b.z; ms[7] = b.w;
  } else {
    load_run<RUN>(at, ms);
  }
}

// The run's best score, its ties (bit j: run position j) and feasible
// count, as the main and gang builds take them in the pod loop.
template <int RUN>
__device__ __forceinline__ void best_of_run(const float (&ms)[RUN], const float (&lr)[RUN],
                                            const float (&ba)[RUN], float w_lr, float w_ba,
                                            float* best_out, unsigned* tied_out,
                                            int* feas_out) {
  float best = -INFINITY;
  unsigned tied = 0u;
  int feas = 0;
  if constexpr (RUN == 8) {
    float sc[RUN];
    unsigned fm = 0u;
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      const bool ok = ms[j] > -INFINITY && lr[j] >= 0.0f;
      const float v = __fadd_rn(__fadd_rn(ms[j], __fmul_rn(w_lr, lr[j])), __fmul_rn(w_ba, ba[j]));
      sc[j] = ok ? __fadd_rn(v, 0.0f) : -INFINITY;
      fm |= ok ? 1u << j : 0u;
    }
    best = fmaxf(fmaxf(fmaxf(sc[0], sc[1]), fmaxf(sc[2], sc[3])),
                 fmaxf(fmaxf(sc[4], sc[5]), fmaxf(sc[6], sc[7])));
#pragma unroll
    for (int j = 0; j < RUN; ++j) tied |= sc[j] == best ? 1u << j : 0u;
    tied &= fm;
    feas = __popc(fm);
  } else {
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      if (!(ms[j] > -INFINITY) || lr[j] < 0.0f) continue;
      const float sc = __fadd_rn(__fadd_rn(__fadd_rn(ms[j], __fmul_rn(w_lr, lr[j])),
                                           __fmul_rn(w_ba, ba[j])), 0.0f);
      ++feas;
      if (sc > best) {
        best = sc;
        tied = 1u << j;
      } else if (sc == best) {
        tied |= 1u << j;
      }
    }
  }
  *best_out = best;
  *tied_out = tied;
  *feas_out = feas;
}

// best_of_run for the spread build (x: SelectorSpread, w_x: w_ss) or the
// interpod build (x: InterPodAffinityPriority, w_x: w_ip, and its
// predicate ok), as their pod loop takes them.
template <int RUN, bool IPA>
__device__ __forceinline__ void best_of_run_x(const float (&ms)[RUN], const float (&lr)[RUN],
                                              const float (&ba)[RUN], const float (&x)[RUN],
                                              const bool (&ok)[RUN], float w_lr, float w_ba,
                                              float w_x, float* best_out, unsigned* tied_out,
                                              int* feas_out) {
  float best = -INFINITY;
  unsigned tied = 0u;
  int feas = 0;
  if constexpr (RUN == 8 && !IPA) {
    float sc[RUN];
    unsigned fm = 0u;
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      const bool f = ms[j] > -INFINITY && lr[j] >= 0.0f;
      const float v = __fadd_rn(__fadd_rn(__fadd_rn(ms[j], __fmul_rn(w_lr, lr[j])),
                                          __fmul_rn(w_ba, ba[j])), __fmul_rn(w_x, x[j]));
      sc[j] = f ? __fadd_rn(v, 0.0f) : -INFINITY;
      fm |= f ? 1u << j : 0u;
    }
    best = fmaxf(fmaxf(fmaxf(sc[0], sc[1]), fmaxf(sc[2], sc[3])),
                 fmaxf(fmaxf(sc[4], sc[5]), fmaxf(sc[6], sc[7])));
#pragma unroll
    for (int j = 0; j < RUN; ++j) tied |= sc[j] == best ? 1u << j : 0u;
    tied &= fm;
    feas = __popc(fm);
  } else {
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      if (!(ms[j] > -INFINITY) || lr[j] < 0.0f) continue;
      if constexpr (IPA)
        if (!ok[j]) continue;
      const float sc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(ms[j], __fmul_rn(w_lr, lr[j])),
                                                     __fmul_rn(w_ba, ba[j])),
                                           __fmul_rn(w_x, x[j])), 0.0f);
      ++feas;
      if (sc > best) {
        best = sc;
        tied = 1u << j;
      } else if (sc == best) {
        tied |= 1u << j;
      }
    }
  }
  *best_out = best;
  *tied_out = tied;
  *feas_out = feas;
}

// The cluster's maxima from each lane's block maxima (lanes past the
// cluster pass 0).
__device__ __forceinline__ void norm_maxima(unsigned bt, unsigned bn, float* m_tt,
                                            float* m_na) {
  *m_tt = (float)__reduce_max_sync(FULL, bt);
  *m_na = (float)__reduce_max_sync(FULL, bn);
}

// w_tt * TaintToleration + w_na * NodeAffinity of a node with packed counts
// c, against the feasible maxima m_tt and m_na (priorities.py:75-87,
// 112-122), whose double reciprocals r_tt and r_na (__drcp_rn, taken once a
// pod) divide as the spread build's do: c / m_tt and 10 c / m_na are
// integer-valued f32 over integers below 2^24 with quotients in [0, 10] on
// a feasible node, so (float)((double)n * r) is the f32 quotient itself
// (the header's Exactness of the spread build).
__device__ __forceinline__ float norm_score(const NormArgs& nm, unsigned c, float m_tt,
                                            float m_na, double r_tt, double r_na) {
  const float ct = (float)(c & 0xffu);
  const float cn = (float)(c >> 8);
  const float tt =
      m_tt > 0.0f
          ? truncf(__fadd_rn(
                __fmul_rn(__fsub_rn(1.0f, __double2float_rn(__dmul_rn((double)ct, r_tt))),
                          MAX_PRIORITY),
                FLOOR_EPS))
          : MAX_PRIORITY;
  const float na =
      m_na > 0.0f
          ? truncf(__fadd_rn(
                __double2float_rn(__dmul_rn((double)__fmul_rn(cn, MAX_PRIORITY), r_na)),
                FLOOR_EPS))
          : 0.0f;
  return __fadd_rn(__fmul_rn(nm.w_tt, tt), __fmul_rn(nm.w_na, na));
}

// The flag's terms of the run for the packed maxima `word` and counts cnt:
// norm_score's, with the score's weights.
template <int RUN>
__device__ __forceinline__ void norm_terms(const NormMain<RUN>& kp, unsigned word,
                                           const unsigned (&cnt)[RUN], float (&out)[RUN]) {
  const float m_tt = (float)(word & 0xffu);
  const float m_na = (float)(word >> 8);
  const double r_tt = __drcp_rn((double)fmaxf(m_tt, 1.0f));
  const double r_na = __drcp_rn((double)fmaxf(m_na, 1.0f));
#pragma unroll
  for (int j = 0; j < RUN; ++j) out[j] = norm_score(kp, cnt[j], m_tt, m_na, r_tt, r_na);
}

// The flag's terms of the run for the packed maxima `word` into its columns
// of nm_flag, and the maxima they are of.
template <int RUN>
__device__ __forceinline__ void norm_flag_terms(NormMain<RUN>& kp, const Smem& s, int c0,
                                                unsigned word) {
  float fl[RUN];
  norm_terms<RUN>(kp, word, kp.cnt, fl);
#pragma unroll
  for (int j = 0; j < RUN; ++j) nm_flag(s)[c0 + j] = fl[j];
  kp.t_word = word;
}

// Prepare pod q (below P, its row visible to the block), every thread
// alike, while the pod before it waits for its triples: its flags, its
// counts (kept when its row is the previous pod's and that pod exchanged),
// its key and the table's guess, and the run's flag terms of the guess into
// nm_flag (kept when the counts and the guess are those they were taken
// for). Without TERMS the terms are left to norm_late_terms (new counts
// mark the kept terms stale).
template <int RUN, bool TERMS = true>
__device__ __forceinline__ void norm_prepare(NormMain<RUN>& kp, const Smem& s, int q,
                                             int lane, int t, int c0, int g0, int N) {
  const int* row = s.nm_pods + (q % POD_SLOTS) * NM_ROW;
  // (lane l < 16 reads int l of the row and of the previous pod's; the
  // warp checks the weights and takes the flags, the key and whether the
  // rows are equal with votes and one redux)
  const int x = lane < NM_ROW ? row[lane] : 0;
  const int y = lane < NM_ROW ? s.nm_pods[((q + POD_SLOTS - 1) % POD_SLOTS) * NM_ROW + lane] : 0;
  // the previous pod's row: its checks, flags, key and entry hold (its
  // guess and entry are mended after its check, as where the keys are
  // equal)
  const bool same_row = q > 0 && __all_sync(FULL, x == y);
  if (!same_row) {
    const float f = __int_as_float(x);
    const bool weight = lane >= NM_W && lane < NM_W + NM_SLOTS && f > 0.0f;
    if (__any_sync(FULL, weight && (f != truncf(f) || f > NM_MAX_WEIGHT))) __trap();
    kp.tt_n = kp.w_tt != 0.0f && __any_sync(FULL, lane < 2 && x != 0);
    kp.na_n = kp.w_na != 0.0f && __any_sync(FULL, weight);
    kp.x_n = kp.tt_n || kp.na_n;
  }
  if (!kp.x_n) {
    kp.cnt_ok = false;
    return;
  }
  const bool same = kp.cnt_ok && same_row;
  if (!same) norm_count_row<RUN>(kp, row, x, lane, kp.tt_n, kp.na_n, g0, N, kp.cnt);
  kp.cnt_ok = true;
  if (!same_row) {
    kp.key_n = __reduce_add_sync(FULL, (unsigned)x * ((2u * lane + 1u) * NM_MIX));
    const int2 e = nm_table(s)[t];
    const unsigned hit =
        __ballot_sync(FULL, ((unsigned)e.y & NM_VALID) != 0u && (unsigned)e.x == kp.key_n);
    kp.at_n = hit != 0u ? __ffs((int)hit) - 1 : -1;
    kp.guess_n = __shfl_sync(FULL, (unsigned)e.y & ~NM_VALID, kp.at_n & 31);
    if (hit == 0u) kp.guess_n = 0u;   // an unknown key: guess no counts
  }
  if constexpr (TERMS) {
    if (!same || kp.guess_n != kp.t_word) norm_flag_terms<RUN>(kp, s, c0, kp.guess_n);
  } else {
    if (!same) kp.t_word = NM_STALE;
  }
}

// The flag terms of a pod norm_prepare<RUN, false> prepared, where its
// guess is not the maxima nm_flag's terms are of (or they are stale).
template <int RUN>
__device__ __forceinline__ void norm_late_terms(NormMain<RUN>& kp, const Smem& s, int c0) {
  if (kp.x_n && kp.guess_n != kp.t_word) norm_flag_terms<RUN>(kp, s, c0, kp.guess_n);
}

// One half of SelectorSpread (spread.py:50-58): MAX_PRIORITY * (m - x) /
// max(m, 1), or MAX_PRIORITY when the maximum m is 0, for integer-valued
// 0 <= x <= m < 2^24; rm is the double reciprocal of max(m, 1),
// __drcp_rn, taken once a pod. The f32 quotient is exact (the header's
// Exactness).
__device__ __forceinline__ float spread_part(float m, float x, double rm) {
  if (!(m > 0.0f)) return MAX_PRIORITY;
  const float num = __fmul_rn(MAX_PRIORITY, __fsub_rn(m, x));
  return __double2float_rn(__dmul_rn((double)num, rm));
}

// SelectorSpread of one node from its node and zone parts (spread.py:
// 59-64): has_zone, its zone id >= 0.
__device__ __forceinline__ float spread_score(float node_score, float zone_score,
                                              bool has_zone, bool have_zones) {
  const float blended =
      (have_zones && has_zone)
          ? __fadd_rn(__fmul_rn(node_score, NODE_SHARE),
                      __fmul_rn(ZONE_SHARE, zone_score))
          : node_score;
  return truncf(__fadd_rn(blended, FLOOR_EPS));
}

// Word w of block b's spread partial in this block's slots.
__device__ __forceinline__ int sp_word(const Smem& s, int b, int w) {
  return reinterpret_cast<const int*>(s.sp_slot)[b * SP_SLOT + w];
}

// The count of column u (a pod selector below ip.uq, else a carried term)
// at topology code tk for node g: the node-level count for the hostname
// slot, the block's replica at the node's domain for slots 1..k-1, the
// inclusion-exclusion union for TKEY_DEFAULT_UNION (interpod.py:119-128),
// and 0 for TKEY_INVALID or a slot past k.
__device__ __forceinline__ float ip_count(const IpaArgs& ip, const float* dom_b,
                                          int u, int tk, int g, int N) {
  const int U = ip.uq + ip.ue;
  if (tk == 0) return ip.node_t[(size_t)u * N + g];
  const int* row = ip.topology + (size_t)g * ip.k;
  auto at = [&](int k, int d) {
    return (d >= 0 && d < ip.nd) ? dom_b[((size_t)k * ip.nd + d) * U + u] : 0.0f;
  };
  if (tk > 0 && tk < ip.k) return at(tk, __ldg(row + tk));
  if (tk == TKEY_DEFAULT_UNION) {
    const int z = __ldg(row + TOPO_ZONE);
    const int r = __ldg(row + TOPO_REGION);
    const float host = (z < 0 && r < 0) ? ip.node_t[(size_t)u * N + g] : 0.0f;
    return __fsub_rn(__fadd_rn(__fadd_rn(host, at(TOPO_ZONE, z)), at(TOPO_REGION, r)),
                     at(TOPO_ZONE_REGION, __ldg(row + TOPO_ZONE_REGION)));
  }
  return 0.0f;
}

// The start of the spread+interpod build's region past its carve: the
// block's partial words.
template <int RUN, bool PACKED, bool NORM>
__device__ __forceinline__ int* si_block(float* smem_base) {
  using B = Build<RUN, true, true, false>;
  return reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(smem_base)
         + smem_bytes<true, true, PACKED, NORM>(THREADS * RUN, B::STAGES, B::POD_ROW));
}

// The block's domain ids as bytes.
template <int RUN, bool PACKED, bool NORM>
__device__ __forceinline__ unsigned char* si_ids(float* smem_base) {
  return reinterpret_cast<unsigned char*>(si_block<RUN, PACKED, NORM>(smem_base)) + SI_HEAD_BYTES;
}

// The spread+interpod build's domain id of node g (block column c) in
// topology slot k, as a byte: from the block's ids in shared memory
// ([IP_MAX_K][NB] bytes), else from the topology in device memory.
template <int RUN>
__device__ __forceinline__ unsigned si_id(const IpaArgs& ip, const unsigned char* ids,
                                          int k, int c, int g) {
  if constexpr (SI_HAS_IDS<RUN>) {
    return ids[k * (THREADS * RUN) + c];
  } else {
    const int d = __ldg(ip.topology + (size_t)g * ip.k + k);
    return d < 0 ? SI_NO_ID : d < ip.nd ? (unsigned)d : SI_PAST;
  }
}

// ip_count in the spread+interpod build: the replica `rep` holds slots
// 1..k-1 ([k - 1, nd, uq + ue], in shared or device memory) and the
// domain ids come as bytes (si_id); the same values in the same order.
template <int RUN>
__device__ __forceinline__ float si_count(const IpaArgs& ip, const float* rep,
                                          const unsigned char* ids, int u, int tk,
                                          int c, int g, int N) {
  const int U = ip.uq + ip.ue;
  if (tk == 0) return ip.node_t[(size_t)u * N + g];
  auto at = [&](int k, unsigned d) {
    return d < (unsigned)ip.nd ? rep[((size_t)(k - 1) * ip.nd + d) * U + u] : 0.0f;
  };
  if (tk > 0 && tk < ip.k) return at(tk, si_id<RUN>(ip, ids, tk, c, g));
  if (tk == TKEY_DEFAULT_UNION) {
    const unsigned z = si_id<RUN>(ip, ids, TOPO_ZONE, c, g);
    const unsigned r = si_id<RUN>(ip, ids, TOPO_REGION, c, g);
    const float host = (z == SI_NO_ID && r == SI_NO_ID) ? ip.node_t[(size_t)u * N + g] : 0.0f;
    return __fsub_rn(__fadd_rn(__fadd_rn(host, at(TOPO_ZONE, z)), at(TOPO_REGION, r)),
                     at(TOPO_ZONE_REGION, si_id<RUN>(ip, ids, TOPO_ZONE_REGION, c, g)));
  }
  return 0.0f;
}

// Whether the placed node's message carries its ids: the blocks keep
// their ids, and the ids of slots 1..k-1 fit the message.
template <int RUN>
__device__ __forceinline__ bool si_ids_in_message(const IpaArgs& ip) {
  return SI_HAS_IDS<RUN> && ip.k <= SI_MSG_SLOTS + 1;
}

// The spread+interpod build's message of the placed node g (of block
// `rank`): its index and pod, and its ids of slots 1..SI_MSG_SLOTS as bytes
// from the block's ids where it carries them (else 0, unread).
template <int RUN>
__device__ __forceinline__ int4 si_message(const IpaArgs& ip, const unsigned char* ids,
                                           int g, int p, int rank) {
  int4 msg = make_int4(g, p, 0, 0);
  if constexpr (SI_HAS_IDS<RUN>) {
    if (si_ids_in_message<RUN>(ip)) {
      const int c = g - rank * THREADS * RUN;
      unsigned lo = 0u, hi = 0u;
#pragma unroll
      for (int k = 1; k <= SI_MSG_SLOTS; ++k) {
        const unsigned b = ids[k * THREADS * RUN + c];
        if (k <= 4) lo |= b << (8 * (k - 1));
        else hi |= b << (8 * (k - 5));
      }
      msg.z = (int)lo;
      msg.w = (int)hi;
    }
  }
  return msg;
}

// The spread+interpod build's replica update by warps 1-15 (thread t):
// the placed pod's rows `row` into the replica `rep` (slots 1..k-1) at the
// placed node's domains, whose ids of slots 1..SI_MSG_SLOTS ride its
// message `wm` as bytes where the sender keeps them (`in_msg`), else come
// from the topology in device memory.
__device__ __forceinline__ void si_update_replica(const IpaArgs& ip, float* rep,
                                                  const float* row, int4 wm, bool in_msg,
                                                  int t) {
  const int U = ip.uq + ip.ue;
  const int* ids = ip.topology + (size_t)wm.x * ip.k;   // the node's
  for (int i = U + t - 32; i < ip.k * U; i += THREADS - 32) {
    const int k = i / U;
    const int u = i - k * U;
    const float v = row[u];
    if (v == 0.0f) continue;
    unsigned d;
    if (in_msg) {
      d = ((k <= 4 ? (unsigned)wm.z : (unsigned)wm.w) >> (8 * ((k - 1) & 3))) & 0xffu;
    } else {
      const int di = __ldg(ids + k);
      d = di < 0 ? SI_NO_ID : di < ip.nd ? (unsigned)di : SI_PAST;
    }
    if (d < (unsigned)ip.nd) {
      float* cell = rep + ((size_t)(k - 1) * ip.nd + d) * U + u;
      *cell = __fadd_rn(*cell, v);
    }
  }
}

// Warp 0: pod row pr's count entries into s.ip_list (see the header) and
// *s.ip_head = (entries, reject every node, a weighted entry exists, the
// match or carried-term row is not zero). Reads the term attributes and
// the block's totals.
__device__ void ip_build_list(const Smem& s, const IpaArgs& ip, const float* pr,
                              int lane) {
  const int* w = reinterpret_cast<const int*>(pr + POD_ROW_MAIN);
  const float* match = pr + POD_ROW_MAIN + IPW_ROWS;   // then carry[ue]
  const unsigned below = (1u << lane) - 1u;
  int n = 0;
  bool reject = false, counting = false, row_nz = false;
  // ballot-compacted appends: every lane calls with its own pred
  auto emit = [&](bool pred, int4 e) {
    const unsigned b = __ballot_sync(FULL, pred);
    if (pred) s.ip_list[n + __popc(b & below)] = e;
    n += __popc(b);
    return b != 0u;
  };
  for (int e0 = 0; e0 < IP_MAX_UE; e0 += 32) {
    const int e = e0 + lane;
    bool anti_e = false, score_e = false;
    int tk = 0;
    float wgt = 0.0f;
    if (e < ip.ue) {
      const int q = s.t_attr[e];
      tk = s.t_attr[IP_MAX_UE + e];
      const int kind = s.t_attr[2 * IP_MAX_UE + e];
      const float tw = __int_as_float(s.t_attr[3 * IP_MAX_UE + e]);
      const bool poison = s.t_attr[4 * IP_MAX_UE + e] != 0;
      if (q >= ip.uq) __trap();   // not an entry of the ledger
      const float m = q >= 0 ? match[q] : 0.0f;
      const bool carried = s.totals[ip.uq + e] > 0.0f;
      if (ip.use_ipa && kind == ANTI_REQ) {
        if (poison && carried) reject = true;
        if (m > 0.0f) {
          if (tk == TKEY_INVALID) reject = reject || carried;
          else anti_e = true;
        }
      }
      if (ip.w_ip != 0.0f) {
        // match_e * (term_weight + hard_w * [kind == AFF_REQ])
        const float eff = __fadd_rn(tw, __fmul_rn(ip.hard_w, kind == AFF_REQ ? 1.0f : 0.0f));
        wgt = __fmul_rn(m, eff);
        score_e = wgt != 0.0f && tk != TKEY_INVALID;
      }
    }
    emit(anti_e, make_int4(ip.uq + e, tk, ROLE_CARRIED_ANTI, 0));
    counting |= emit(score_e, make_int4(ip.uq + e, tk, ROLE_SCORE, __float_as_int(wgt)));
  }
  // the pod's own terms: lanes 0-3 required affinity, 4-7 required anti,
  // 8-11 preferred
  bool own = false;
  int4 oe = make_int4(0, 0, 0, 0);
  if (ip.use_ipa && lane < IP_SLOTS) {
    const int q = w[IPW_PAFF_Q + lane];
    if (q >= ip.uq) __trap();
    if (q >= 0) {   // no match anywhere and the pod matches it: holds everywhere
      own = !(!(s.totals[q] > 0.0f) && match[q] > 0.0f);
      oe = make_int4(q, w[IPW_PAFF_TK + lane], ROLE_AFF, 0);
    }
  } else if (ip.use_ipa && lane < 2 * IP_SLOTS) {
    const int q = w[IPW_PANTI_Q + lane - IP_SLOTS];
    if (q >= ip.uq) __trap();
    own = q >= 0;
    oe = make_int4(q, w[IPW_PANTI_TK + lane - IP_SLOTS], ROLE_ANTI, 0);
  } else if (ip.w_ip != 0.0f && lane >= 2 * IP_SLOTS && lane < 3 * IP_SLOTS) {
    const int q = w[IPW_PREF_Q + lane - 2 * IP_SLOTS];
    const int tk = w[IPW_PREF_TK + lane - 2 * IP_SLOTS];
    const int wb = w[IPW_PREF_W + lane - 2 * IP_SLOTS];
    if (q >= ip.uq) __trap();
    own = q >= 0 && __int_as_float(wb) != 0.0f && tk != TKEY_INVALID;
    oe = make_int4(q, tk, ROLE_SCORE, wb);
  }
  counting |= __any_sync(FULL, own && oe.z == ROLE_SCORE) != 0;
  emit(own, oe);
  if (ip.use_ipa && w[IPW_FAIL] != 0) reject = true;
  for (int u = lane; u < ip.uq + ip.ue; u += 32) row_nz |= match[u] != 0.0f;
  reject = __any_sync(FULL, reject) != 0;
  row_nz = __any_sync(FULL, row_nz) != 0;
  if (lane == 0) *s.ip_head = make_int4(n, reject, counting, row_nz);
}

// The gang carry's revert in the spread and interpod builds, beyond the
// resource rows, rr and the term cache (see the header), called by every
// thread of the cluster alike after `revert`'s block barrier: each thread
// subtracts its own nodes' entries' match (and carried-term) rows from the
// node-level counts; with `mid` (a revert at pod p's boundary, the scan
// going on) in the interpod builds, also the rows of the group's placed
// members before p - 1 from the block's totals and replica (`rep`: slot 1
// in the spread+interpod build, slot 0 in the interpod build), after the
// cluster barrier that made their assignments visible. Ends with a block
// barrier.
template <int RUN, bool SPREAD, bool IPA>
__device__ void gang_revert_counts(const Smem& s, const SpreadParam<SPREAD>& sp,
                                   const IpaParam<IPA>& ip, const GangArgs& gg,
                                   const float4* undo_b, int undo_n,
                                   const int* assignments, float* rep, int gang_cur,
                                   int p, bool mid, int rank, int N, int t) {
  const int c0 = t * RUN;
  for (int i = undo_n - 1; i >= 0; --i) {
    const int c = __float_as_int(undo_b[i * UNDO_WORDS].x);
    if (c < c0 || c >= c0 + RUN) continue;   // another thread's node
    const int pm = __float_as_int(undo_b[i * UNDO_WORDS + 1].w);
    const int g = rank * THREADS * RUN + c;
    const float* row;
    float* counts;
    int cols;
    if constexpr (IPA) {
      cols = ip.uq + ip.ue;
      row = reinterpret_cast<const float*>(ip.pod_ip + (size_t)pm * (IPW_ROWS + cols)
                                           + IPW_ROWS);
      counts = ip.node_t;
    } else {
      cols = sp.uq;
      row = sp.pod_matches + (size_t)pm * cols;
      counts = sp.podsel_t;
    }
    for (int u = 0; u < cols; ++u) {
      const float v = __ldg(row + u);
      if (v != 0.0f) atomicAdd(counts + (size_t)u * N + g, -v);
    }
  }
  if constexpr (IPA) {
    if (mid) {
      const int U = ip.uq + ip.ue;
      for (int pm = p - 2; pm >= 0 && __ldg(gg.gang_id + pm) == gang_cur; --pm) {
        const int a = __ldcg(assignments + pm);
        if (a < 0) continue;   // not placed: nothing added
        const float* row = reinterpret_cast<const float*>(
            ip.pod_ip + (size_t)pm * (IPW_ROWS + U) + IPW_ROWS);
        if (t < U) {
          const float v = __ldg(row + t);
          if (v != 0.0f) s.totals[t] = __fsub_rn(s.totals[t], v);
        }
        // cells (k, u) of slots 1..k-1 (hostname: node-level counts)
        for (int i = U + t; i < ip.k * U; i += THREADS) {
          const int k = i / U;
          const int u = i - k * U;
          const float v = __ldg(row + u);
          if (v == 0.0f) continue;
          const int d = __ldg(ip.topology + (size_t)a * ip.k + k);
          if (d < 0 || d >= ip.nd) continue;
          float* cell = rep + ((size_t)(SPREAD ? k - 1 : k) * ip.nd + d) * U + u;
          *cell = __fsub_rn(*cell, v);
        }
      }
    }
  }
  __syncthreads();
}

template <int RUN, bool SPREAD, bool IPA, bool GANG, bool NORM, bool EXT, typename... Norm>
__global__ void __launch_bounds__(THREADS, 1) assign_scan_kernel(
    const float* __restrict__ masked_static, const float* __restrict__ requests,
    const float* __restrict__ nonzero_requests,
    const float* __restrict__ allocatable, float* __restrict__ requested,
    float* __restrict__ nonzero, int* __restrict__ assignments,
    float* __restrict__ scores, int* __restrict__ feasible_counts,
    long long* __restrict__ rr_io, int P, int N, float w_lr, float w_ba,
    SpreadParam<SPREAD> sp, IpaParam<IPA> ip, GangParam<GANG> gg, Norm... nm) {
  static_assert(sizeof...(Norm) == (NORM ? 1 : 0) + (EXT ? 1 : 0),
                "the flag's NormArgs, or none, then the EXT variant's ExtArgs, or none");
  static_assert(!EXT || !(SPREAD || IPA), "EXT: the main and gang builds");
  constexpr int NB = THREADS * RUN;
  constexpr int STAGES = Build<RUN, SPREAD, IPA, GANG, EXT>::STAGES;
  constexpr int POD_ROW = Build<RUN, SPREAD, IPA, GANG, EXT>::POD_ROW;
  extern __shared__ __align__(16) float smem_base[];
  cg::cluster_group cluster = cg::this_cluster();
  constexpr bool PACKED = Build<RUN, SPREAD, IPA, GANG, EXT>::PACKED;
  const Smem s = PACKED ? carve_packed<SPREAD, STAGES, POD_ROW, IPA>(smem_base, NB)
                        : carve<SPREAD, STAGES, POD_ROW, IPA>(smem_base, NB);
  const int rank = (int)cluster.block_rank();
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  const int c0 = t * RUN;                 // the run's first shared column
  const int g0 = rank * NB + c0;          // and its first node

  // ---- load the run's ledger, fill the ring's padding, start the rows
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    const int c = c0 + j;
    const int g = g0 + j;
    const bool in = g < N;
    s.a_pods[c] = in ? allocatable[(size_t)g * R + PODS] : 0.0f;
    s.a_cpu[c] = in ? allocatable[(size_t)g * R + CPU] : 0.0f;
    s.a_mem[c] = in ? allocatable[(size_t)g * R + MEM] : 0.0f;
    s.r_pods[c] = in ? requested[(size_t)g * R + PODS] : 0.0f;
    s.r_cpu[c] = in ? requested[(size_t)g * R + CPU] : 0.0f;
    s.r_mem[c] = in ? requested[(size_t)g * R + MEM] : 0.0f;
    s.z_cpu[c] = in ? nonzero[(size_t)g * 2] : 0.0f;
    s.z_mem[c] = in ? nonzero[(size_t)g * 2 + 1] : 0.0f;
    for (int k = 0; k < STAGES; ++k)
      if (!in) s.ring[k * NB + (RUN == 8 ? slot_at(c) : c)] = -INFINITY;
  }
  [[maybe_unused]] int dom[RUN];     // the run's zone ids (spread build)
  // the zones in use among the warp's nodes: bit d of zlo (zone d) and of
  // zhi (zone 32 + d), fixed for the launch
  [[maybe_unused]] unsigned zlo = 0u, zhi = 0u;
  if constexpr (SPREAD) {
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      dom[j] = g0 + j < N ? sp.zone[g0 + j] : -1;
      if (dom[j] >= sp.nz && dom[j] < sp.nd) __trap();   // a zone not counted in
      if (dom[j] >= 0 && dom[j] < sp.nz) {
        if (dom[j] < 32) zlo |= 1u << dom[j];
        else zhi |= 1u << (dom[j] - 32);
      }
    }
    zlo = __reduce_or_sync(FULL, zlo);
    zhi = __reduce_or_sync(FULL, zhi);
    // zones a warp never writes stay 0, and so do a partial's pad words
    for (int i = t; i < WARPS * SP_WORDS; i += THREADS) s.sp_w[i] = 0;
    if (t < SP_CHUNKS) s.sp_out[t] = make_int4(0, 0, 0, 0);
  }
  // a block's spread partial: 1 + nz words, in 16-byte chunks
  [[maybe_unused]] int sp_chunks = 0;
  [[maybe_unused]] unsigned sp_bytes = 0u;
  if constexpr (SPREAD) {
    sp_chunks = (1 + sp.nz + 3) / 4;
    sp_bytes = 16u * (unsigned)sp_chunks;
  }
  [[maybe_unused]] float* dom_b = nullptr;   // this block's replica (interpod build)
  if constexpr (IPA && SPREAD) {
    // the spread+interpod build: dom_b is the replica's slot 1 (slots
    // 1..k-1, in shared memory where they fit), and the block's domain ids
    // as bytes follow the carve (see the header)
    constexpr size_t BASE = smem_bytes<true, true, PACKED, NORM>(NB, STAGES, POD_ROW);
    unsigned char* ids = si_ids<RUN, PACKED, NORM>(smem_base);
    if (t < SI_BLOCK_WORDS) si_block<RUN, PACKED, NORM>(smem_base)[t] = 0;
    const int slot = ip.nd * (ip.uq + ip.ue);   // cells of one topology slot
    if (si_rep_shared<RUN>(BASE, ip.k, ip.nd, ip.uq + ip.ue)) {
      dom_b = reinterpret_cast<float*>(ids + si_ids_bytes<RUN>());
      for (int i = t; i < (ip.k - 1) * slot; i += THREADS) dom_b[i] = ip.dom0[slot + i];
    } else {
      float* rep = ip.dom + (size_t)rank * ip.k * slot;
      for (int i = t; i < ip.k * slot; i += THREADS) rep[i] = ip.dom0[i];
      dom_b = rep + slot;
    }
    if constexpr (SI_HAS_IDS<RUN>) {
#pragma unroll
      for (int j = 0; j < RUN; ++j) {
        const int g = g0 + j;
        for (int k = 0; k < IP_MAX_K; ++k) {
          const int d = (k < ip.k && g < N) ? ip.topology[(size_t)g * ip.k + k] : -1;
          ids[k * NB + c0 + j] =
              (unsigned char)(d < 0 ? SI_NO_ID : d < ip.nd ? (unsigned)d : SI_PAST);
        }
      }
    }
  }
  if constexpr (IPA) {
    if constexpr (!SPREAD) {
      const int cells = ip.k * ip.nd * (ip.uq + ip.ue);
      dom_b = ip.dom + (size_t)rank * cells;
      for (int i = t; i < cells; i += THREADS) dom_b[i] = ip.dom0[i];   // the block's replica
    }
    for (int i = t; i < 5 * IP_MAX_UE; i += THREADS) {
      const int a = i / IP_MAX_UE, e = i - a * IP_MAX_UE;
      s.t_attr[i] = e < ip.ue ? ip.term_attr[a * ip.ue + e] : 0;
    }
    if (t < IP_MAX_U) s.totals[t] = t < ip.uq + ip.ue ? ip.totals[t] : 0.0f;
  }
  if constexpr (NM_GUESS<SPREAD, IPA, NORM>) {   // the flag's table entry, counts, words
    NormMain<RUN>& kp = keep_of(nm...);
    nm_table(s)[t] = make_int2(0, 0);
    kp.cnt_ok = false;
    kp.next = 0u;
    if constexpr (RUN <= 4) {
#pragma unroll
      for (int j = 0; j < RUN; ++j)
        kp.w[j] = g0 + j < N ? kp.node_w[g0 + j] : make_ulonglong2(0ull, 0ull);
    }
  }
  if constexpr (EXT && EXT_REGS<RUN>) {   // the run's EXT columns, into registers
    ExtMain<RUN>& x = ext_of(nm...);
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      const int g = g0 + j;
      const bool in = g < N;
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        x.a[j][f] = in ? allocatable[(size_t)g * R + GPU + f] : 0.0f;
        x.q[j][f] = in ? requested[(size_t)g * R + GPU + f] : 0.0f;
      }
      x.w[j] = in ? x.node[EXT_NODE_WORDS * (size_t)g + EXT_NODE_PORT] : 0ull;
    }
  }
  auto issue_row = [&](int p) {
    if (p < P) {
      float* slot = s.ring + (p % STAGES) * NB;
      const float* row = masked_static + (size_t)p * N;
      if constexpr (RUN == 8) {
        // the block's segment of the row, `len` entries from node `lo`: its
        // 16-byte chunks (all but a tail of N % 4 when the segment starts
        // 16-byte aligned, none when it does not) as 16-byte copies, chunk
        // t and t + THREADS by thread t, the rest as 4-byte copies, entry
        // i by thread i % THREADS; coalesced, and published to the block
        // one pod early (see the header)
        const int lo = rank * NB;
        const int len = max(min(N - lo, NB), 0);
        const bool aligned = (reinterpret_cast<uintptr_t>(row + lo) & 15u) == 0u;
        const int n16 = aligned ? (len & ~3) : 0;
#pragma unroll
        for (int k = 0; k < RUN / 4; ++k) {
          const int i = 4 * (t + k * THREADS);
          if (i < n16) cp_async16(slot + slot_at(i), row + lo + i);
        }
        if (n16 < len) {
#pragma unroll
          for (int k = 0; k < RUN; ++k) {
            const int i = t + k * THREADS;
            if (i >= n16 && i < len) cp_async4(slot + slot_at(i), row + lo + i);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < RUN; ++j)
          if (g0 + j < N) cp_async4(slot + c0 + j, row + g0 + j);
      }
      if constexpr (SPREAD && !IPA) {   // + spread_q and the match row
        if (t < SP_M + sp.uq)
          cp_async4(s.pods + (p % POD_SLOTS) * POD_ROW + t,
                    t < R ? requests + (size_t)p * R + t
                    : t < SP_Q ? nonzero_requests + (size_t)p * 2 + (t - R)
                    : t == SP_Q ? reinterpret_cast<const float*>(sp.spread_q + p)
                    : sp.pod_matches + (size_t)p * sp.uq + (t - SP_M));
        if constexpr (GANG)   // + the group id and quorum, in the slot's free words
          if (t == Build<RUN, SPREAD, IPA, GANG>::GWI || t == Build<RUN, SPREAD, IPA, GANG>::GWM)
            cp_async4(s.pods + (p % POD_SLOTS) * POD_ROW + t,
                      reinterpret_cast<const float*>(
                          (t == Build<RUN, SPREAD, IPA, GANG>::GWI ? gg.gang_id : gg.gang_min) + p));
      } else if constexpr (IPA) {   // + the interpod words
        const int ipw = IPW_ROWS + ip.uq + ip.ue;
        if (t < POD_ROW_MAIN + ipw)
          cp_async4(s.pods + (p % POD_SLOTS) * POD_ROW + t,
                    t < R ? requests + (size_t)p * R + t
                    : t < POD_ROW_MAIN ? nonzero_requests + (size_t)p * 2 + (t - R)
                    : reinterpret_cast<const float*>(
                          ip.pod_ip + (size_t)p * ipw + (t - POD_ROW_MAIN)));
        if constexpr (SPREAD)   // + spread_q, in the slot's last word
          if (t == SI_Q)
            cp_async4(s.pods + (p % POD_SLOTS) * POD_ROW + SI_Q,
                      reinterpret_cast<const float*>(sp.spread_q + p));
        if constexpr (GANG)   // + the group id and quorum, in the slot's free words
          if (t == Build<RUN, SPREAD, IPA, GANG>::GWI || t == Build<RUN, SPREAD, IPA, GANG>::GWM)
            cp_async4(s.pods + (p % POD_SLOTS) * POD_ROW + t,
                      reinterpret_cast<const float*>(
                          (t == Build<RUN, SPREAD, IPA, GANG>::GWI ? gg.gang_id : gg.gang_min) + p));
      } else if constexpr (GANG) {   // + the group id and quorum
        if (t <= GW_MIN)
          cp_async4(s.pods + (p % POD_SLOTS) * POD_ROW + t,
                    t < R ? requests + (size_t)p * R + t
                    : t < POD_ROW_MAIN ? nonzero_requests + (size_t)p * 2 + (t - R)
                    : reinterpret_cast<const float*>(
                          (t == GW_ID ? gg.gang_id : gg.gang_min) + p));
        if constexpr (EXT) {   // + the port word and the volume words
          if (t == EXT_PW || t == EXT_PW + 1)
            cp_async4(s.pods + (p % POD_SLOTS) * POD_ROW + t,
                      reinterpret_cast<const float*>(ext_of(nm...).pod + EXT_POD_WORDS * (size_t)p)
                          + (t - EXT_PW));
          if (t == EXT_VW || t == EXT_VW + 4)
            cp_async16(s.pods + (p % POD_SLOTS) * POD_ROW + t,
                       reinterpret_cast<const float*>(ext_of(nm...).pod + EXT_POD_WORDS * (size_t)p
                                                      + EXT_POD_VOL) + (t - EXT_VW));
        }
      } else if constexpr (EXT) {   // the main build's row, + the port and volume words
        if (t < POD_ROW_MAIN || t == EXT_PW || t == EXT_PW + 1)
          cp_async4(s.pods + (p % POD_SLOTS) * POD_ROW + t,
                    t < R ? requests + (size_t)p * R + t
                    : t < POD_ROW_MAIN ? nonzero_requests + (size_t)p * 2 + (t - R)
                    : reinterpret_cast<const float*>(ext_of(nm...).pod + EXT_POD_WORDS * (size_t)p)
                          + (t - EXT_PW));
        if (t == EXT_VW || t == EXT_VW + 4)
          cp_async16(s.pods + (p % POD_SLOTS) * POD_ROW + t,
                     reinterpret_cast<const float*>(ext_of(nm...).pod + EXT_POD_WORDS * (size_t)p
                                                    + EXT_POD_VOL) + (t - EXT_VW));
      } else {
        if (t < POD_ROW)
          cp_async4(s.pods + (p % POD_SLOTS) * POD_ROW + t,
                    t < R ? requests + (size_t)p * R + t
                          : nonzero_requests + (size_t)p * 2 + (t - R));
      }
      if constexpr (NORM) {   // + the flag's pod words
        if (t >= THREADS - NM_COPIERS) {
          const int k = 4 * (t - (THREADS - NM_COPIERS));
          cp_async16(reinterpret_cast<float*>(s.nm_pods + (p % POD_SLOTS) * NM_ROW + k),
                     reinterpret_cast<const float*>(norm_of(nm...).pod_w + (size_t)p * NM_ROW + k));
        }
      }
    }
    cp_async_commit();    // one group per pod, empty past the last
  };
  for (int p = 0; p < STAGES - 1; ++p) issue_row(p);
  cp_async_wait<STAGES - 2>();  // pod 0's row has landed

  // ---- one mbarrier per pod parity: a phase completes when this block has
  // armed it and the triples of all CLUSTER blocks (16 bytes each) landed
  if (t == 0) {
    mbar_init(&s.bar[0], 1);
    mbar_init(&s.bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_arm(&s.bar[0], CLUSTER * TRIPLE_BYTES);
    mbar_arm(&s.bar[1], CLUSTER * TRIPLE_BYTES);
    if constexpr (SPREAD) {
      mbar_init(s.bar_sp, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      // the spread+interpod build arms it at each exchange, for its size
      if constexpr (!IPA) mbar_arm(s.bar_sp, CLUSTER * sp_bytes);
    }
    if constexpr (IPA) {
      mbar_init(s.bar_ip, 1);
      mbar_init(s.bar_win, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      if constexpr (!SPREAD) mbar_arm(s.bar_ip, CLUSTER * IP_BYTES);
      mbar_arm(s.bar_win, IP_BYTES);
    }
    if constexpr (NM_GUESS<SPREAD, IPA, NORM>) {   // the flag's second triples
      mbar_init(s.bar_nm, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      mbar_arm(s.bar_nm, CLUSTER * 16u);
    }
  }
  // where warp 0's lane l sends this block's triples: block l's slot
  // `rank` and mbarrier, of each parity
  unsigned to_slot0 = 0u, to_slot1 = 0u, to_bar0 = 0u, to_bar1 = 0u;
  if (warp == 0 && lane < CLUSTER) {
    to_slot0 = map_rank(smem_u32(&s.cslot[rank]), lane);
    to_slot1 = map_rank(smem_u32(&s.cslot[CLUSTER + rank]), lane);
    to_bar0 = map_rank(smem_u32(&s.bar[0]), lane);
    to_bar1 = map_rank(smem_u32(&s.bar[1]), lane);
  }
  // where warp 0's lane l sends its chunks of this block's spread partial:
  // block (l % 16)'s slot `rank` and mbarrier
  unsigned to_sp_slot = 0u, to_sp_bar = 0u, sp_phase = 0u;
  if constexpr (SPREAD) {
    if (warp == 0) {
      to_sp_slot = map_rank(smem_u32(&s.sp_slot[rank * SP_CHUNKS]), lane % CLUSTER);
      to_sp_bar = map_rank(smem_u32(s.bar_sp), lane % CLUSTER);
    }
  }
  // the next spread pod's entry and the run's counts of its column
  // (spread build; loaded one pod ahead, see the header)
  [[maybe_unused]] int q_next = -1;
  [[maybe_unused]] float nxt[RUN];
  if constexpr (SPREAD && IPA && NORM) {   // (unread before its first load; kept in
                                           // this build, whose SASS it keeps)
#pragma unroll
    for (int j = 0; j < RUN; ++j) nxt[j] = 0.0f;
  }
  [[maybe_unused]] auto fetch_counts = [&](int pn) {
    if constexpr (SPREAD) {
      q_next = pn < P ? __float_as_int(s.pods[(pn % POD_SLOTS) * POD_ROW
                                              + Build<RUN, SPREAD, IPA, GANG>::SPQ])
                      : -1;
      if (q_next >= sp.uq) __trap();   // not an entry of the ledger
      if (q_next >= 0) {
        const float* col = sp.podsel_t + (size_t)q_next * N;
#pragma unroll
        for (int j = 0; j < RUN; ++j) nxt[j] = g0 + j < N ? col[g0 + j] : 0.0f;
      }
    }
  };

  // where warp 0's lane l sends this block's (min, max) of a counting pod:
  // block l's slot `rank` and mbarrier
  unsigned to_ip_slot = 0u, to_ip_bar = 0u, ip_phase = 0u, win_phase = 0u;
  [[maybe_unused]] bool win_pending = false;   // the last pod's node is on its way
  if constexpr (IPA && SPREAD) {   // lane l: block l % 16, on the spread mbarrier
    if (warp == 0) to_ip_slot = map_rank(smem_u32(&s.ip_slot[rank]), lane % CLUSTER);
  } else if constexpr (IPA) {
    if (warp == 0 && lane < CLUSTER) {
      to_ip_slot = map_rank(smem_u32(&s.ip_slot[rank]), lane);
      to_ip_bar = map_rank(smem_u32(s.bar_ip), lane);
    }
  }

  unsigned int rr = (unsigned int)(*rr_io);
  // requests of the pod the cached terms belong to (none yet)
  unsigned key_cpu = 0u, key_mem = 0u, key_nzc = 0u, key_nzm = 0u;
  bool key_zero = false, have_terms = false;
  // the cached terms at 8 nodes a thread: byte j % 4 of lr1[j / 4] is run
  // position j's LeastRequested + 1, of bab[j / 4] its BalancedAllocation
  [[maybe_unused]] unsigned lr1[2] = {0u, 0u}, bab[2] = {0u, 0u};
  // the open group (gang build): its id (0 = none), members placed, quorum,
  // rr at its first member, and this block's undo-log entries
  [[maybe_unused]] int gang_cur = 0, gang_placed = 0, gang_min_cur = 0, undo_n = 0;
  [[maybe_unused]] unsigned int rr_entry = 0u;
  [[maybe_unused]] float4* undo_b = nullptr;   // this block's undo log
  if constexpr (GANG) undo_b = gg.undo + (size_t)rank * P * Build<RUN, SPREAD, IPA, GANG, EXT>::UNDO;
  // Revert the open group: every thread restores its own nodes' entries,
  // newest first. Called by every thread of the cluster alike.
  [[maybe_unused]] auto revert = [&]() {
    __syncthreads();   // the owners' newest entries are visible
    for (int i = undo_n - 1; i >= 0; --i) {
      const float4 e0 = undo_b[i * Build<RUN, SPREAD, IPA, GANG, EXT>::UNDO];
      const int c = __float_as_int(e0.x);
      if (c < c0 || c >= c0 + RUN) continue;   // another thread's node
      const float4 e1 = undo_b[i * Build<RUN, SPREAD, IPA, GANG, EXT>::UNDO + 1];
      s.r_pods[c] = e0.y;
      s.r_cpu[c] = e0.z;
      s.r_mem[c] = e0.w;
      s.z_cpu[c] = e1.x;
      s.z_mem[c] = e1.y;
      const int changed = __float_as_int(e1.z);   // bit f - GPU: column f
      if (changed != 0) {
        const float4 e2 = undo_b[i * Build<RUN, SPREAD, IPA, GANG, EXT>::UNDO + 2];
        const size_t row = (size_t)(rank * NB + c) * R;
        if (changed & 1) requested[row + GPU] = e2.x;
        if (changed & 2) requested[row + SCRATCH] = e2.y;
        if (changed & 4) requested[row + OVERLAY] = e2.z;
        if constexpr (EXT)   // the node's old port and volume words (and registers)
          ext_restore<RUN>(ext_of(nm...), c - c0, rank * NB + c, changed, e1, e2,
                           undo_b + (size_t)i * EXT_UNDO_WORDS);
      }
    }
    rr = rr_entry;
    have_terms = false;   // the cached terms are of the reverted ledger
  };
  // barriers initialised and pod 0's row visible in every block before any
  // block sends
  cluster.sync();
  if constexpr (SPREAD) fetch_counts(0);
  if constexpr (NM_GUESS<SPREAD, IPA, NORM>)   // the flag's first pod
    norm_prepare<RUN>(keep_of(nm...), s, 0, lane, t, c0, g0, N);

  for (int p = 0; p < P; ++p) {
    cp_async_wait<STAGES - 3>();  // this thread's copies of pods p and p+1 landed
    const float* pr = s.pods + (p % POD_SLOTS) * POD_ROW;   // pod p's row
    if constexpr (GANG) {
      const int gid = __float_as_int(pr[Build<RUN, SPREAD, IPA, GANG>::GWI]);
      if (gid != gang_cur) {   // a group boundary: settle the group left
        if (gang_cur > 0 && gang_placed < gang_min_cur) {
          if constexpr (SPREAD || IPA) {
            if constexpr (IPA) {
              // the last member's node, still on its way: its rows never
              // reach the totals and replica (see the header)
              if (win_pending) {
                if (warp != 0) mbar_wait(s.bar_win, win_phase);
                if (t == 32) mbar_arm(s.bar_win, IP_BYTES);   // for the next one
                win_phase ^= 1u;
                win_pending = false;
              }
              cluster.sync();   // every member's assignment, in every block
            }
            revert();
            gang_revert_counts<RUN, SPREAD, IPA>(s, sp, ip, gg, undo_b, undo_n, assignments,
                                                 dom_b, gang_cur, p, true, rank, N, t);
            if constexpr (SPREAD) fetch_counts(p);   // pod p's counts, of the restored ledger
          } else {
            revert();
          }
        }
        if (gid > 0) {         // and open the pod's group
          gang_placed = 0;
          gang_min_cur = __float_as_int(pr[Build<RUN, SPREAD, IPA, GANG>::GWM]);
          undo_n = 0;
          rr_entry = rr;
        }
        gang_cur = gid;
      }
    }
    float rq[R];
#pragma unroll
    for (int f = 0; f < R; ++f) rq[f] = pr[f];
    Pod pod;
    pod.r_cpu = rq[CPU];
    pod.r_mem = rq[MEM];
    pod.nz_cpu = pr[R];
    pod.nz_mem = pr[R + 1];
    pod.all_zero = rq[CPU] == 0.0f && rq[MEM] == 0.0f && rq[GPU] == 0.0f
                   && rq[SCRATCH] == 0.0f && rq[OVERLAY] == 0.0f;
    // the same request bits as the pod the cached terms were computed for
    // (and with EXT, the same gpu, storage and port key; see ext_reuse)
    const bool reuse = ext_reuse<EXT>(have_terms && __float_as_uint(pod.r_cpu) == key_cpu
                                      && __float_as_uint(pod.r_mem) == key_mem
                                      && __float_as_uint(pod.nz_cpu) == key_nzc
                                      && __float_as_uint(pod.nz_mem) == key_nzm
                                      && pod.all_zero == key_zero, pr, nm...);
    key_cpu = __float_as_uint(pod.r_cpu);
    key_mem = __float_as_uint(pod.r_mem);
    key_nzc = __float_as_uint(pod.nz_cpu);
    key_nzm = __float_as_uint(pod.nz_mem);
    key_zero = pod.all_zero;
    have_terms = true;

    // ---- score the run
    float ms[RUN], lr[RUN], ba[RUN];
    if constexpr (RUN == 8) {
      // the slot's swizzle puts the run's first chunk 4 entries on in lanes
      // 4-7 of each eight (see slot_at)
      const float* at = s.ring + (p % STAGES) * NB + c0;
      const int sw = ((lane >> 2) & 1) << 2;
      const float4 a = *reinterpret_cast<const float4*>(at + sw);
      const float4 b = *reinterpret_cast<const float4*>(at + (4 - sw));
      ms[0] = a.x; ms[1] = a.y; ms[2] = a.z; ms[3] = a.w;
      ms[4] = b.x; ms[5] = b.y; ms[6] = b.z; ms[7] = b.w;
    } else {
      load_run<RUN>(s.ring + (p % STAGES) * NB + c0, ms);
    }
    if (reuse) {
      if constexpr (PACKED) {
#pragma unroll
        for (int j = 0; j < RUN; ++j) {
          lr[j] = byte_term(lr1[j / 4], j % 4, LR_BIAS);
          ba[j] = byte_term(bab[j / 4], j % 4, BA_BIAS);
        }
      } else {
        load_run<RUN>(s.t_lr + c0, lr);
        load_run<RUN>(s.t_ba + c0, ba);
      }
    } else {
      [[maybe_unused]] ExtPod xv;
      if constexpr (EXT) xv = ext_pod(pr);
#pragma unroll
      for (int j = 0; j < RUN; ++j) {
        if constexpr (EXT)
          ext_terms<RUN>(s, pod, xv, c0 + j, g0 + j, j, ext_of(nm...), allocatable, requested,
                         &lr[j], &ba[j]);
        else
          node_terms(s, pod, c0 + j, &lr[j], &ba[j]);
        if constexpr (PACKED) {
          lr1[j / 4] = put_byte(lr1[j / 4], term_byte(lr[j], LR_BIAS), j % 4);
          bab[j / 4] = put_byte(bab[j / 4], term_byte(ba[j], BA_BIAS), j % 4);
        } else {
          s.t_lr[c0 + j] = lr[j];
          s.t_ba[c0 + j] = ba[j];
        }
      }
    }
    // ---- the flag's counts of the run and the warp's maxima (the interpod
    // builds count after their predicate, below)
    [[maybe_unused]] unsigned nc[RUN] = {};   // packed counts (norm_counts)
    float m_tt = 0.0f, m_na = 0.0f;   // the cluster's maxima over the feasible nodes
    bool nm_x = false;                // the pod's counts can be nonzero: exchanged
    if constexpr (!IPA) {
      if constexpr (NORM) {
        // main, gang, spread: the pod was prepared while the pod before it
        // waited (norm_prepare); its warp's true maxima for the triple's
        // free word and its flag terms of the guess (see the header)
        NormMain<RUN>& kp = keep_of(nm...);
        kp.tt = kp.tt_n;
        kp.na = kp.na_n;
        kp.key = kp.key_n;
        kp.guess = kp.guess_n;
        kp.at = kp.at_n;
        nm_x = kp.x_n;
        if (nm_x) {
          unsigned mt = 0u, mn = 0u;
#pragma unroll
          for (int j = 0; j < RUN; ++j) {
            if (ms[j] > -INFINITY && lr[j] >= 0.0f) {
              mt = max(mt, kp.cnt[j] & 0xffu);
              mn = max(mn, kp.cnt[j] >> 8);
            }
          }
          mt = __reduce_max_sync(FULL, mt);
          mn = __reduce_max_sync(FULL, mn);
          if (lane == 0) s.nm_w[warp] = make_int2((int)mt, (int)mn);
          float fl[RUN];
          load_run<RUN>(nm_flag(s) + c0, fl);
#pragma unroll
          for (int j = 0; j < RUN; ++j) ms[j] = __fadd_rn(ms[j], fl[j]);
        } else {
          const float q = __fadd_rn(__fmul_rn(kp.w_tt, MAX_PRIORITY), __fmul_rn(kp.w_na, 0.0f));
#pragma unroll
          for (int j = 0; j < RUN; ++j) ms[j] = __fadd_rn(ms[j], q);
        }
      }
    } else if constexpr (NORM && !SPREAD) {
      // interpod: the pod prepared as above and its flag terms of the
      // guess; its warp's true maxima follow the predicate (below)
      NormMain<RUN>& kp = keep_of(nm...);
      kp.tt = kp.tt_n;
      kp.na = kp.na_n;
      kp.key = kp.key_n;
      kp.guess = kp.guess_n;
      kp.at = kp.at_n;
      nm_x = kp.x_n;
      float fl[RUN];
      if (nm_x) {
        load_run<RUN>(nm_flag(s) + c0, fl);
      } else {
        const float q = __fadd_rn(__fmul_rn(kp.w_tt, MAX_PRIORITY), __fmul_rn(kp.w_na, 0.0f));
#pragma unroll
        for (int j = 0; j < RUN; ++j) fl[j] = q;
      }
#pragma unroll
      for (int j = 0; j < RUN; ++j) ms[j] = __fadd_rn(ms[j], fl[j]);
    }
    // ---- SelectorSpread of the run (spread build)
    [[maybe_unused]] float ss[RUN];
    if constexpr (SPREAD && !IPA) {
      if (q_next < 0) {   // pod p has no entry (fetched one pod ahead)
#pragma unroll
        for (int j = 0; j < RUN; ++j) ss[j] = MAX_PRIORITY;
      } else {
        // the warp's max feasible count, any zoned feasible node, and its
        // zones' sums of the feasible counts, as integers
        bool fe[RUN];
        int cmax = 0;
        bool zoned = false;
#pragma unroll
        for (int j = 0; j < RUN; ++j) {
          fe[j] = ms[j] > -INFINITY && lr[j] >= 0.0f;
          if (!fe[j]) continue;
          cmax = max(cmax, (int)nxt[j]);
          zoned = zoned || dom[j] >= 0;
        }
        int* wsl = s.sp_w + warp * SP_WORDS;
        auto zone_sum = [&](int d) {
          int v = 0;
#pragma unroll
          for (int j = 0; j < RUN; ++j) v += (fe[j] && dom[j] == d) ? (int)nxt[j] : 0;
          v = __reduce_add_sync(FULL, v);
          if (lane == 0) wsl[1 + d] = v;
        };
        for (unsigned m = zlo; m != 0u; m &= m - 1u) zone_sum(__ffs((int)m) - 1);
        for (unsigned m = zhi; m != 0u; m &= m - 1u) zone_sum(32 + __ffs((int)m) - 1);
        const int wmax = __reduce_max_sync(FULL, cmax);
        const unsigned wzoned = __ballot_sync(FULL, zoned);
        if (lane == 0) wsl[0] = wmax | (wzoned != 0u ? SP_ZONED : 0);
        __syncthreads();
        if (warp == 0) {   // the block's partial, into slot `rank` of every block
          int* out = reinterpret_cast<int*>(s.sp_out);
          const int w0 = lane < WARPS ? s.sp_w[lane * SP_WORDS] : 0;
          const int bmax = __reduce_max_sync(FULL, w0 & (SP_ZONED - 1));
          const unsigned bzoned = __reduce_or_sync(FULL, (unsigned)(w0 & SP_ZONED));
          for (int d = lane; d < sp.nz; d += 32) {
            int z = 0;
#pragma unroll
            for (int w = 0; w < WARPS; ++w) z += s.sp_w[w * SP_WORDS + 1 + d];
            out[1 + d] = z;
          }
          if (lane == 0) out[0] = bmax | (int)bzoned;
          __syncwarp();
          for (int k = lane / CLUSTER; k < sp_chunks; k += 32 / CLUSTER)
            st_async_v4(to_sp_slot + k * 16, s.sp_out[k], to_sp_bar);
        }
        if constexpr (NORM)   // (pod p+1, its row published by this barrier; its
          // flag terms after the triples are sent)
          if (p + 1 < P) norm_prepare<RUN, false>(keep_of(nm...), s, p + 1, lane, t, c0, g0, N);
        mbar_wait(s.bar_sp, sp_phase);
        if (t == 0) mbar_arm(s.bar_sp, CLUSTER * sp_bytes);   // next exchanging pod
        sp_phase ^= 1u;
        // every warp: the cluster's max count, zoned, and zone sums (lane d
        // zone d, and zone 32 + d in zhi_sum)
        const int b0 = lane < CLUSTER ? sp_word(s, lane, 0) : 0;
        const int max_c = __reduce_max_sync(FULL, b0 & (SP_ZONED - 1));
        const unsigned any_z = __reduce_or_sync(FULL, (unsigned)(b0 & SP_ZONED));
        int zlo_sum = 0, zhi_sum = 0;
        if (lane < sp.nz) {
#pragma unroll
          for (int b = 0; b < CLUSTER; ++b) zlo_sum += sp_word(s, b, 1 + lane);
        }
        if (lane + 32 < sp.nz) {
#pragma unroll
          for (int b = 0; b < CLUSTER; ++b) zhi_sum += sp_word(s, b, 33 + lane);
        }
        const float max_node = (float)max_c;
        const float max_zone = (float)__reduce_max_sync(FULL, max(zlo_sum, zhi_sum));
        const bool have_zones = any_z != 0u;
        const double r_node = __drcp_rn((double)fmaxf(max_node, 1.0f));
        const double r_zone = __drcp_rn((double)fmaxf(max_zone, 1.0f));
#pragma unroll
        for (int j = 0; j < RUN; ++j) {
          const int d = dom[j];
          int zc = __shfl_sync(FULL, zlo_sum, d & 31);
          if (sp.nz > 32) {
            const int zc_hi = __shfl_sync(FULL, zhi_sum, d & 31);
            if (d >= 32) zc = zc_hi;
          }
          const bool summed = d >= 0 && d < sp.nz;
          // a node without a zone scores its node part alone
          const float zone_s =
              d >= 0 ? spread_part(max_zone, summed ? (float)zc : 0.0f, r_zone) : 0.0f;
          ss[j] = spread_score(spread_part(max_node, nxt[j], r_node), zone_s, d >= 0,
                               have_zones);
        }
      }
    }

    // ---- inter-pod (anti-)affinity of the run (interpod build)
    [[maybe_unused]] float ipsc[RUN];   // InterPodAffinityPriority
    [[maybe_unused]] bool ipok[RUN];    // InterPodAffinityMatches
    [[maybe_unused]] int4 head = make_int4(0, 0, 0, 0);
    if constexpr (IPA) {
      // 1. warp 0: the previous pod's rows into the totals (when it was
      // placed) and the pod's count entries; the other warps: the previous
      // pod's node index, and its rows into the replica at the node's
      // domains
      const int U = ip.uq + ip.ue;
      if (warp == 0) {
        if (win_pending) {
          const float* row = s.pods + ((p - 1) % POD_SLOTS) * POD_ROW + POD_ROW_MAIN
                             + IPW_ROWS;
          for (int u = lane; u < U; u += 32) s.totals[u] = __fadd_rn(s.totals[u], row[u]);
          __syncwarp();
        }
        ip_build_list(s, ip, pr, lane);
      } else if (win_pending) {
        mbar_wait(s.bar_win, win_phase);
        if (t == 32) mbar_arm(s.bar_win, IP_BYTES);   // for the next one
        if constexpr (SPREAD) {   // (the spread+interpod build)
          si_update_replica(ip, dom_b,
                            s.pods + ((p - 1) % POD_SLOTS) * POD_ROW + POD_ROW_MAIN + IPW_ROWS,
                            *s.win_slot,
                            si_ids_in_message<RUN>(ip), t);
        } else {
          const int* ids = ip.topology + (size_t)s.win_slot->x * ip.k;   // the node's
          const float* row = s.pods + ((p - 1) % POD_SLOTS) * POD_ROW + POD_ROW_MAIN
                             + IPW_ROWS;
          // cells (k, u) of slots 1..k-1 (hostname: node-level counts)
          for (int i = U + t - 32; i < ip.k * U; i += THREADS - 32) {
            const int k = i / U;
            const int u = i - k * U;
            const float v = row[u];
            if (v == 0.0f) continue;
            const int d = __ldg(ids + k);
            if (d >= 0 && d < ip.nd) {
              float* cell = dom_b + ((size_t)k * ip.nd + d) * U + u;
              *cell = __fadd_rn(*cell, v);
            }
          }
        }
      }
      if (win_pending) win_phase ^= 1u;
      // one barrier publishes the entries and the replica
      __syncthreads();
      head = *s.ip_head;
      // 2. feasibility and counts of the run's feasible nodes
      float cnt[RUN];
      int lo = 0, hi = 0;   // min and max count, clamped through 0
      if constexpr (SPREAD) {
        // the spread+interpod build: the entries outer and the run's nodes
        // inner, so the run's loads of one entry are independent; each
        // node's entries in list order, as below
        const unsigned char* ids = si_ids<RUN, PACKED, NORM>(smem_base);
        bool live[RUN];
        float viol[RUN];
        bool any = false;
#pragma unroll
        for (int j = 0; j < RUN; ++j) {
          ipsc[j] = 0.0f;
          cnt[j] = 0.0f;
          viol[j] = 0.0f;
          ipok[j] = head.y == 0 && ms[j] > -INFINITY && lr[j] >= 0.0f;
          live[j] = ipok[j] && head.x != 0;
          any = any || live[j];
        }
        if (any) {
          for (int i = 0; i < head.x; ++i) {
            const int4 e = s.ip_list[i];
#pragma unroll
            for (int j = 0; j < RUN; ++j) {
              if (!live[j]) continue;
              const float v = si_count<RUN>(ip, dom_b, ids, e.x, e.y, c0 + j, g0 + j, N);
              if (e.z == ROLE_SCORE) cnt[j] = __fadd_rn(cnt[j], __fmul_rn(__int_as_float(e.w), v));
              else if (e.z == ROLE_CARRIED_ANTI) viol[j] = __fadd_rn(viol[j], v);
              else if (e.z == ROLE_ANTI) ipok[j] = ipok[j] && v == 0.0f;
              else ipok[j] = ipok[j] && v > 0.0f;   // ROLE_AFF
            }
          }
        }
#pragma unroll
        for (int j = 0; j < RUN; ++j) {
          ipok[j] = ipok[j] && viol[j] == 0.0f;
          if (ipok[j]) {
            lo = min(lo, (int)cnt[j]);
            hi = max(hi, (int)cnt[j]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < RUN; ++j) {
          ipsc[j] = 0.0f;
          cnt[j] = 0.0f;
          ipok[j] = head.y == 0 && ms[j] > -INFINITY && lr[j] >= 0.0f;
          if (!ipok[j] || head.x == 0) continue;
          float c = 0.0f, viol = 0.0f;
          for (int i = 0; i < head.x; ++i) {
            const int4 e = s.ip_list[i];
            const float v = ip_count(ip, dom_b, e.x, e.y, g0 + j, N);
            if (e.z == ROLE_SCORE) c = __fadd_rn(c, __fmul_rn(__int_as_float(e.w), v));
            else if (e.z == ROLE_CARRIED_ANTI) viol = __fadd_rn(viol, v);
            else if (e.z == ROLE_ANTI) ipok[j] = ipok[j] && v == 0.0f;
            else ipok[j] = ipok[j] && v > 0.0f;   // ROLE_AFF
          }
          ipok[j] = ipok[j] && viol == 0.0f;
          cnt[j] = c;
          if (ipok[j]) {
            lo = min(lo, (int)c);
            hi = max(hi, (int)c);
          }
        }
      }
      // the flag's counts over the nodes the predicate leaves, and the
      // warp's maxima: spread+interpod, in the (min, max) chunk; interpod,
      // from the prepared counts, for the triple's free word
      if constexpr (NORM && SPREAD) {
        const NormPod nq = norm_pod(norm_of(nm...), s.nm_pods + (p % POD_SLOTS) * NM_ROW);
        nm_x = nq.tt || nq.na;
        if (nm_x) {
          unsigned mt, mn;
          norm_counts<RUN>(norm_of(nm...), nq, g0, ipok, nc, &mt, &mn);
          mt = __reduce_max_sync(FULL, mt);
          mn = __reduce_max_sync(FULL, mn);
          // (into the block's words, up to SI_FAST_ZONES zones)
          if (sp.nz <= SI_FAST_ZONES) {
            if (lane == 0) {
              atomicMax(reinterpret_cast<unsigned*>(si_block<RUN, PACKED, NORM>(smem_base)) + 8, mt);
              atomicMax(reinterpret_cast<unsigned*>(si_block<RUN, PACKED, NORM>(smem_base)) + 9, mn);
            }
          } else if (lane == 0) {
            s.nm_w[warp] = make_int2((int)mt, (int)mn);
          }
        }
      } else if constexpr (NORM) {
        if (nm_x) {
          const NormMain<RUN>& kp = keep_of(nm...);
          unsigned mt = 0u, mn = 0u;
#pragma unroll
          for (int j = 0; j < RUN; ++j) {
            if (ipok[j]) {
              mt = max(mt, kp.cnt[j] & 0xffu);
              mn = max(mn, kp.cnt[j] >> 8);
            }
          }
          mt = __reduce_max_sync(FULL, mt);
          mn = __reduce_max_sync(FULL, mn);
          if (lane == 0) s.nm_w[warp] = make_int2((int)mt, (int)mn);
        }
      }
      // 3. the cluster's min and max, and the scores
      if constexpr (SPREAD) {
        // the spread+interpod build: SelectorSpread's partial over the
        // nodes left by the predicate and the (min, max), each when the pod
        // needs it, in one message on the spread mbarrier (see the header)
        const bool sp_on = q_next >= 0;   // pod p's entry (fetched one pod ahead)
        const bool ip_on = head.z != 0;
#pragma unroll
        for (int j = 0; j < RUN; ++j) ss[j] = MAX_PRIORITY;
        if (sp_on || ip_on || nm_x) {
          // up to SI_FAST_ZONES zones in use (`fast`), the warp's zone sums
          // take one reduction a zone pair, the warps' partials meet in the
          // block's words by shared atomics, and the cluster's take one
          // reduction a zone (see the header); past it, one reduction a
          // zone in the warp and serial sums a lane, as in the spread build
          const bool fast = sp.nz <= SI_FAST_ZONES;
          if (sp_on) {   // the warp's max count, any zoned node, zone sums
            int cmax = 0;
            bool zoned = false;
            unsigned pk0 = 0u, pk1 = 0u;   // zones 0-1 and 2-3, 16 bits a zone
#pragma unroll
            for (int j = 0; j < RUN; ++j) {
              if (!ipok[j]) continue;
              const int c = (int)nxt[j];
              cmax = max(cmax, c);
              zoned = zoned || dom[j] >= 0;
              if (fast && dom[j] >= 0 && dom[j] < sp.nz) {
                const unsigned f = (unsigned)c << (16 * (dom[j] & 1));
                if (dom[j] < 2) pk0 += f;
                else pk1 += f;
              }
            }
            int* wsl = s.sp_w + warp * SP_WORDS;
            int* blk = si_block<RUN, PACKED, NORM>(smem_base);
            // zone d's warp sum, into the warp's slot or the block's words
            auto put = [&](int d, int v) {
              if (fast) atomicAdd(blk + 2 + d, v);
              else wsl[1 + d] = v;
            };
            const int wmax = __reduce_max_sync(FULL, cmax);
            const unsigned wzoned = __ballot_sync(FULL, zoned);
            bool packed = false;
            if (fast) {
              // a field sums one zone's counts over at most 32 RUN nodes,
              // each at most wmax: exact while wmax * 32 RUN < 2^16
              const unsigned w01 = __reduce_add_sync(FULL, pk0);
              const unsigned w23 = __reduce_add_sync(FULL, pk1);
              packed = (unsigned)wmax * (32u * RUN) < SI_FIELD;
              if (packed && lane == 0) {
                put(0, (int)(w01 & (SI_FIELD - 1u)));
                put(1, (int)(w01 >> 16));
                put(2, (int)(w23 & (SI_FIELD - 1u)));
                put(3, (int)(w23 >> 16));
              }
            }
            if (!packed) {
              auto zone_sum = [&](int d) {
                int v = 0;
#pragma unroll
                for (int j = 0; j < RUN; ++j) v += (ipok[j] && dom[j] == d) ? (int)nxt[j] : 0;
                v = __reduce_add_sync(FULL, v);
                if (lane == 0) put(d, v);
              };
              for (unsigned m = zlo; m != 0u; m &= m - 1u) zone_sum(__ffs((int)m) - 1);
              for (unsigned m = zhi; m != 0u; m &= m - 1u) zone_sum(32 + __ffs((int)m) - 1);
            }
            if (lane == 0) {
              if (fast) {
                atomicMax(blk, wmax);
                if (wzoned != 0u) atomicOr(blk + 1, 1);
              } else {
                wsl[0] = wmax | (wzoned != 0u ? SP_ZONED : 0);
              }
            }
          }
          if (ip_on) {
            const int wlo = __reduce_min_sync(FULL, lo);
            const int whi = __reduce_max_sync(FULL, hi);
            if (lane == 0) {
              if (fast) {
                atomicMin(si_block<RUN, PACKED, NORM>(smem_base) + 6, wlo);
                atomicMax(si_block<RUN, PACKED, NORM>(smem_base) + 7, whi);
              } else {
                s.ip_w[warp] = make_int2(wlo, whi);
              }
            }
          }
          __syncthreads();
          if (warp == 0) {   // the block's message, into slot `rank` of every block
            // (the (min, max) chunk also carries the flag's maxima)
            const int chunks = (sp_on ? sp_chunks : 0) + (ip_on || nm_x ? 1 : 0);
            if (lane == 0) mbar_arm(s.bar_sp, CLUSTER * 16u * (unsigned)chunks);
            int4 mm = make_int4(0, 0, 0, 0);
            if (fast) {
              // the block's words, gathered by the warps' atomics before the
              // barrier: into the message, then back to 0 for the next pod
              int* blk = si_block<RUN, PACKED, NORM>(smem_base);
              const int4 b0 = reinterpret_cast<const int4*>(blk)[0];
              const int4 b1 = reinterpret_cast<const int4*>(blk)[1];
              const int4 b2 = reinterpret_cast<const int4*>(blk)[2];
              if (sp_on && lane == 0) {
                int* out = reinterpret_cast<int*>(s.sp_out);
                out[0] = b0.x | (b0.y != 0 ? SP_ZONED : 0);
                out[1] = b0.z;
                out[2] = b0.w;
                out[3] = b1.x;
                out[4] = b1.y;
              }
              mm = make_int4(b1.z, b1.w, b2.x, b2.y);
              __syncwarp();
              if (lane < SI_BLOCK_WORDS) blk[lane] = 0;
            } else if (sp_on) {
              int* out = reinterpret_cast<int*>(s.sp_out);
              const int w0 = lane < WARPS ? s.sp_w[lane * SP_WORDS] : 0;
              const int bmax = __reduce_max_sync(FULL, w0 & (SP_ZONED - 1));
              const unsigned bzoned = __reduce_or_sync(FULL, (unsigned)(w0 & SP_ZONED));
              for (int d = lane; d < sp.nz; d += 32) {
                int z = 0;
#pragma unroll
                for (int w = 0; w < WARPS; ++w) z += s.sp_w[w * SP_WORDS + 1 + d];
                out[1 + d] = z;
              }
              if (lane == 0) out[0] = bmax | (int)bzoned;
            }
            if (ip_on && !fast) {
              const int2 v = lane < WARPS ? s.ip_w[lane] : make_int2(0, 0);
              mm.x = __reduce_min_sync(FULL, v.x);
              mm.y = __reduce_max_sync(FULL, v.y);
            }
            if (nm_x && !fast) {
              const int2 v = lane < WARPS ? s.nm_w[lane] : make_int2(0, 0);
              mm.z = (int)__reduce_max_sync(FULL, (unsigned)v.x);
              mm.w = (int)__reduce_max_sync(FULL, (unsigned)v.y);
            }
            __syncwarp();
            for (int k = lane / CLUSTER; k < chunks; k += 32 / CLUSTER) {
              if (sp_on && k < sp_chunks)
                st_async_v4(to_sp_slot + k * 16, s.sp_out[k], to_sp_bar);
              else
                st_async_v4(to_ip_slot, mm, to_sp_bar);
            }
          }
          mbar_wait(s.bar_sp, sp_phase);
          sp_phase ^= 1u;
          if (sp_on) {   // every warp: the cluster's max count, zoned, zone sums
            const int b0 = lane < CLUSTER ? sp_word(s, lane, 0) : 0;
            const int max_c = __reduce_max_sync(FULL, b0 & (SP_ZONED - 1));
            const unsigned any_z = __reduce_or_sync(FULL, (unsigned)(b0 & SP_ZONED));
            int zlo_sum = 0, zhi_sum = 0;
            int zs[SI_FAST_ZONES] = {};   // (fast) every lane: zone d's sum
            float max_zone;
            if (fast) {   // lane b reads block b: one reduction a zone
#pragma unroll
              for (int d = 0; d < SI_FAST_ZONES; ++d)
                zs[d] = __reduce_add_sync(
                    FULL, lane < CLUSTER && d < sp.nz ? sp_word(s, lane, 1 + d) : 0);
              max_zone = (float)max(max(zs[0], zs[1]), max(zs[2], zs[3]));
            } else {
              if (lane < sp.nz) {
#pragma unroll
                for (int b = 0; b < CLUSTER; ++b) zlo_sum += sp_word(s, b, 1 + lane);
              }
              if (lane + 32 < sp.nz) {
#pragma unroll
                for (int b = 0; b < CLUSTER; ++b) zhi_sum += sp_word(s, b, 33 + lane);
              }
              max_zone = (float)__reduce_max_sync(FULL, max(zlo_sum, zhi_sum));
            }
            const float max_node = (float)max_c;
            const bool have_zones = any_z != 0u;
            const double r_node = __drcp_rn((double)fmaxf(max_node, 1.0f));
            const double r_zone = __drcp_rn((double)fmaxf(max_zone, 1.0f));
            if (fast) {
              // the node part of counts 0-31, lane x holding count x's, and
              // the zone part of zone d in lane d, of no summed zone in lanes
              // 4-31; a node reads its two parts with __shfl_sync (the same
              // arithmetic on the same values, so the same bits)
              const float node_tab = spread_part(max_node, (float)lane, r_node);
              const int zl = lane == 0 ? zs[0] : lane == 1 ? zs[1] : lane == 2 ? zs[2]
                             : lane == 3 ? zs[3] : 0;
              const float zone_tab = spread_part(max_zone, (float)zl, r_zone);
#pragma unroll
              for (int j = 0; j < RUN; ++j) {
                const int d = dom[j];
                const int x = (int)nxt[j];
                float node_s = __shfl_sync(FULL, node_tab, x & 31);
                if (!((unsigned)x < 32u && (float)x == nxt[j]))
                  node_s = spread_part(max_node, nxt[j], r_node);
                const float zone_s =
                    __shfl_sync(FULL, zone_tab, d >= 0 && d < sp.nz ? d : SI_FAST_ZONES);
                ss[j] = spread_score(node_s, d >= 0 ? zone_s : 0.0f, d >= 0, have_zones);
              }
            } else {
#pragma unroll
              for (int j = 0; j < RUN; ++j) {
                const int d = dom[j];
                int zc = __shfl_sync(FULL, zlo_sum, d & 31);
                if (sp.nz > 32) {
                  const int zc_hi = __shfl_sync(FULL, zhi_sum, d & 31);
                  if (d >= 32) zc = zc_hi;
                }
                const bool summed = d >= 0 && d < sp.nz;
                const float zone_s =
                    d >= 0 ? spread_part(max_zone, summed ? (float)zc : 0.0f, r_zone) : 0.0f;
                ss[j] = spread_score(spread_part(max_node, nxt[j], r_node), zone_s, d >= 0,
                                     have_zones);
              }
            }
          }
          if (ip_on) {   // every warp: the cluster's (min, max), the priority
            const int4 b4 = s.ip_slot[lane < CLUSTER ? lane : 0];
            const float min_c = (float)__reduce_min_sync(FULL, lane < CLUSTER ? b4.x : 0);
            const float max_c = (float)__reduce_max_sync(FULL, lane < CLUSTER ? b4.y : 0);
            const float spread_c = __fsub_rn(max_c, min_c);
            if (spread_c > 0.0f) {
#pragma unroll
              for (int j = 0; j < RUN; ++j)
                if (ipok[j])
                  ipsc[j] = truncf(__fadd_rn(
                      __fdiv_rn(__fmul_rn(MAX_PRIORITY, __fsub_rn(cnt[j], min_c)),
                                fmaxf(spread_c, 1.0f)),
                      FLOOR_EPS));
            }
          }
          if (nm_x) {   // every warp: the flag's maxima
            const int4 b4 = s.ip_slot[lane < CLUSTER ? lane : 0];
            norm_maxima(lane < CLUSTER ? (unsigned)b4.z : 0u,
                        lane < CLUSTER ? (unsigned)b4.w : 0u, &m_tt, &m_na);
          }
        }
      } else {
        if (head.z != 0) {
          const int wlo = __reduce_min_sync(FULL, lo);
          const int whi = __reduce_max_sync(FULL, hi);
          if (lane == 0) s.ip_w[warp] = make_int2(wlo, whi);
          __syncthreads();
          if (warp == 0) {   // the block's (min, max), into slot `rank` of every block
            const int2 v = lane < WARPS ? s.ip_w[lane] : make_int2(0, 0);
            const int blo = __reduce_min_sync(FULL, v.x);
            const int bhi = __reduce_max_sync(FULL, v.y);
            if (lane < CLUSTER) st_async_v4(to_ip_slot, make_int4(blo, bhi, 0, 0), to_ip_bar);
          }
          if constexpr (NORM)   // (pod p+1, its row published by step 1's barrier)
            if (p + 1 < P) norm_prepare<RUN>(keep_of(nm...), s, p + 1, lane, t, c0, g0, N);
          mbar_wait(s.bar_ip, ip_phase);
          if (t == 0) mbar_arm(s.bar_ip, CLUSTER * IP_BYTES);   // next counting pod
          ip_phase ^= 1u;
          const int4 b4 = s.ip_slot[lane < CLUSTER ? lane : 0];
          const float min_c = (float)__reduce_min_sync(FULL, lane < CLUSTER ? b4.x : 0);
          const float max_c = (float)__reduce_max_sync(FULL, lane < CLUSTER ? b4.y : 0);
          const float spread_c = __fsub_rn(max_c, min_c);
          if (spread_c > 0.0f) {
#pragma unroll
            for (int j = 0; j < RUN; ++j)
              if (ipok[j])
                ipsc[j] = truncf(__fadd_rn(
                    __fdiv_rn(__fmul_rn(MAX_PRIORITY, __fsub_rn(cnt[j], min_c)),
                              fmaxf(spread_c, 1.0f)),
                    FLOOR_EPS));
          }
        }
      }
    }

    // ---- the flag's terms, added to the run's static scores (every term is
    // an integer, so the sum is exact in any order; -inf stays -inf): the
    // score loops below stay those of the builds without the flag
    if constexpr (NORM && SPREAD && IPA) {   // (the other builds: the guess's terms, above)
      const double r_tt = __drcp_rn((double)fmaxf(m_tt, 1.0f));
      const double r_na = __drcp_rn((double)fmaxf(m_na, 1.0f));
#pragma unroll
      for (int j = 0; j < RUN; ++j)
        ms[j] = __fadd_rn(ms[j], norm_score(norm_of(nm...), nc[j], m_tt, m_na, r_tt, r_na));
    }

    float best = -INFINITY;
    unsigned tied = 0u;     // bit j: run position j ties at `best`
    int feas = 0;
    if constexpr (RUN == 8 && !IPA) {
      // every position's score, -inf where infeasible; their maximum as a
      // tree and the ties at it: three dependent steps where the loop below
      // takes eight (+ 0 turns a -0 score into +0, so equal scores have
      // equal keys)
      float sc[RUN];
      unsigned fm = 0u;     // bit j: run position j is feasible
#pragma unroll
      for (int j = 0; j < RUN; ++j) {
        const bool ok = ms[j] > -INFINITY && lr[j] >= 0.0f;
        float v = __fadd_rn(ms[j], __fmul_rn(w_lr, lr[j]));
        if constexpr (SPREAD)
          v = __fadd_rn(__fadd_rn(v, __fmul_rn(w_ba, ba[j])), __fmul_rn(sp.w_ss, ss[j]));
        else
          v = __fadd_rn(v, __fmul_rn(w_ba, ba[j]));
        sc[j] = ok ? __fadd_rn(v, 0.0f) : -INFINITY;
        fm |= ok ? 1u << j : 0u;
      }
      best = fmaxf(fmaxf(fmaxf(sc[0], sc[1]), fmaxf(sc[2], sc[3])),
                   fmaxf(fmaxf(sc[4], sc[5]), fmaxf(sc[6], sc[7])));
#pragma unroll
      for (int j = 0; j < RUN; ++j) tied |= sc[j] == best ? 1u << j : 0u;
      tied &= fm;
      feas = __popc(fm);
    } else {
#pragma unroll
      for (int j = 0; j < RUN; ++j) {
        if (!(ms[j] > -INFINITY) || lr[j] < 0.0f) continue;
        if constexpr (IPA)
          if (!ipok[j]) continue;
        // + 0 turns a -0 score into +0, so equal scores have equal keys
        float sc;
        if constexpr (SPREAD && IPA)
          sc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(ms[j], __fmul_rn(w_lr, lr[j])),
                                                       __fmul_rn(w_ba, ba[j])),
                                             __fmul_rn(ip.w_ip, ipsc[j])),
                                   __fmul_rn(sp.w_ss, ss[j])), 0.0f);
        else if constexpr (SPREAD)
          sc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(ms[j], __fmul_rn(w_lr, lr[j])),
                                             __fmul_rn(w_ba, ba[j])),
                                   __fmul_rn(sp.w_ss, ss[j])), 0.0f);
        else if constexpr (IPA)
          sc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(ms[j], __fmul_rn(w_lr, lr[j])),
                                             __fmul_rn(w_ba, ba[j])),
                                   __fmul_rn(ip.w_ip, ipsc[j])), 0.0f);
        else
          sc = __fadd_rn(__fadd_rn(__fadd_rn(ms[j], __fmul_rn(w_lr, lr[j])),
                                   __fmul_rn(w_ba, ba[j])), 0.0f);
        ++feas;
        if (sc > best) {
          best = sc;
          tied = 1u << j;
        } else if (sc == best) {
          tied |= 1u << j;
        }
      }
    }

    // ---- (best, ties, feasible) of the warp, the block, the cluster
    const int par = p & 1;
    int key = order_key(best);
    int nt = __popc(tied);
    const Triple wt = warp_reduce(Triple{key, nt, feas});
    if (lane == 0) s.wslot[par * WARPS + warp] = wt;
    __syncthreads();
    if (warp == 0) {   // the block's triple, into slot `rank` of every block
      const Triple v = warp_reduce(lane < WARPS ? s.wslot[par * WARPS + lane] : empty());
      if constexpr (NM_GUESS<SPREAD, IPA, NORM>) {
        // (+ the block's true maxima of the flag, packed)
        const int2 m = lane < WARPS && nm_x ? s.nm_w[lane] : make_int2(0, 0);
        const unsigned packed = __reduce_max_sync(FULL, (unsigned)m.x)
                                | __reduce_max_sync(FULL, (unsigned)m.y) << 8;
        if (lane < CLUSTER)
          st_async_v4(par ? to_slot1 : to_slot0, make_int4(v.key, v.ties, v.feas, (int)packed),
                      par ? to_bar1 : to_bar0);
      } else {
        if (lane < CLUSTER)
          st_async_v4(par ? to_slot1 : to_slot0, make_int4(v.key, v.ties, v.feas, 0),
                      par ? to_bar1 : to_bar0);
      }
    }
    // start pod p+3's copies while the triples travel: its row slot held
    // row p-1 and its pod slot pod p-5, both read before this barrier
    issue_row(p + STAGES - 1);
    if constexpr (SPREAD && NM_GUESS<SPREAD, IPA, NORM>) {
      // (the spread build with the flag: a pod with an entry prepared pod
      // p+1 but its flag terms while its partials travelled, the others
      // prepare it here)
      const bool early = q_next >= 0;
      fetch_counts(p + 1);
      if (p + 1 < P) {
        if (early) norm_late_terms<RUN>(keep_of(nm...), s, c0);
        else norm_prepare<RUN>(keep_of(nm...), s, p + 1, lane, t, c0, g0, N);
      }
    } else if constexpr (IPA && NM_GUESS<SPREAD, IPA, NORM>) {
      // (the interpod build with the flag: so did a pod that counts, while
      // its (min, max) travelled)
      if (head.z == 0 && p + 1 < P)
        norm_prepare<RUN>(keep_of(nm...), s, p + 1, lane, t, c0, g0, N);
    } else {
      // and load pod p+1's counts, whose slot this barrier published
      if constexpr (SPREAD) fetch_counts(p + 1);
      // (with the flag's guess: and prepare pod p+1, its row published by the
      // same barrier)
      if constexpr (NM_GUESS<SPREAD, IPA, NORM>)
        if (p + 1 < P) norm_prepare<RUN>(keep_of(nm...), s, p + 1, lane, t, c0, g0, N);
    }
    mbar_wait(&s.bar[par], (p >> 1) & 1);
    if (t == 0) mbar_arm(&s.bar[par], CLUSTER * TRIPLE_BYTES);   // for pod p+2

    // ---- the flag's check: every warp takes the cluster's maxima from the
    // triples' free words, records them in its table, and on a wrong guess
    // scores the pod again and exchanges it again
    if constexpr (NM_GUESS<SPREAD, IPA, NORM>) {
      if (nm_x) {
        NormMain<RUN>& kp = keep_of(nm...);
        const int4 c4 = s.cslot[par * CLUSTER + (lane < CLUSTER ? lane : 0)];
        const unsigned w4 = lane < CLUSTER ? (unsigned)c4.w : 0u;
        const unsigned word =
            __reduce_max_sync(FULL, w4 & 0xffu) | __reduce_max_sync(FULL, w4 >> 8) << 8;
        int2* e = nm_table(s) + t;
        int slot = kp.at;
        if (slot >= 0) {
          if (lane == slot) e->y = (int)(word | NM_VALID);
        } else {
          slot = (int)kp.next;
          if (lane == slot) *e = make_int2((int)kp.key, (int)(word | NM_VALID));
          kp.next = (kp.next + 1u) % NM_TABLE;
        }
        // the next pod looked the table up before this update: where its
        // key is this key, its entry is this one and its guess this word;
        // where this pod's new entry took its entry, it has none and
        // guesses 0 (as a lookup after the update finds); its flag terms
        // again where its guess moved
        if (p + 1 < P && kp.x_n) {
          unsigned g = kp.guess_n;
          if (kp.key_n == kp.key) {
            kp.at_n = slot;
            g = word;
          } else if (kp.at < 0 && kp.at_n == slot) {
            kp.at_n = -1;
            g = 0u;
          }
          if (__builtin_expect(g != kp.guess_n, 0)) {
            kp.guess_n = g;
            norm_flag_terms<RUN>(kp, s, c0, g);
          }
        }
        if (__builtin_expect(word != kp.guess, 0)) {
          // this pod's counts again, into registers of their own (the next
          // pod's hold kp.cnt), its terms of the true maxima, and the static
          // row again (its ring slot is refilled only after pod p+1's
          // barrier)
          const int* row = s.nm_pods + (p % POD_SLOTS) * NM_ROW;
          const int x = lane < NM_ROW ? row[lane] : 0;
          unsigned cp[RUN];
          norm_count_row<RUN>(kp, row, x, lane, kp.tt, kp.na, g0, N, cp);
          float fl[RUN];
          norm_terms<RUN>(kp, word, cp, fl);
          load_scores<RUN>(s.ring + (p % STAGES) * NB + c0, lane, ms);
#pragma unroll
          for (int j = 0; j < RUN; ++j) ms[j] = __fadd_rn(ms[j], fl[j]);
          // (and the terms from the term cache, which holds this pod's)
          if constexpr (PACKED) {
#pragma unroll
            for (int j = 0; j < RUN; ++j) {
              lr[j] = byte_term(lr1[j / 4], j % 4, LR_BIAS);
              ba[j] = byte_term(bab[j / 4], j % 4, BA_BIAS);
            }
          } else {
            load_run<RUN>(s.t_lr + c0, lr);
            load_run<RUN>(s.t_ba + c0, ba);
          }
          // (SelectorSpread and the predicate and priority of the
          // inter-pod terms, kept from the first round)
          if constexpr (SPREAD)
            best_of_run_x<RUN, false>(ms, lr, ba, ss, ipok, w_lr, w_ba, sp.w_ss, &best,
                                      &tied, &feas);
          else if constexpr (IPA)
            best_of_run_x<RUN, true>(ms, lr, ba, ipsc, ipok, w_lr, w_ba, ip.w_ip, &best,
                                     &tied, &feas);
          else
            best_of_run<RUN>(ms, lr, ba, w_lr, w_ba, &best, &tied, &feas);
          key = order_key(best);
          nt = __popc(tied);
          const Triple wr = warp_reduce(Triple{key, nt, feas});
          if (lane == 0) s.wslot[par * WARPS + warp] = wr;
          __syncthreads();
          if (warp == 0) {   // the block's second triple, on the flag's mbarrier
            const Triple v = warp_reduce(lane < WARPS ? s.wslot[par * WARPS + lane] : empty());
            if (lane < CLUSTER)
              st_async_v4(map_rank(smem_u32(&s.nm_slot[rank]), lane),
                          make_int4(v.key, v.ties, v.feas, 0),
                          map_rank(smem_u32(s.bar_nm), lane));
          }
          // (the parity of the flag's mbarrier: sp_phase in the builds
          // without the spread exchange, ip_phase in the spread build)
          if constexpr (SPREAD) {
            mbar_wait(s.bar_nm, ip_phase);
            if (t == 0) mbar_arm(s.bar_nm, CLUSTER * TRIPLE_BYTES);   // the next redo
            ip_phase ^= 1u;
          } else {
            mbar_wait(s.bar_nm, sp_phase);
            if (t == 0) mbar_arm(s.bar_nm, CLUSTER * TRIPLE_BYTES);   // the next redo
            sp_phase ^= 1u;
          }
          // the selection below reads the second round where it reads the
          // first
          if (t < CLUSTER) s.cslot[par * CLUSTER + t] = s.nm_slot[t];
          __syncthreads();
        }
      }
    }

    // ---- every warp: the global best, ntie, this block's tie offset
    const int4 b4 = s.cslot[par * CLUSTER + (lane < CLUSTER ? lane : 0)];
    const Triple bt = lane < CLUSTER ? Triple{b4.x, b4.y, b4.z} : empty();
    const Triple tot = warp_reduce(bt);
    const int ntie = tot.ties;
    if (ntie > 0) {
      const int k = (int)(rr % (unsigned int)ntie);
      const int bties = bt.key == tot.key ? bt.ties : 0;
      const int boff = __reduce_add_sync(FULL, lane < rank ? bties : 0);
      const int bmine = __shfl_sync(FULL, bties, rank);
      if (boff <= k && k < boff + bmine) {      // this block holds the tie
        const Triple w_ = lane < WARPS ? s.wslot[par * WARPS + lane] : empty();
        const int wties = w_.key == tot.key ? w_.ties : 0;
        const int woff = boff + __reduce_add_sync(FULL, lane < warp ? wties : 0);
        const int wmine = __shfl_sync(FULL, wties, warp);
        if (woff <= k && k < woff + wmine) {    // and this warp
          const int tties = key == tot.key ? nt : 0;
          const int excl = woff + exclusive_sum_small<RUN>(tties, lane);
          [[maybe_unused]] int won = -1;        // the chosen node (spread, interpod)
          if (tties > 0 && excl <= k && k < excl + tties) {
            unsigned m = tied;
            for (int r = k - excl; r > 0; --r) m &= m - 1u;
            const int j = __ffs((int)m) - 1;    // the tie's run position
            const int c = c0 + j;
            const int g = g0 + j;
            [[maybe_unused]] ExtPod xv;   // the pod's volume words (EXT)
            if constexpr (EXT) xv = ext_pod(pr);
            if constexpr (GANG && EXT) {
              if (gang_cur > 0)   // the node's old row, into the undo log
                ext_log<RUN>(ext_of(nm...), undo_b + (size_t)undo_n * EXT_UNDO_WORDS, s, c, j,
                             g, rq, xv, allocatable, requested);
            } else if constexpr (GANG) {
              if (gang_cur > 0) {   // the node's old row, into the undo log
                int changed = 0;
                float4 e2 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                if (rq[GPU] != 0.0f) { changed |= 1; e2.x = requested[(size_t)g * R + GPU]; }
                if (rq[SCRATCH] != 0.0f) { changed |= 2; e2.y = requested[(size_t)g * R + SCRATCH]; }
                if (rq[OVERLAY] != 0.0f) { changed |= 4; e2.z = requested[(size_t)g * R + OVERLAY]; }
                float4* e = undo_b + (size_t)undo_n * UNDO_WORDS;
                e[0] = make_float4(__int_as_float(c), s.r_pods[c], s.r_cpu[c], s.r_mem[c]);
                if constexpr (SPREAD || IPA)   // (+ the pod, whose rows a revert subtracts)
                  e[1] = make_float4(s.z_cpu[c], s.z_mem[c], __int_as_float(changed),
                                     __int_as_float(p));
                else
                  e[1] = make_float4(s.z_cpu[c], s.z_mem[c], __int_as_float(changed), 0.0f);
                if (changed != 0) e[2] = e2;
              }
            }
            s.r_pods[c] = __fadd_rn(s.r_pods[c], rq[PODS]);
            s.r_cpu[c] = __fadd_rn(s.r_cpu[c], rq[CPU]);
            s.r_mem[c] = __fadd_rn(s.r_mem[c], rq[MEM]);
            if constexpr (EXT) {   // (+ the pod's ports and volumes, into the node's words)
              ext_place<RUN>(ext_of(nm...), j, g, rq, xv, requested);
            } else {
#pragma unroll
              for (int f = GPU; f < R; ++f)   // x + 0 == x: no load for a zero request
                if (rq[f] != 0.0f)
                  requested[(size_t)g * R + f] =
                      __fadd_rn(requested[(size_t)g * R + f], rq[f]);
            }
            s.z_cpu[c] = __fadd_rn(s.z_cpu[c], pod.nz_cpu);
            s.z_mem[c] = __fadd_rn(s.z_mem[c], pod.nz_mem);
            if constexpr (PACKED) {   // into byte j of the packed terms
              float l, b;
              if constexpr (EXT)
                ext_terms<RUN>(s, pod, xv, c, g, j, ext_of(nm...), allocatable, requested, &l,
                               &b);
              else
                node_terms(s, pod, c, &l, &b);
              const unsigned kl = term_byte(l, LR_BIAS), kb = term_byte(b, BA_BIAS);
              if (j < 4) {
                lr1[0] = put_byte(lr1[0], kl, j);
                bab[0] = put_byte(bab[0], kb, j);
              } else {
                lr1[1] = put_byte(lr1[1], kl, j - 4);
                bab[1] = put_byte(bab[1], kb, j - 4);
              }
            } else if constexpr (EXT) {
              ext_terms<RUN>(s, pod, xv, c, g, j, ext_of(nm...), allocatable, requested,
                             &s.t_lr[c], &s.t_ba[c]);
            } else {
              node_terms(s, pod, c, &s.t_lr[c], &s.t_ba[c]);
            }
            if constexpr (SPREAD) {
              // pod p+1's counts were loaded before this placement: add
              // its entry of the match row to the chosen node's copy
              if (q_next >= 0) {
                const float v = pr[Build<RUN, SPREAD, IPA, GANG>::SPM + q_next];
#pragma unroll
                for (int i = 0; i < RUN; ++i)
                  if (i == j && v != 0.0f) nxt[i] = __fadd_rn(nxt[i], v);
              }
              won = g;
            }
            if constexpr (IPA) won = g;
            assignments[p] = g;
            scores[p] = best;
          }
          if constexpr (SPREAD && !IPA) {
            // the owner's warp: the pod's match row into the node's counts,
            // a column a lane, after every lane's loads of pod p+1's counts;
            // a reduction whose result is not used waits for no load
            const int gw = __reduce_max_sync(FULL, won);
            __syncwarp();
            for (int u = lane; u < sp.uq; u += 32) {
              const float v = pr[SP_M + u];
              if (v != 0.0f) atomicAdd(sp.podsel_t + (size_t)u * N + gw, v);
            }
          }
          if constexpr (IPA) {
            // the owner's warp: first the node to every block, whose
            // replica waits for it, then the pod's match and carried-term
            // rows into the node's counts, a column a lane, as reductions
            // whose result is not used
            if (head.w != 0) {
              const int gw = __reduce_max_sync(FULL, won);
              // (spread+interpod: after every lane's loads of pod p+1's
              // counts, as in the spread build; these adds cover its match
              // row)
              if constexpr (SPREAD) __syncwarp();
              if constexpr (SPREAD) {   // (with the node's ids)
                if (lane < CLUSTER)
                  st_async_v4(map_rank(smem_u32(s.win_slot), lane),
                              si_message<RUN>(ip, si_ids<RUN, PACKED, NORM>(smem_base),
                                              gw, p, rank),
                              map_rank(smem_u32(s.bar_win), lane));
              } else {
                if (lane < CLUSTER)
                  st_async_v4(map_rank(smem_u32(s.win_slot), lane), make_int4(gw, p, 0, 0),
                              map_rank(smem_u32(s.bar_win), lane));
              }
              const float* row = pr + POD_ROW_MAIN + IPW_ROWS;
              for (int u = lane; u < ip.uq + ip.ue; u += 32) {
                const float v = row[u];
                if (v != 0.0f) atomicAdd(ip.node_t + (size_t)u * N + gw, v);
              }
            }
          }
        }
        if constexpr (GANG) undo_n += gang_cur > 0;   // the owner's entry, if any
      }
      rr += 1u;
      if constexpr (GANG) gang_placed += gang_cur > 0;
    } else if (rank == 0 && t == 0) {
      assignments[p] = -1;
      scores[p] = 0.0f;
    }
    if (rank == 0 && t == 0) feasible_counts[p] = tot.feas;
    if constexpr (IPA) win_pending = ntie > 0 && head.w != 0;
  }
  if constexpr (IPA)
    if (win_pending) mbar_wait(s.bar_win, win_phase);   // the last pod's node
  if constexpr (GANG)   // the group still open after the last pod
    if (gang_cur > 0 && gang_placed < gang_min_cur) {
      revert();
      if constexpr (SPREAD || IPA)   // (the node-level counts; no totals or replica)
        gang_revert_counts<RUN, SPREAD, IPA>(s, sp, ip, gg, undo_b, undo_n, assignments,
                                             dom_b, gang_cur, P, false, rank, N, t);
    }

  // ---- write the run's ledger back
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    const int c = c0 + j;
    const int g = g0 + j;
    if (g >= N) continue;
    requested[(size_t)g * R + PODS] = s.r_pods[c];
    requested[(size_t)g * R + CPU] = s.r_cpu[c];
    requested[(size_t)g * R + MEM] = s.r_mem[c];
    nonzero[(size_t)g * 2] = s.z_cpu[c];
    nonzero[(size_t)g * 2 + 1] = s.z_mem[c];
  }
  if (rank == 0 && t == 0) *rr_io = (long long)rr;
  cluster.sync();   // no block leaves while another may still store into it
}

// The main operands of one launch.
struct Operands {
  const float* masked_static;
  const float* requests;
  const float* nonzero_requests;
  const float* allocatable;
  float* requested;
  float* nonzero;
  int* assignments;
  float* scores;
  int* feasible_counts;
  long long* rr_io;
  int P;
  int N;
  float w_lr;
  float w_ba;
  NormArgs nm;    // the normalization flag (pod_w null: off)
};

// One launch; `nm` is the flag's NormArgs, or nothing without the flag,
// then with EXT the variant's ExtArgs.
template <int RUN, bool SPREAD, bool IPA, bool GANG, bool EXT = false, typename... Norm>
int launch(const Operands& o, SpreadParam<SPREAD> sp, IpaParam<IPA> ip,
           GangParam<GANG> gg, cudaStream_t stream, Norm... nm) {
  constexpr bool NORM = sizeof...(Norm) == (EXT ? 2 : 1);
  auto kernel = assign_scan_kernel<RUN, SPREAD, IPA, GANG, NORM, EXT, Norm...>;
  using B = Build<RUN, SPREAD, IPA, GANG, EXT>;
  size_t smem =
      smem_bytes<SPREAD, IPA, B::PACKED, NORM>(THREADS * RUN, B::STAGES, B::POD_ROW);
  if constexpr (SPREAD && IPA) {   // + the block's ids, and its replica where it fits
    const int u = ip.uq + ip.ue;
    const bool rep = si_rep_shared<RUN>(smem, ip.k, ip.nd, u);
    smem += SI_HEAD_BYTES + si_ids_bytes<RUN>() + (rep ? si_rep_bytes(ip.k, ip.nd, u) : 0);
  }
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;

  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(CLUSTER, 1, 1);
  config.blockDim = dim3(THREADS, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;

  // a cluster the card cannot place is an error, never a smaller launch
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&config, kernel, o.masked_static, o.requests,
                           o.nonzero_requests, o.allocatable, o.requested,
                           o.nonzero, o.assignments, o.scores,
                           o.feasible_counts, o.rr_io, o.P, o.N, o.w_lr,
                           o.w_ba, sp, ip, gg, nm...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The instance with the normalization flag when its pod words are given
// (NormMain where the build guesses the flag's maxima).
template <int RUN, bool SPREAD, bool IPA, bool GANG>
int launch_norm(const Operands& o, SpreadParam<SPREAD> sp, IpaParam<IPA> ip,
                GangParam<GANG> gg, cudaStream_t stream) {
  if (o.nm.pod_w == nullptr) return launch<RUN, SPREAD, IPA, GANG>(o, sp, ip, gg, stream);
  if constexpr (NM_GUESS<SPREAD, IPA, true>) {
    NormMain<RUN> nm = {};
    static_cast<NormArgs&>(nm) = o.nm;
    return launch<RUN, SPREAD, IPA, GANG>(o, sp, ip, gg, stream, nm);
  } else {
    return launch<RUN, SPREAD, IPA, GANG>(o, sp, ip, gg, stream, o.nm);
  }
}

// The build for `run` nodes per thread (1, 2, 4 or 8), with
// N <= CLUSTER * 512 * run.
template <bool SPREAD, bool IPA = false, bool GANG = false>
int launch_run(const Operands& o, int run, SpreadParam<SPREAD> sp,
               cudaStream_t stream, IpaParam<IPA> ip = {}, GangParam<GANG> gg = {}) {
  if (o.P <= 0) return (int)cudaSuccess;
  if (o.N <= 0 || o.N > CLUSTER * THREADS * run) return (int)cudaErrorInvalidValue;
  switch (run) {
    case 1: return launch_norm<1, SPREAD, IPA, GANG>(o, sp, ip, gg, stream);
    case 2: return launch_norm<2, SPREAD, IPA, GANG>(o, sp, ip, gg, stream);
    case 4: return launch_norm<4, SPREAD, IPA, GANG>(o, sp, ip, gg, stream);
    case 8: return launch_norm<8, SPREAD, IPA, GANG>(o, sp, ip, gg, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The EXT variant of the main (GANG false) or gang build, with the flag
// when its pod words are given.
template <int RUN, bool GANG>
int launch_ext(const Operands& o, GangParam<GANG> gg, cudaStream_t stream, ExtArgs ex) {
  ExtMain<RUN> xm = {};
  static_cast<ExtArgs&>(xm) = ex;
  if (o.nm.pod_w == nullptr)
    return launch<RUN, false, false, GANG, true>(o, NoSpread{}, NoIpa{}, gg, stream, xm);
  NormMain<RUN> nm = {};
  static_cast<NormArgs&>(nm) = o.nm;
  return launch<RUN, false, false, GANG, true>(o, NoSpread{}, NoIpa{}, gg, stream, nm, xm);
}

template <bool GANG>
int launch_run_ext(const Operands& o, int run, cudaStream_t stream, GangParam<GANG> gg,
                   ExtArgs ex) {
  if (o.P <= 0) return (int)cudaSuccess;
  if (o.N <= 0 || o.N > CLUSTER * THREADS * run) return (int)cudaErrorInvalidValue;
  switch (run) {
    case 1: return launch_ext<1, GANG>(o, gg, stream, ex);
    case 2: return launch_ext<2, GANG>(o, gg, stream, ex);
    case 4: return launch_ext<4, GANG>(o, gg, stream, ex);
    case 8: return launch_ext<8, GANG>(o, gg, stream, ex);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The build compiles this file in parts (native/build.py PARTS, one nvcc a
// part, started together and linked into one library): part KTPU_PART holds
// the entries below marked with it, and so the kernel instances they
// launch; without KTPU_PART, every entry.
#ifdef KTPU_PART
#define KTPU_IN_PART(k) (KTPU_PART == (k))
#else
#define KTPU_IN_PART(k) 1
#endif

#if KTPU_IN_PART(0)
// masked_static [P, N], requests [P, 6], nonzero_requests [P, 2],
// allocatable [N, 6]; requested [N, 6] and nonzero [N, 2] hold the
// batch-start ledger and are updated in place. run = nodes per thread
// (1, 2, 4 or 8), with N <= CLUSTER * 512 * run. Every build ends with the
// normalization flag's operands: node_w [N] u64 pairs (a node's
// PreferNoSchedule taint word, its satisfied-requirement word; 16-byte
// aligned), pod_w [P, 16] ints (the untolerated word, 4 term words, 4
// weights as f32 bits, integers up to 65,535, 2 of padding; 16-byte
// aligned rows) or null (the flag off), and the TaintToleration and
// NodeAffinity weights w_tt and w_na.
extern "C" int ktpu_assign_scan(
    const float* masked_static, const float* requests,
    const float* nonzero_requests, const float* allocatable, float* requested,
    float* nonzero, int* assignments, float* scores, int* feasible_counts,
    long long* rr_io, int P, int N, int run, float w_lr, float w_ba,
    const void* node_w, const int* pod_w, float w_tt, float w_na,
    cudaStream_t stream) {
  const Operands o{masked_static, requests, nonzero_requests, allocatable,
                   requested, nonzero, assignments, scores, feasible_counts,
                   rr_io, P, N, w_lr, w_ba,
                   NormArgs{static_cast<const ulonglong2*>(node_w), pod_w, w_tt, w_na}};
  return launch_run<false>(o, run, NoSpread{}, stream);
}
#endif

#if KTPU_IN_PART(0)
// The spread build: the operands of ktpu_assign_scan, and podsel_t
// [uq, N] (the pod-selector counts, transposed; updated in place),
// spread_q [P] (-1 or an entry below uq), pod_matches [P, uq], zone [N]
// (the GetZoneKey domain id: -1 = none, below nz a zone in use, at least
// nd outside the universe; an id in [nz, nd) traps), 0 <= nz <= nd <= 64,
// 0 <= uq <= 64, and the SelectorSpread weight w_ss.
extern "C" int ktpu_assign_scan_spread(
    const float* masked_static, const float* requests,
    const float* nonzero_requests, const float* allocatable, float* requested,
    float* nonzero, int* assignments, float* scores, int* feasible_counts,
    long long* rr_io, int P, int N, int run, float w_lr, float w_ba,
    float* podsel_t, const int* spread_q, const float* pod_matches,
    const int* zone, int uq, int nz, int nd, float w_ss, const void* node_w,
    const int* pod_w, float w_tt, float w_na, cudaStream_t stream) {
  if (uq < 0 || uq > MAX_UQ || nz < 0 || nz > nd || nd > MAX_DOMAINS)
    return (int)cudaErrorInvalidValue;
  const Operands o{masked_static, requests, nonzero_requests, allocatable,
                   requested, nonzero, assignments, scores, feasible_counts,
                   rr_io, P, N, w_lr, w_ba,
                   NormArgs{static_cast<const ulonglong2*>(node_w), pod_w, w_tt, w_na}};
  const SpreadArgs sp{podsel_t, spread_q, pod_matches, zone, uq, nz, nd, w_ss};
  return launch_run<true>(o, run, sp, stream);
}
#endif

#if KTPU_IN_PART(1)
// The interpod build: the operands of ktpu_assign_scan, and node_t
// [uq + ue, N] (the pod-selector then carried-term counts, transposed;
// updated in place), dom0 [k, nd, uq + ue] (the domain aggregates), dom
// [16, k, nd, uq + ue] (scratch: each block copies dom0 into its replica
// and updates it), totals [uq + ue] (their sums over the nodes), pod_ip
// [P, 29 + uq + ue] (per pod: ipaff_fail, paff_q, paff_tkey, panti_q,
// panti_tkey, ppref_q, ppref_tkey, ppref_w as f32 bits, 4 slots each,
// then the match and carried-term rows as f32 bits),
// topology [N, k], term_attr [5, ue] (term_q, term_tkey, term_kind,
// term_weight as f32 bits, term_poison), 0 <= uq, ue <= 64, 5 <= k <= 16,
// 1 <= nd <= 64, and use_ipa (MatchInterPodAffinity), the
// InterPodAffinityPriority weight w_ip and hardPodAffinityWeight hard_w.
extern "C" int ktpu_assign_scan_interpod(
    const float* masked_static, const float* requests,
    const float* nonzero_requests, const float* allocatable, float* requested,
    float* nonzero, int* assignments, float* scores, int* feasible_counts,
    long long* rr_io, int P, int N, int run, float w_lr, float w_ba,
    float* node_t, const float* dom0, float* dom, const float* totals,
    const int* pod_ip, const int* topology, const int* term_attr, int uq,
    int ue, int k, int nd, int use_ipa, float w_ip, float hard_w,
    const void* node_w, const int* pod_w, float w_tt, float w_na,
    cudaStream_t stream) {
  if (uq < 0 || uq > IP_MAX_UQ || ue < 0 || ue > IP_MAX_UE || k < 5
      || k > IP_MAX_K || nd < 1 || nd > IP_MAX_D)
    return (int)cudaErrorInvalidValue;
  const Operands o{masked_static, requests, nonzero_requests, allocatable,
                   requested, nonzero, assignments, scores, feasible_counts,
                   rr_io, P, N, w_lr, w_ba,
                   NormArgs{static_cast<const ulonglong2*>(node_w), pod_w, w_tt, w_na}};
  const IpaArgs ip{node_t, dom0, dom, totals, pod_ip, topology, term_attr, uq, ue,
                   k, nd, use_ipa, w_ip, hard_w};
  return launch_run<false, true>(o, run, NoSpread{}, stream, ip);
}
#endif

#if KTPU_IN_PART(2)
// The spread+interpod build: the operands of ktpu_assign_scan_interpod,
// then spread_q [P] (-1 or an entry below uq), zone [N] (the GetZoneKey
// domain id: -1 = none, below nz a zone in use, at least nd outside the
// universe; an id in [nz, nd) traps), 0 <= nz <= nd, and the SelectorSpread
// weight w_ss. The SelectorSpread counts are node_t's first uq rows, and
// each pod's match row is the one in pod_ip.
extern "C" int ktpu_assign_scan_spread_interpod(
    const float* masked_static, const float* requests,
    const float* nonzero_requests, const float* allocatable, float* requested,
    float* nonzero, int* assignments, float* scores, int* feasible_counts,
    long long* rr_io, int P, int N, int run, float w_lr, float w_ba,
    float* node_t, const float* dom0, float* dom, const float* totals,
    const int* pod_ip, const int* topology, const int* term_attr, int uq,
    int ue, int k, int nd, int use_ipa, float w_ip, float hard_w,
    const int* spread_q, const int* zone, int nz, float w_ss,
    const void* node_w, const int* pod_w, float w_tt, float w_na,
    cudaStream_t stream) {
  if (uq < 0 || uq > IP_MAX_UQ || ue < 0 || ue > IP_MAX_UE || k < 5
      || k > IP_MAX_K || nd < 1 || nd > IP_MAX_D || nd > MAX_DOMAINS || nz < 0
      || nz > nd)
    return (int)cudaErrorInvalidValue;
  const Operands o{masked_static, requests, nonzero_requests, allocatable,
                   requested, nonzero, assignments, scores, feasible_counts,
                   rr_io, P, N, w_lr, w_ba,
                   NormArgs{static_cast<const ulonglong2*>(node_w), pod_w, w_tt, w_na}};
  const SpreadArgs sp{node_t, spread_q, nullptr, zone, uq, nz, nd, w_ss};
  const IpaArgs ip{node_t, dom0, dom, totals, pod_ip, topology, term_attr, uq, ue,
                   k, nd, use_ipa, w_ip, hard_w};
  return launch_run<true, true>(o, run, sp, stream, ip);
}
#endif

#if KTPU_IN_PART(0)
// The gang build: the operands of ktpu_assign_scan, and gang_id [P] (the
// batch-local group id, 0 = none; a group's members are consecutive
// rows), gang_min [P] (the group's quorum) and undo [16, P, 3] float4s
// (scratch: each block's undo log of the open group).
extern "C" int ktpu_assign_scan_gang(
    const float* masked_static, const float* requests,
    const float* nonzero_requests, const float* allocatable, float* requested,
    float* nonzero, int* assignments, float* scores, int* feasible_counts,
    long long* rr_io, int P, int N, int run, float w_lr, float w_ba,
    const int* gang_id, const int* gang_min, float* undo, const void* node_w,
    const int* pod_w, float w_tt, float w_na, cudaStream_t stream) {
  const Operands o{masked_static, requests, nonzero_requests, allocatable,
                   requested, nonzero, assignments, scores, feasible_counts,
                   rr_io, P, N, w_lr, w_ba,
                   NormArgs{static_cast<const ulonglong2*>(node_w), pod_w, w_tt, w_na}};
  const GangArgs gg{gang_id, gang_min, reinterpret_cast<float4*>(undo)};
  return launch_run<false, false, true>(o, run, NoSpread{}, stream, NoIpa{}, gg);
}
#endif

#if KTPU_IN_PART(0)
// The gang carry with SelectorSpread: the operands of
// ktpu_assign_scan_spread, then those of ktpu_assign_scan_gang's gang_id,
// gang_min and undo.
extern "C" int ktpu_assign_scan_spread_gang(
    const float* masked_static, const float* requests,
    const float* nonzero_requests, const float* allocatable, float* requested,
    float* nonzero, int* assignments, float* scores, int* feasible_counts,
    long long* rr_io, int P, int N, int run, float w_lr, float w_ba,
    float* podsel_t, const int* spread_q, const float* pod_matches,
    const int* zone, int uq, int nz, int nd, float w_ss, const int* gang_id,
    const int* gang_min, float* undo, const void* node_w, const int* pod_w,
    float w_tt, float w_na, cudaStream_t stream) {
  if (uq < 0 || uq > MAX_UQ || nz < 0 || nz > nd || nd > MAX_DOMAINS)
    return (int)cudaErrorInvalidValue;
  const Operands o{masked_static, requests, nonzero_requests, allocatable,
                   requested, nonzero, assignments, scores, feasible_counts,
                   rr_io, P, N, w_lr, w_ba,
                   NormArgs{static_cast<const ulonglong2*>(node_w), pod_w, w_tt, w_na}};
  const SpreadArgs sp{podsel_t, spread_q, pod_matches, zone, uq, nz, nd, w_ss};
  const GangArgs gg{gang_id, gang_min, reinterpret_cast<float4*>(undo)};
  return launch_run<true, false, true>(o, run, sp, stream, NoIpa{}, gg);
}
#endif

#if KTPU_IN_PART(1)
// The gang carry with inter-pod (anti-)affinity: the operands of
// ktpu_assign_scan_interpod, then gang_id, gang_min and undo.
extern "C" int ktpu_assign_scan_interpod_gang(
    const float* masked_static, const float* requests,
    const float* nonzero_requests, const float* allocatable, float* requested,
    float* nonzero, int* assignments, float* scores, int* feasible_counts,
    long long* rr_io, int P, int N, int run, float w_lr, float w_ba,
    float* node_t, const float* dom0, float* dom, const float* totals,
    const int* pod_ip, const int* topology, const int* term_attr, int uq,
    int ue, int k, int nd, int use_ipa, float w_ip, float hard_w,
    const int* gang_id, const int* gang_min, float* undo,
    const void* node_w, const int* pod_w, float w_tt, float w_na,
    cudaStream_t stream) {
  if (uq < 0 || uq > IP_MAX_UQ || ue < 0 || ue > IP_MAX_UE || k < 5
      || k > IP_MAX_K || nd < 1 || nd > IP_MAX_D)
    return (int)cudaErrorInvalidValue;
  const Operands o{masked_static, requests, nonzero_requests, allocatable,
                   requested, nonzero, assignments, scores, feasible_counts,
                   rr_io, P, N, w_lr, w_ba,
                   NormArgs{static_cast<const ulonglong2*>(node_w), pod_w, w_tt, w_na}};
  const IpaArgs ip{node_t, dom0, dom, totals, pod_ip, topology, term_attr, uq, ue,
                   k, nd, use_ipa, w_ip, hard_w};
  const GangArgs gg{gang_id, gang_min, reinterpret_cast<float4*>(undo)};
  return launch_run<false, true, true>(o, run, NoSpread{}, stream, ip, gg);
}
#endif

#if KTPU_IN_PART(3)
// The gang carry with inter-pod (anti-)affinity and SelectorSpread: the
// operands of ktpu_assign_scan_spread_interpod, then gang_id, gang_min and
// undo.
extern "C" int ktpu_assign_scan_spread_interpod_gang(
    const float* masked_static, const float* requests,
    const float* nonzero_requests, const float* allocatable, float* requested,
    float* nonzero, int* assignments, float* scores, int* feasible_counts,
    long long* rr_io, int P, int N, int run, float w_lr, float w_ba,
    float* node_t, const float* dom0, float* dom, const float* totals,
    const int* pod_ip, const int* topology, const int* term_attr, int uq,
    int ue, int k, int nd, int use_ipa, float w_ip, float hard_w,
    const int* spread_q, const int* zone, int nz, float w_ss,
    const int* gang_id, const int* gang_min, float* undo,
    const void* node_w, const int* pod_w, float w_tt, float w_na,
    cudaStream_t stream) {
  if (uq < 0 || uq > IP_MAX_UQ || ue < 0 || ue > IP_MAX_UE || k < 5
      || k > IP_MAX_K || nd < 1 || nd > IP_MAX_D || nd > MAX_DOMAINS || nz < 0
      || nz > nd)
    return (int)cudaErrorInvalidValue;
  const Operands o{masked_static, requests, nonzero_requests, allocatable,
                   requested, nonzero, assignments, scores, feasible_counts,
                   rr_io, P, N, w_lr, w_ba,
                   NormArgs{static_cast<const ulonglong2*>(node_w), pod_w, w_tt, w_na}};
  const SpreadArgs sp{node_t, spread_q, nullptr, zone, uq, nz, nd, w_ss};
  const IpaArgs ip{node_t, dom0, dom, totals, pod_ip, topology, term_attr, uq, ue,
                   k, nd, use_ipa, w_ip, hard_w};
  const GangArgs gg{gang_id, gang_min, reinterpret_cast<float4*>(undo)};
  return launch_run<true, true, true>(o, run, sp, stream, ip, gg);
}
#endif

#if KTPU_IN_PART(4)
// The EXT variant of the main build: the operands of ktpu_assign_scan (the
// gpu, scratch and overlay requests may be nonzero: they are fit against
// the running ledger), then node_words [N + 1][4] u64, 16-byte aligned:
// row 0 MaxPDVolumeCount's table (three type masks, bit u: atom u is of the
// type or ANY, then the limits, 16 bits each, and their count, at most 3,
// in bits 48-49), row g + 1 node g's conflict atoms in use, in use
// read-write, attach atoms present and host ports in use (updated in
// place); and pod_words [P][6] u64, 16-byte aligned: a pod's host ports, 0,
// the atoms it mounts read-write and read-only, its attach atoms, and its
// flags (1: attach fails, 2: conflict words, 4: attach words, 8: its words
// and fail bit equal the previous pod's). A word whose predicate does not
// run is 0.
extern "C" int ktpu_assign_scan_ext(
    const float* masked_static, const float* requests,
    const float* nonzero_requests, const float* allocatable, float* requested,
    float* nonzero, int* assignments, float* scores, int* feasible_counts,
    long long* rr_io, int P, int N, int run, float w_lr, float w_ba,
    void* node_words, const void* pod_words, const void* node_w, const int* pod_w,
    float w_tt, float w_na, cudaStream_t stream) {
  const Operands o{masked_static, requests, nonzero_requests, allocatable,
                   requested, nonzero, assignments, scores, feasible_counts,
                   rr_io, P, N, w_lr, w_ba,
                   NormArgs{static_cast<const ulonglong2*>(node_w), pod_w, w_tt, w_na}};
  const ExtArgs ex{static_cast<unsigned long long*>(node_words) + EXT_NODE_WORDS,
                   static_cast<const unsigned long long*>(pod_words), 0.0f, 0.0f, 0.0f, 0ull};
  return launch_run_ext<false>(o, run, stream, NoGang{}, ex);
}

// The EXT variant of the gang build: the operands of ktpu_assign_scan_gang's
// gang_id, gang_min and undo (a [CLUSTER, P, 5] float4 log under EXT), then
// those of ktpu_assign_scan_ext.
extern "C" int ktpu_assign_scan_gang_ext(
    const float* masked_static, const float* requests,
    const float* nonzero_requests, const float* allocatable, float* requested,
    float* nonzero, int* assignments, float* scores, int* feasible_counts,
    long long* rr_io, int P, int N, int run, float w_lr, float w_ba,
    const int* gang_id, const int* gang_min, float* undo, void* node_words,
    const void* pod_words, const void* node_w, const int* pod_w, float w_tt, float w_na,
    cudaStream_t stream) {
  const Operands o{masked_static, requests, nonzero_requests, allocatable,
                   requested, nonzero, assignments, scores, feasible_counts,
                   rr_io, P, N, w_lr, w_ba,
                   NormArgs{static_cast<const ulonglong2*>(node_w), pod_w, w_tt, w_na}};
  const GangArgs gg{gang_id, gang_min, reinterpret_cast<float4*>(undo)};
  const ExtArgs ex{static_cast<unsigned long long*>(node_words) + EXT_NODE_WORDS,
                   static_cast<const unsigned long long*>(pod_words), 0.0f, 0.0f, 0.0f, 0ull};
  return launch_run_ext<true>(o, run, stream, gg, ex);
}
#endif
