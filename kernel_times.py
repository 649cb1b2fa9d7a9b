#!/usr/bin/env python3
"""Time the port's CUDA kernels at the headline shape, for comparing two
trees of the repository on one card.

    python3 kernel_times.py [--root DIR] [--sass-out DIR] [--parts LIST]
                            [--sass-against DIR]

Imports `kubernetes_tpu_torch` from DIR (default: this file's directory),
so `--root` can point at an unpacked older commit: its kernels are built
from its own sources and fed the same seeded inputs as this tree's. The
inputs come from chip_smoke.py beside this file (P=4096 pods, N=16384
nodes): the static mask's operands, the main path's first batch, the
heterogeneous batch and the all-miss batch of the scan, where the tree
has the scan's spread build, bench[spread]'s first batch, where it has
the interpod build, bench[interpod]'s first batch, and where it has the
gang build, bench[gang]'s first batch (P=4096, N=65536), on which the
main build and kernel 1 are timed too, and the main build on the batch's
first 16,384 nodes (`gang_batch_run2_ms`: 2 nodes a thread against the
gang batch's 8), each scan also as the kernel's device time alone
(`gang_kernel_us`, `gang_batch_main_kernel_us`,
`gang_batch_run2_kernel_us`); and the spread and interpod builds at 8
nodes a thread on seeded inputs (P=1024, N=65536; `spread_run8_ms`,
`interpod_run8_ms` and their `*_kernel_us`); and Phase A traced
(`phase_a_gang`, `phase_a_one_class`: one solve of bench[gang]'s first
batch and of the one-class first batch, `masked_static_scores` and, on the
gang batch, `gang_member_mask`, each as its device ms a call and its ops'
own device ms, torch.profiler). Prints one
JSON line: the card (nvidia-smi name and power limit), the root, and each
time as median, min and max of CUDA-event timed calls (20 of the mask,
5 of each scan batch), in ms (a call's time includes its wrapper's host
work); each CUDA kernel's device time per launch on the main-path inputs
(torch.profiler), in us, which splits a call's time into the card's work
and the host's; and, per build of the scan (main, spread, interpod, gang) and
nodes per thread, its instruction count and two digests of its SASS
(cuobjdump; exact, and with register numbers normalized), so two trees'
builds can be compared instruction for instruction (`--sass-out` also
writes each build's register-normalized SASS there, one file a build and
RUN, for `diff`), and ptxas's registers and spills of each
(`scan_ptxas`). Where the tree has the spread build, it is also timed
with parts of its per-pod chain switched off by its inputs:
`spread_no_entry_ms` with every pod's entry -1 (no spread work, no
exchange), `spread_no_adds_ms` with an all-zero ledger and zero match rows
(the chain, but no ledger adds), beside the main build on the same batch
(`spread_batch_main_ms`). Where the tree has the interpod build, it is also timed
with parts of its per-pod chain switched off by its inputs, which prices
each part: `interpod_no_rows_ms` with the match and carried-term rows
zeroed (no winner broadcast, no replica update), `interpod_no_score_ms`
with the priority's weight 0 (no count exchange), and
`interpod_list_only_ms` with both and the predicate off (the count list's
barrier alone), beside the main build on the same batch
(`interpod_batch_main_ms`), each also as the kernel's device time alone
(`*_kernel_us`, torch.profiler); the placements differ between them, so
they price the chain, not a result. The interpod call is also profiled
(`interpod_device_us`): the build's kernel time per launch, and the
device time per call of everything the call runs (`per_call`: the
kernel and the wrapper's set-up kernels); with the host time until the
call returns (`interpod_enqueue_ms`), that splits the call's time into
the kernel's, the set-up's on the card and the host's. Where the tree has
the spread+interpod build, the spread_interpod cell's first batch (P=4096,
N=16384) runs through the main build, the spread build on its spread
gate, the interpod build on its ipa gate and the combined build on both
(`spread_interpod_batch_main_ms`, `spread_interpod_batch_spread_ms`,
`spread_interpod_batch_interpod_ms`, `spread_interpod_ms`), and the
combined build with no spread entry (`spread_interpod_no_entry_ms`) and
with the priority's weight 0 (`spread_interpod_no_score_ms`), and with
the normalization flag of one PreferNoSchedule taint on node 0 that no
pod tolerates (`spread_interpod_flag_ms`), each also as `*_kernel_us`;
with `run8`, also at 8 nodes a thread
(`spread_interpod_run8_*`). `--sass-against DIR` builds the scan of the
tree at DIR in a process of its own and reports, build by build and RUN
by RUN, whether this tree's SASS is byte-identical to it
(`scan_sass_same_as_against`). Where the tree has the normalization flag (`NormInputs`),
`norm` times the main build on the tt_na cell's first batch with the flag
(`tt_na_norm_ms`) and without it (`tt_na_flag_off_ms`), and each other
build on the first batch it is timed on above with the flag of one
PreferNoSchedule taint on node 0 that no pod tolerates (`*_norm_ms`,
beside the same build's flag-off time of its part), each also as
`*_kernel_us`; `norm_main` times the main and gang builds with the flag
alone (tt_na's first batch, `tt_na_norm_*` and `tt_na_flag_off_*`, and
bench[gang]'s first batch with that one taint, `gang_norm_*` and
`gang_flag_off_*`) and gives, where the tree has the host replay of the
main and gang builds' maxima table, the misses of each (`*_norm_misses`:
misses, pods exchanging maxima); `norm_si` times the spread and interpod
builds with the flag alone on bench[spread]'s and bench[interpod]'s first
batches, with one untolerated taint (`spread_one_taint_*`,
`interpod_one_taint_*`) and with the tt_na cell's alternating words at
the cell's size (`spread_tt_na_words_*`, `interpod_tt_na_words_*`:
TT_NA_NODES on its nodes, TT_NA_PODS' 16 classes on its pods), beside
each build without the flag (`spread_flag_off_*`, `interpod_flag_off_*`),
and, where the tree's host replay takes the interpod predicate, the misses
of each. Where the tree has the preemption pass (kernel 3,
`ops/preemption.py`), `preempt` holds it against its plain version on the
post-scan operands of the preemption cell's wave (perf/harness.py
`preemption_pass_inputs`, 15,000 nodes, N = 16,384, S = 16, P = 4,096) on
the uniform and the mixed cluster, and times it (`preempt_<variant>_ms`,
`*_kernel_us`: the kernel's device time a launch, torch.profiler) beside
the plain version once (`preempt_<variant>_plain_ms`), on the uniform
wave with every node statically infeasible, which prices the per-pod
exchange alone (`preempt_exchange_only_ms`, `_kernel_us`), and on
chip_smoke.py's wide check (the mixed operands at N = 65,536, their first
512 pods: `preempt_wide_ms`) and class-churn check (the first 512 pods
over 24 classes: `preempt_churn_ms`), each held against the plain
version first; with its ptxas report (`preempt_ptxas`: registers, spills
and static shared bytes of each instance) and, where the tree has
`preemption_layout`, the dynamic shared bytes and placement at N = 16,384
and 65,536 (`preempt_layout`). With `preempt` alone only kernel 3 is
built. `--sass-against DIR` also says whether kernel 1's SASS equals the
other tree's (`mask_sass_same_as_against`). `--parts` picks what to time, a comma list of
mask, scan, spread, interpod, spread_interpod, gang, run8, phase_a, norm,
norm_main, norm_si, preempt, gang_combined, ext and sass (all by default).
Where the tree has the EXT variant of the main and gang builds (host ports,
the gpu and storage fit), `ext` times them on the gpu_ports cell's first
batch (chip_smoke.py `gpu_ports_first_batch`: P = 4,096, N = 16,384): the
main build with and without EXT on the same operands (`ext_ms`,
`ext_batch_main_ms`), the gang build with and without EXT on the batch in
groups of 8 (`gang_ext_ms`, `ext_batch_gang_ms`) and on its reverting
variant (`gang_ext_reverting_ms`, with `gang_ext_reverting_groups`), and
both with the flag of one PreferNoSchedule taint on node 0
(`ext_norm_ms`, `gang_ext_norm_ms`), each also as `*_kernel_us`; the
builds with EXT are named `main+ext`, `gang+ext` (and `+norm`) in the
SASS digests.
Where the tree has the gang carry in the spread and interpod builds,
`gang_combined` prices it on the gang_spread_interpod cell's first batch
(P = 4,096, N = 16,384, 512 groups of 8): the spread, interpod and
spread+interpod builds, each without and with the carry
(`gsi_batch_<build>_ms`, `gsi_batch_<build>_gang_ms`), and the builds
with the carry on the batch's variant whose every 8th group reverts
(`gsi_reverting_<build>_gang_ms`), each also as `*_kernel_us`; the scan's
builds with the carry are named `spread_gang`, `interpod_gang` and
`spread_interpod_gang` in the SASS digests. Exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import importlib.util
import inspect
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPS = 5
PARTS = ("mask", "scan", "spread", "interpod", "spread_interpod", "gang", "run8",
         "phase_a", "norm", "norm_main", "norm_si", "preempt", "gang_combined", "ext",
         "sass")
# the gang batch's columns timed at 2 nodes a thread, and the shape of the
# spread and interpod builds' 8-node timing
RUN2_COLUMNS = 16384
RUN8_PODS, RUN8_NODES = 1024, 65536


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--sass-out", type=Path, default=None)
    ap.add_argument("--parts", default=",".join(PARTS))
    ap.add_argument("--sass-against", type=Path, default=None)
    opts = ap.parse_args()
    parts = set(opts.parts.split(","))
    if not parts <= set(PARTS):
        ap.error(f"--parts: {sorted(parts - set(PARTS))} not in {PARTS}")
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, str(opts.root.resolve()))
    from kubernetes_tpu_torch.native.build import (KERNELS, build, build_log,
                                                   library_path, nvcc_path)
    from kubernetes_tpu_torch.ops import assign_scan as scan_module
    from kubernetes_tpu_torch.ops.assign_scan import assign_scan
    from kubernetes_tpu_torch.ops.static_mask import static_mask

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(smoke.SEED)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    # (the preemption kernel alone when nothing else is timed)
    build(("preemption",) if parts <= {"preempt"} else
          tuple(n for n in KERNELS if n != "preemption" or "preempt" in parts))
    out = {"root": str(opts.root), "nvidia_smi": smi.splitlines()[0]}
    if "mask" in parts:
        args = smoke.static_mask_inputs(torch, rng, dev)
        out.update(smoke.timed(torch, lambda: static_mask(*args), 4 * REPS,
                               "static_mask_ms"))
    if "scan" in parts:
        scan_args = smoke.first_batch(torch, dev)[-1]
        het = smoke.scan_inputs(torch, rng, dev)
        miss = smoke.scan_inputs(torch, rng, dev, all_miss=True)
        for key, a in (("assign_scan_ms", scan_args), ("heterogeneous_ms", het),
                       ("all_miss_ms", miss)):
            out.update(smoke.timed(torch, lambda a=a: assign_scan(*a), REPS, key))
    if {"mask", "scan"} <= parts:
        out["device_us_per_launch"] = device_times(
            torch, ((lambda: static_mask(*args), 10),
                    (lambda: assign_scan(*scan_args), 3)))["per_launch"]
    if "spread" in parts and hasattr(scan_module, "assign_scan_spread"):
        spread_scan = scan_module.assign_scan_spread
        _c, _n, _p, _s, state, batch, flags, zones = smoke.spread_first_batch(torch, dev)
        fields = {f.name for f in dataclasses.fields(scan_module.SpreadInputs)}
        sargs, spread = smoke.spread_scan_args(
            torch, state, batch, _c, flags, zones if "zones" in fields else None)
        # the main build on the same batch: the chain without spread work
        out.update(smoke.timed(torch, lambda: assign_scan(*sargs), REPS,
                               "spread_batch_main_ms"))
        variants = (
            ("spread_ms", spread),
            ("spread_no_entry_ms", dataclasses.replace(
                spread, spread_q=torch.full_like(spread.spread_q, -1))),
            ("spread_no_adds_ms", dataclasses.replace(
                spread, podsel_count=torch.zeros_like(spread.podsel_count),
                pod_matches_q=torch.zeros_like(spread.pod_matches_q))))
        for key, v in variants:
            out.update(smoke.timed(torch, lambda v=v: spread_scan(*sargs, v), REPS,
                                   key))
    if "interpod" in parts and hasattr(scan_module, "assign_scan_interpod"):
        interpod_scan = scan_module.assign_scan_interpod
        _c, iargs, ip = smoke.interpod_first_batch(torch, dev)
        no_rows = dataclasses.replace(
            ip, pod_matches_q=torch.zeros_like(ip.pod_matches_q),
            pod_carries_e=torch.zeros_like(ip.pod_carries_e))
        # the main build on the same batch: the chain without inter-pod work
        out.update(smoke.timed(torch, lambda: assign_scan(*iargs), REPS,
                               "interpod_batch_main_ms"))
        variants = (("interpod_ms", ip), ("interpod_no_rows_ms", no_rows),
                    ("interpod_no_score_ms", dataclasses.replace(ip, w_ip=0.0)),
                    ("interpod_list_only_ms", dataclasses.replace(
                        no_rows, w_ip=0.0, use_ipa=False)))
        for key, v in variants:
            out.update(smoke.timed(torch, lambda v=v: interpod_scan(*iargs, v),
                                   REPS, key))
            # the build's own device time on this variant, in us
            out[f"{key[:-3]}_kernel_us"] = kernel_us(device_times(
                torch, ((lambda v=v: interpod_scan(*iargs, v), REPS),)))
        out["interpod_batch_main_kernel_us"] = kernel_us(device_times(
            torch, ((lambda: assign_scan(*iargs), REPS),)))
        out["interpod_device_us"] = device_times(
            torch, ((lambda: interpod_scan(*iargs, ip), REPS),))
        out["interpod_enqueue_ms"] = enqueue_ms(
            torch, lambda: interpod_scan(*iargs, ip))
    if "spread_interpod" in parts and hasattr(scan_module,
                                              "assign_scan_spread_interpod"):
        # the spread_interpod cell's first batch through the main build and
        # through each build on the gates it carries: the price of each half
        _c, siargs, sp, ip = smoke.spread_interpod_first_batch(torch, dev)
        si_scan = scan_module.assign_scan_spread_interpod
        # the combined build with one half's work switched off by its inputs:
        # no spread entry (no spread partial), and the priority's weight 0
        # (no (min, max)); the placements differ, so they price the chain
        no_entry = dataclasses.replace(sp, spread_q=torch.full_like(sp.spread_q, -1))
        no_score = dataclasses.replace(ip, w_ip=0.0)
        flag = (smoke.one_taint_norm(torch, dev, *siargs[0].shape),)
        for key, call in (
                ("spread_interpod_batch_main", lambda: assign_scan(*siargs)),
                ("spread_interpod_batch_spread",
                 lambda: scan_module.assign_scan_spread(*siargs, sp)),
                ("spread_interpod_batch_interpod",
                 lambda: scan_module.assign_scan_interpod(*siargs, ip)),
                ("spread_interpod", lambda: si_scan(*siargs, sp, ip)),
                ("spread_interpod_no_entry", lambda: si_scan(*siargs, no_entry, ip)),
                ("spread_interpod_no_score", lambda: si_scan(*siargs, sp, no_score)),
                ("spread_interpod_flag", lambda: si_scan(*siargs, sp, ip, *flag))):
            out.update(smoke.timed(torch, call, REPS, f"{key}_ms"))
            out[f"{key}_kernel_us"] = kernel_us(device_times(torch, ((call, REPS),)))
    if {"gang", "phase_a"} & parts and hasattr(scan_module, "assign_scan_gang"):
        _c, _n, _p, mask_args, gargs, gang, gstate, gbatch = smoke.gang_first_batch(
            torch, dev)
    if "gang" in parts and hasattr(scan_module, "assign_scan_gang"):
        gang_scan = scan_module.assign_scan_gang
        out.update(smoke.timed(torch, lambda: static_mask(*mask_args), 4 * REPS,
                               "gang_batch_static_mask_ms"))
        out.update(smoke.timed(torch, lambda: gang_scan(*gargs, gang), REPS,
                               "gang_ms"))
        out.update(smoke.timed(torch, lambda: assign_scan(*gargs), REPS,
                               "gang_batch_main_ms"))
        # the same batch's first RUN2_COLUMNS nodes: the main build at 2
        # nodes a thread, so the chain's growth with the run is one number
        run2 = (gargs[0][:, :RUN2_COLUMNS].contiguous(), *gargs[1:3],
                *(a[:RUN2_COLUMNS].contiguous() for a in gargs[3:6]), *gargs[6:])
        out.update(smoke.timed(torch, lambda: assign_scan(*run2), REPS,
                               "gang_batch_run2_ms"))
        for key, call in (("gang", lambda: gang_scan(*gargs, gang)),
                          ("gang_batch_main", lambda: assign_scan(*gargs)),
                          ("gang_batch_run2", lambda: assign_scan(*run2))):
            out[f"{key}_kernel_us"] = kernel_us(device_times(torch, ((call, REPS),)))
    if "phase_a" in parts and hasattr(scan_module, "assign_scan_gang"):
        # Phase A traced, ops by their device time: one solve of bench[gang]'s
        # first batch and one of the one-class main path's
        from kubernetes_tpu_torch.ops import solver

        one = smoke.first_batch(torch, dev)
        for key, state, batch in (("gang", gstate, gbatch), ("one_class", one[4], one[5])):
            gates = solver.check_supported(solver.DEFAULT_POLICY,
                                           solver.batch_flags(state, batch))
            calls = {"solve": lambda: solver.schedule_batch(state, batch, 0),
                     "masked_static_scores": lambda: solver.masked_static_scores(
                         state, batch, solver.DEFAULT_POLICY, gates)}
            if key == "gang":
                got = solver.schedule_batch(state, batch, 0)
                calls["gang_member_mask"] = lambda: solver.gang_member_mask(
                    batch.gang_id, batch.gang_min, got.assignments, got.scores)
            out[f"phase_a_{key}"] = {name: op_table(torch, call)
                                     for name, call in calls.items()}
    if "run8" in parts:
        # the spread and interpod builds at 8 nodes a thread, on seeded
        # inputs of their own
        rng8 = np.random.default_rng(smoke.SEED + 8)
        sargs = smoke.scan_inputs(torch, rng8, dev, RUN8_PODS, RUN8_NODES)
        spread = smoke.spread_inputs(torch, rng8, dev, RUN8_NODES, RUN8_PODS)
        ip = smoke.interpod_inputs(torch, rng8, dev, RUN8_NODES, RUN8_PODS)
        calls = [("spread_run8", lambda: scan_module.assign_scan_spread(
                      *sargs, 1.0, 1.0, spread)),
                 ("interpod_run8", lambda: scan_module.assign_scan_interpod(
                      *sargs, 1.0, 1.0, ip))]
        if hasattr(scan_module, "assign_scan_spread_interpod"):
            sp8, ip8 = smoke.with_spread(torch, rng8, ip, zones=3)
            calls.append(("spread_interpod_run8",
                          lambda: scan_module.assign_scan_spread_interpod(
                              *sargs, 1.0, 1.0, sp8, ip8)))
        for key, call in calls:
            out.update(smoke.timed(torch, call, REPS, f"{key}_ms"))
            out[f"{key}_kernel_us"] = kernel_us(device_times(torch, ((call, REPS),)))
    if "norm" in parts and hasattr(scan_module, "NormInputs"):
        # the flag's price in each build: the tt_na cell's first batch
        # through the main build with and without it, and each other build
        # on its cell's first batch with one untolerated taint
        caps_t, state, batch, flags = smoke.tt_na_first_batch(torch, dev)
        _name, _k, _p, targs, tnorm, _c, _b = smoke.scan_call(torch, state, batch,
                                                               flags, caps_t)
        calls = [("tt_na_norm", lambda: assign_scan(*targs, tnorm)),
                 ("tt_na_flag_off", lambda: assign_scan(*targs))]
        _c, _n, _p, _s, sstate, sbatch, sflags, zones = smoke.spread_first_batch(torch, dev)
        sargs, spread = smoke.spread_scan_args(torch, sstate, sbatch, _c, sflags, zones)
        _c, iargs, ip = smoke.interpod_first_batch(torch, dev)
        _c, siargs, sp, sip = smoke.spread_interpod_first_batch(torch, dev)
        _c, _n, _p, _m, gargs, gang, _gs, _gb = smoke.gang_first_batch(torch, dev)
        for key, fn, a, extra in (
                ("spread", scan_module.assign_scan_spread, sargs, (spread,)),
                ("interpod", scan_module.assign_scan_interpod, iargs, (ip,)),
                ("spread_interpod", scan_module.assign_scan_spread_interpod, siargs,
                 (sp, sip)),
                ("gang", scan_module.assign_scan_gang, gargs, (gang,))):
            one = smoke.one_taint_norm(torch, dev, *a[0].shape)
            calls.append((f"{key}_norm", lambda fn=fn, a=a, extra=extra, one=one:
                          fn(*a, *extra, one)))
        for key, call in calls:
            out.update(smoke.timed(torch, call, REPS, f"{key}_ms"))
            out[f"{key}_kernel_us"] = kernel_us(device_times(torch, ((call, REPS),)))
    if "norm_main" in parts and hasattr(scan_module, "NormInputs"):
        # the main and gang builds with the flag alone: tt_na's first batch
        # and bench[gang]'s first with one untolerated taint, each beside
        # its build without the flag, and where the tree has the host
        # replay of the maxima table, the misses of each
        caps_t, state, batch, flags = smoke.tt_na_first_batch(torch, dev)
        _name, _k, _p, targs, tnorm, _c, _b = smoke.scan_call(torch, state, batch,
                                                               flags, caps_t)
        _c, _n, _p, _m, gargs, gang, _gs, _gb = smoke.gang_first_batch(torch, dev)
        one = smoke.one_taint_norm(torch, dev, *gargs[0].shape)
        gang_scan = scan_module.assign_scan_gang
        for key, call in (("tt_na_norm", lambda: assign_scan(*targs, tnorm)),
                          ("tt_na_flag_off", lambda: assign_scan(*targs)),
                          ("gang_norm", lambda: gang_scan(*gargs, gang, one)),
                          ("gang_flag_off", lambda: gang_scan(*gargs, gang))):
            out.update(smoke.timed(torch, call, REPS, f"{key}_ms"))
            out[f"{key}_kernel_us"] = kernel_us(device_times(torch, ((call, REPS),)))
        if hasattr(scan_module, "norm_table_misses"):
            for key, name, args, norm in (("tt_na", "assign_scan", targs, tnorm),
                                          ("gang", "assign_scan_gang", (*gargs, gang), one)):
                kern = assign_scan if name == "assign_scan" else gang_scan
                out[f"{key}_norm_misses"] = smoke.norm_misses(name, args, norm,
                                                              kern(*args, norm))
    if "norm_si" in parts and hasattr(scan_module, "NormInputs"):
        # the spread and interpod builds with the flag alone: bench[spread]'s
        # and bench[interpod]'s first batches with one untolerated taint
        # (norm_cells') and with the tt_na cell's alternating words at the
        # cell's size, each beside its build without the flag, and where the
        # tree's host replay takes the interpod predicate, the misses of each
        _c, _n, _p, _s, sstate, sbatch, sflags, zones = smoke.spread_first_batch(torch, dev)
        sargs, spread = smoke.spread_scan_args(torch, sstate, sbatch, _c, sflags, zones)
        _c, iargs, ip = smoke.interpod_first_batch(torch, dev)
        replay = "interpod" in inspect.signature(
            getattr(scan_module, "norm_true_maxima", lambda: None)).parameters
        for key, name, a, size in (
                ("spread", "assign_scan_spread", (*sargs, spread),
                 (smoke.HEADLINE_NODES, smoke.HEADLINE_PODS)),
                ("interpod", "assign_scan_interpod", (*iargs, ip),
                 (smoke.INTERPOD_NODES, smoke.INTERPOD_PODS))):
            fn = getattr(scan_module, name)
            words = {"one_taint": smoke.one_taint_norm(torch, dev, *a[0].shape),
                     "tt_na_words": smoke.tt_na_words(torch, dev, *size)}
            calls = [(f"{key}_flag_off", lambda fn=fn, a=a: fn(*a))]
            calls += [(f"{key}_{w}", lambda fn=fn, a=a, v=v: fn(*a, v))
                      for w, v in words.items()]
            for k, call in calls:
                out.update(smoke.timed(torch, call, REPS, f"{k}_ms"))
                out[f"{k}_kernel_us"] = kernel_us(device_times(torch, ((call, REPS),)))
            if replay:
                for w, v in words.items():
                    out[f"{key}_{w}_norm_misses"] = smoke.norm_misses(name, a, v, fn(*a, v))
    if "preempt" in parts and importlib.util.find_spec(
            "kubernetes_tpu_torch.ops.preemption") is not None:
        from kubernetes_tpu_torch.ops.preemption import (
            preemption_pass,
            preemption_pass_plain,
        )
        from kubernetes_tpu_torch.perf.harness import (
            preemption_cluster,
            preemption_pass_inputs,
        )

        for variant in ("uniform", "mixed"):
            inputs = preemption_pass_inputs(
                *preemption_cluster(smoke.PREEMPT_NODES, variant, dev))
            args = (*inputs.args(), inputs.use_gang)
            got = preemption_pass(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = preemption_pass_plain(*args)
            torch.cuda.synchronize()
            out[f"preempt_{variant}_plain_ms"] = 1e3 * (time.perf_counter() - t0)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"preempt {variant}: kernel 3 != plain")
            call = lambda args=args: preemption_pass(*args)  # noqa: E731
            out.update(smoke.timed(torch, call, REPS, f"preempt_{variant}_ms"))
            out[f"preempt_{variant}_kernel_us"] = next(
                us for name, us in device_times(torch, ((call, REPS),))["per_launch"].items()
                if name.startswith("preemption_kernel"))
            out[f"preempt_{variant}_pods"] = int(inputs.part.sum())
            if variant == "uniform":
                # every node statically infeasible: each taking-part pod
                # still crosses the blocks, no node is evaluated or booked
                bare = dataclasses.replace(
                    inputs, masked_static=torch.full_like(inputs.masked_static,
                                                          float("-inf")))
                call = lambda a=(*bare.args(), False): preemption_pass(*a)  # noqa: E731
                out.update(smoke.timed(torch, call, REPS, "preempt_exchange_only_ms"))
                out["preempt_exchange_only_kernel_us"] = next(
                    us for name, us in device_times(torch, ((call, REPS),))["per_launch"].items()
                    if name.startswith("preemption_kernel"))
                continue
            # the wide check (N = 65,536, the batch's first 512 pods) and the
            # class churn (the first 512 pods over 24 classes), as
            # chip_smoke.py holds them
            for key, held in (
                    ("wide", smoke.widened(torch, inputs, smoke.PREEMPT_WIDE_COPIES,
                                           smoke.PREEMPT_WIDE_PODS, seed=13)),
                    ("churn", smoke.class_churn(torch, inputs, smoke.PREEMPT_CHURN_PODS,
                                                seed=17))):
                a = (*held.args(), False)
                if not all(torch.equal(x, y) for x, y in zip(preemption_pass(*a),
                                                               preemption_pass_plain(*a))):
                    raise AssertionError(f"preempt {key}: kernel 3 != plain")
                call = lambda a=a: preemption_pass(*a)  # noqa: E731
                out.update(smoke.timed(torch, call, REPS, f"preempt_{key}_ms"))
                out[f"preempt_{key}_kernel_us"] = next(
                    us for name, us in device_times(torch, ((call, REPS),))["per_launch"].items()
                    if name.startswith("preemption_kernel"))
                del held
        from kubernetes_tpu_torch.ops import preemption as preempt_module

        if hasattr(preempt_module, "preemption_layout"):
            out["preempt_layout"] = {
                n: dataclasses.asdict(preempt_module.preemption_layout(
                    n, 16, 6, preempt_module.card_smem_limit(dev)))
                for n in (16384, 65536)}
        out["preempt_ptxas"] = smoke.ptxas_report(build_log("preemption"))
    if "gang_combined" in parts and hasattr(scan_module, "assign_scan_spread_interpod_gang"):
        # the gang carry's price: the gang_spread_interpod cell's first batch
        # through the spread, interpod and spread+interpod builds, each
        # without and with the carry, and through the builds with the carry
        # on the batch's reverting variant
        _c, gargs, sp, ip, gang = smoke.gang_spread_interpod_first_batch(torch, dev)
        _c, rargs, rsp, rip, rgang = smoke.gang_spread_interpod_first_batch(
            torch, dev, smoke.GSI_REVERT_EVERY)
        sm = scan_module
        for key, call in (
                ("gsi_batch_spread", lambda: sm.assign_scan_spread(*gargs, sp)),
                ("gsi_batch_spread_gang", lambda: sm.assign_scan_spread_gang(*gargs, sp, gang)),
                ("gsi_batch_interpod", lambda: sm.assign_scan_interpod(*gargs, ip)),
                ("gsi_batch_interpod_gang",
                 lambda: sm.assign_scan_interpod_gang(*gargs, ip, gang)),
                ("gsi_batch_spread_interpod",
                 lambda: sm.assign_scan_spread_interpod(*gargs, sp, ip)),
                ("gsi_batch_spread_interpod_gang",
                 lambda: sm.assign_scan_spread_interpod_gang(*gargs, sp, ip, gang)),
                ("gsi_reverting_spread_gang",
                 lambda: sm.assign_scan_spread_gang(*rargs, rsp, rgang)),
                ("gsi_reverting_interpod_gang",
                 lambda: sm.assign_scan_interpod_gang(*rargs, rip, rgang)),
                ("gsi_reverting_spread_interpod_gang",
                 lambda: sm.assign_scan_spread_interpod_gang(*rargs, rsp, rip, rgang))):
            out.update(smoke.timed(torch, call, REPS, f"{key}_ms"))
            out[f"{key}_kernel_us"] = kernel_us(device_times(torch, ((call, REPS),)))
        from kubernetes_tpu_torch.ops import solver

        res = sm.assign_scan_spread_interpod_gang(*rargs, rsp, rip, rgang)
        out["gsi_reverting_groups_reverted"] = int(solver.gang_member_mask(
            rgang.gang_id, rgang.gang_min, res.assignments, res.scores)[3])
    if "ext" in parts and hasattr(scan_module, "assign_scan_ext"):
        # the EXT variant's price: the gpu_ports cell's first batch through
        # the main build with and without EXT, in groups of 8 through the
        # gang build with and without it, its reverting variant, and both
        # builds with EXT and the flag of one PreferNoSchedule taint
        sm = scan_module
        calls = {}
        for key, group, revert, taint in (("main", False, False, False),
                                          ("gang", True, False, False),
                                          ("reverting", True, True, False),
                                          ("main_flag", False, False, True),
                                          ("gang_flag", True, False, True)):
            caps_x, state, batch, flags = smoke.gpu_ports_first_batch(
                torch, dev, group, revert, taint)
            calls[key] = smoke.scan_call(torch, state, batch, flags, caps_x)
        margs, gargs = calls["main"][3], calls["gang"][3]
        rargs = calls["reverting"][3]
        fnorm, gfnorm = calls["main_flag"][4], calls["gang_flag"][4]
        fargs, gfargs = calls["main_flag"][3], calls["gang_flag"][3]
        for key, call in (
                ("ext_batch_main", lambda: sm.assign_scan(*margs[:9])),
                ("ext", lambda: sm.assign_scan_ext(*margs)),
                ("ext_batch_gang", lambda: sm.assign_scan_gang(*gargs[:9], gargs[10])),
                ("gang_ext", lambda: sm.assign_scan_gang_ext(*gargs)),
                ("gang_ext_reverting", lambda: sm.assign_scan_gang_ext(*rargs)),
                ("ext_norm", lambda: sm.assign_scan_ext(*fargs, fnorm)),
                ("gang_ext_norm", lambda: sm.assign_scan_gang_ext(*gfargs, gfnorm))):
            out.update(smoke.timed(torch, call, REPS, f"{key}_ms"))
            out[f"{key}_kernel_us"] = kernel_us(device_times(torch, ((call, REPS),)))
        from kubernetes_tpu_torch.ops import solver

        res = sm.assign_scan_gang_ext(*rargs)
        out["gang_ext_reverting_groups"] = [int(x) for x in solver.gang_member_mask(
            rargs[10].gang_id, rargs[10].gang_min, res.assignments, res.scores)[2:]]
        for key, name, args, norm in (("ext", "assign_scan_ext", fargs, fnorm),
                                      ("gang_ext", "assign_scan_gang_ext", gfargs, gfnorm)):
            out[f"{key}_norm_misses"] = smoke.norm_misses(
                name, args, norm, getattr(sm, name)(*args, norm))
        del calls, margs, gargs, rargs, fargs, gfargs
    if "sass" in parts:
        cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
        out["scan_sass"] = sass_digests(cuobjdump, library_path("assign_scan"),
                                        opts.sass_out)
        out["scan_ptxas"] = smoke.ptxas_report(build_log("assign_scan"))
        if opts.sass_against is not None:
            # the other tree's scan, built by its own build module in a
            # process of its own, build for build and RUN for RUN
            other = subprocess.run(
                [sys.executable, "-c", _BUILD_OTHER, str(opts.sass_against.resolve())],
                capture_output=True, text=True, timeout=900, check=True)
            scan_lib, mask_lib = other.stdout.split()[-2:]
            theirs = sass_digests(cuobjdump, Path(scan_lib))
            mine = out["scan_sass"]
            out["scan_sass_same_as_against"] = {
                build: {run: mine.get(build, {}).get(run, {}).get("exact") == d["exact"]
                        for run, d in runs.items()}
                for build, runs in theirs.items()}
            out["mask_sass_same_as_against"] = (
                library_digest(cuobjdump, library_path("static_mask"))
                == library_digest(cuobjdump, Path(mask_lib)))
    print(json.dumps(out), flush=True)
    return 0


# the scan's builds by their template flags after RUN: (SPREAD[, IPA[, GANG]]);
# a fourth flag, NORM, names the build with the normalization flag
# `<build>+norm`, and without it the build itself; a fifth, EXT, the build
# with the EXT variant `<build>+ext` (after `+norm`)
BUILDS = {"": "main", "0": "main", "00": "main", "000": "main", "1": "spread",
          "10": "spread", "100": "spread", "01": "interpod", "010": "interpod",
          "001": "gang", "11": "spread_interpod", "110": "spread_interpod",
          "101": "spread_gang", "011": "interpod_gang", "111": "spread_interpod_gang"}


def build_name(flags: str) -> str:
    """A scan build's name from its template flags after RUN."""
    if len(flags) >= 4:
        return (BUILDS[flags[:3]] + ("+norm" if flags[3] == "1" else "")
                + ("+ext" if flags[4:] == "1" else ""))
    return BUILDS[flags]

# builds the scan and mask libraries of the tree at argv[1] and prints
# their paths
_BUILD_OTHER = ("import sys; sys.path.insert(0, sys.argv[1]); "
                "from kubernetes_tpu_torch.native.build import build, library_path; "
                "build(('static_mask', 'assign_scan')); "
                "print(library_path('assign_scan'), library_path('static_mask'))")


def library_digest(cuobjdump: str, library: Path) -> str:
    """A sha1 of every function's instruction text in a built library
    (addresses and encodings left out), for kernel 1's SASS."""
    sass = subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    lines = [re.sub(r"/\*[^*]*\*/", "", ln).strip()
             for ln in sass.splitlines() if "/*" in ln and ";" in ln]
    return hashlib.sha1("\n".join(lines).encode()).hexdigest()[:16]


def sass_digests(cuobjdump: str, library: Path, sass_out: Path | None = None) -> dict:
    """{build: {nodes per thread: {instructions, exact, registers_renamed}}}
    of the scan's builds in a built library (the kernel
    `assign_scan_kernel<RUN[, SPREAD[, IPA[, GANG[, NORM]]]]>`): the instruction count, a
    sha1 of the instruction text, and one with the register numbers
    replaced by R and the operand-reuse hints (`.reuse`, which follow the
    register allocation) dropped, so two builds that differ only in
    register allocation share the second. Addresses, encodings and the
    function's own name are left out. With `sass_out`, the normalized text
    of each build goes to `<sass_out>/<build>-<RUN>.sass`."""
    sass = subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    out: dict = {}
    for chunk in sass.split("Function : ")[1:]:
        name, _, body = chunk.partition("\n")
        m = re.search(r"assign_scan_kernelILi(\d)E((?:Lb[01]E)*)[EJ]", name)
        if m is None:
            continue
        build = build_name(re.sub(r"[^01]", "", m.group(2)))
        lines = [re.sub(r"/\*[^*]*\*/", "", ln).strip()
                 for ln in body.splitlines() if "/*" in ln and ";" in ln]
        text = "\n".join(lines)
        renamed = re.sub(r"\bR\d+\b", "R", text).replace(".reuse", "")
        out.setdefault(build, {})[m.group(1)] = {
            "instructions": len(lines),
            "exact": hashlib.sha1(text.encode()).hexdigest()[:16],
            "registers_renamed": hashlib.sha1(renamed.encode()).hexdigest()[:16]}
        if sass_out is not None:
            sass_out.mkdir(parents=True, exist_ok=True)
            (sass_out / f"{build}-{m.group(1)}.sass").write_text(renamed + "\n")
    return out


def op_table(torch, call, reps=REPS) -> dict:
    """One profiled window of `call` (run once first): {"device_ms": the
    card's time per call, kernels and copies, "ops": {op: the device ms a
    call of the kernels it launched itself}, "kernels": {kernel or copy:
    its device ms a call}}, largest first."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    ops, kernels = {}, {}
    for evt in prof.key_averages():
        dev_self = getattr(evt, "self_device_time_total", None)
        if dev_self is None:
            dev_self = evt.self_cuda_time_total
        if dev_self > 0:
            on_card = str(getattr(evt, "device_type", "")).endswith("CUDA")
            table = kernels if on_card else ops
            key = evt.key[:80]
            table[key] = table.get(key, 0.0) + dev_self / reps / 1e3

    def largest(d):
        return dict(sorted(d.items(), key=lambda kv: -kv[1]))

    return {"device_ms": sum(kernels.values()), "ops": largest(ops),
            "kernels": largest(kernels)}


def kernel_us(times: dict) -> float:
    """The scan kernel's device us per launch in a device_times result."""
    return next(us for name, us in times["per_launch"].items()
                if name.startswith("assign_scan_kernel"))


def enqueue_ms(torch, call, reps=REPS) -> float:
    """Median host time of `call` until it returns, the card idle before
    each: for a wrapper that launches its kernel last, the host's set-up."""
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        times.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return statistics.median(times[1:])


def device_times(torch, calls) -> dict:
    """Device time over a profiled window of `calls`, (call, count) pairs
    each run once to warm up first: {"per_launch": {name: device us per
    launch, of each kernel and of each op that issued kernels},
    "per_call": us of every kernel and copy the window ran on the card,
    divided by the number of calls}."""
    from torch.profiler import ProfilerActivity, profile

    for call, _count in calls:
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for call, count in calls:
            for _ in range(count):
                call()
        torch.cuda.synchronize()
    times, total = {}, 0.0
    for evt in prof.key_averages():
        dev_total = getattr(evt, "self_device_time_total", None)
        if dev_total is None:
            dev_total = evt.self_cuda_time_total
        if dev_total <= 0:
            continue
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            total += dev_total   # kernels and copies, not the ops that issued them
        if "Memcpy" not in evt.key and "Memset" not in evt.key:
            name = evt.key.replace("(anonymous namespace)::", "").replace("void ", "")
            times[name.split("(")[0]] = dev_total / evt.count
    return {"per_launch": times, "per_call": total / sum(c for _f, c in calls)}


if __name__ == "__main__":
    sys.exit(main())
