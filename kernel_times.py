#!/usr/bin/env python3
"""Time the port's CUDA kernels at the headline shape, for comparing two
trees of the repository on one card.

    python3 kernel_times.py [--root DIR]

Imports `kubernetes_tpu_torch` from DIR (default: this file's directory),
so `--root` can point at an unpacked older commit: its kernels are built
from its own sources and fed the same seeded inputs as this tree's. The
inputs come from chip_smoke.py beside this file (P=4096 pods, N=16384
nodes): the static mask's operands, the main path's first batch, the
heterogeneous batch and the all-miss batch of the scan, and, where the
tree has the scan's spread build, bench[spread]'s first batch. Prints one
JSON line: the card (nvidia-smi name and power limit), the root, and each
time as median, min and max of CUDA-event timed calls (20 of the mask,
5 of each scan batch), in ms (a call's time includes its wrapper's host
work); each CUDA kernel's device time per launch on the main-path inputs
(torch.profiler), in us, which splits a call's time into the card's work
and the host's; and, per build of the main scan (nodes per thread), its
instruction count and two digests of its SASS (cuobjdump; exact, and with
register numbers normalized), so two trees' main builds can be compared
instruction for instruction. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPS = 5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE)
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, str(opts.root.resolve()))
    from kubernetes_tpu_torch.native.build import build, library_path, nvcc_path
    from kubernetes_tpu_torch.ops import assign_scan as scan_module
    from kubernetes_tpu_torch.ops.assign_scan import assign_scan
    from kubernetes_tpu_torch.ops.static_mask import static_mask

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(smoke.SEED)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    build()
    out = {"root": str(opts.root), "nvidia_smi": smi.splitlines()[0]}
    args = smoke.static_mask_inputs(torch, rng, dev)
    out.update(smoke.timed(torch, lambda: static_mask(*args), 4 * REPS,
                           "static_mask_ms"))
    scan_args = smoke.first_batch(torch, dev)[-1]
    het = smoke.scan_inputs(torch, rng, dev)
    miss = smoke.scan_inputs(torch, rng, dev, all_miss=True)
    for key, a in (("assign_scan_ms", scan_args), ("heterogeneous_ms", het),
                   ("all_miss_ms", miss)):
        out.update(smoke.timed(torch, lambda a=a: assign_scan(*a), REPS, key))
    out["device_us_per_launch"] = device_times(
        torch, lambda: static_mask(*args), lambda: assign_scan(*scan_args))
    if hasattr(scan_module, "assign_scan_spread"):
        spread_scan = scan_module.assign_scan_spread
        _c, _n, _p, _s, state, batch, flags = smoke.spread_first_batch(torch, dev)
        sargs, spread = smoke.spread_scan_args(torch, state, batch, _c, flags)
        out.update(smoke.timed(torch, lambda: spread_scan(*sargs, spread), REPS,
                               "spread_ms"))
    cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    out["main_scan_sass"] = main_sass_digests(cuobjdump, library_path("assign_scan"))
    print(json.dumps(out), flush=True)
    return 0


def main_sass_digests(cuobjdump: str, library: Path) -> dict:
    """{nodes per thread: {instructions, exact, registers_renamed}} of the
    main scan's builds in a built library (the kernel
    `assign_scan_kernel<RUN>` or `assign_scan_kernel<RUN, false>`): the
    instruction count, a sha1 of the instruction text, and one with the
    register numbers replaced by R, so two builds that differ only in
    register allocation share the second. Addresses, encodings and the
    function's own name are left out."""
    sass = subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    out = {}
    for chunk in sass.split("Function : ")[1:]:
        name, _, body = chunk.partition("\n")
        m = re.search(r"assign_scan_kernelILi(\d)E(?:Lb([01])E)?E", name)
        if m is None or m.group(2) == "1":
            continue
        lines = [re.sub(r"/\*[^*]*\*/", "", ln).strip()
                 for ln in body.splitlines() if "/*" in ln and ";" in ln]
        text = "\n".join(lines)
        out[m.group(1)] = {
            "instructions": len(lines),
            "exact": hashlib.sha1(text.encode()).hexdigest()[:16],
            "registers_renamed": hashlib.sha1(
                re.sub(r"\bR\d+\b", "R", text).encode()).hexdigest()[:16]}
    return out


def device_times(torch, mask_call, scan_call, mask_calls=10, scan_calls=3) -> dict:
    """{kernel name: device us per launch} over a profiled window of
    mask and scan calls (main-path batch), after one warm-up call each."""
    from torch.profiler import ProfilerActivity, profile

    mask_call()
    scan_call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(mask_calls):
            mask_call()
        for _ in range(scan_calls):
            scan_call()
        torch.cuda.synchronize()
    times = {}
    for evt in prof.key_averages():
        total = getattr(evt, "self_device_time_total", None)
        if total is None:
            total = evt.self_cuda_time_total
        if total > 0 and "Memcpy" not in evt.key and "Memset" not in evt.key:
            name = evt.key.replace("(anonymous namespace)::", "").replace("void ", "")
            times[name.split("(")[0]] = total / evt.count
    return times


if __name__ == "__main__":
    sys.exit(main())
