#!/usr/bin/env python3
"""Time `Scheduler.schedule` end to end on the kinds of pending traffic a
tree carries (two, three with SelectorSpread, four with inter-pod
affinity, five with gang groups, six with SelectorSpread and inter-pod
affinity in one batch, seven with TaintToleration and NodeAffinity, eight
with gang groups that also need SelectorSpread and inter-pod affinity,
nine with GPU, storage and host-port requests), for comparing two trees of
the repository on one card.

    python3 host_times.py [--root DIR] [--reps K]

Imports `kubernetes_tpu_torch` from DIR (default: this file's directory),
so `--root` can point at an unpacked older commit: its kernels are built
from its own sources and its Scheduler places the same pods on the same
15,000 nodes (3 zones, padded to N=16384, batches of P=4096):

- one_class: chip_smoke.py's main-path backlog, 30,000 `make_pods` pods
  with one spec (one equivalence class);
- many_classes: 30,000 pods whose memory requests all differ
  (chip_smoke.py `many_class_pod_dicts`), so an encode cache misses on
  every pod;
- spread, where the tree's Scheduler has `add_service`: the reference
  bench's bench[spread], 30,000 pods in 16 app groups with 16 Services
  selecting them;
- interpod, where the tree's `make_pods` takes `anti_affinity_every`: the
  reference bench's bench[interpod], 8,192 pods in 8 app groups with
  hostname anti-affinity on every 16th and zone affinity on every 2nd, on
  its own 5,000 nodes in 3 zones (padded to N=8192, batches of P=1365);
- gang, where the tree's `make_pods` takes `gang_size`: the reference
  bench's bench[gang], 24,576 pods in 3,072 all-or-nothing groups of 8, on
  its own 50,000 nodes in 3 zones (padded to N=65536, batches of P=4096);
- spread_interpod, where the tree's scan has the spread+interpod build:
  bench[spread]'s 30,000 pods in 16 app groups with its 16 Services,
  carrying bench[interpod]'s terms (hostname anti-affinity on every 16th
  pod, zone affinity on every 2nd; chip_smoke.py `SI_MIX`);
- tt_na, where the tree's harness has `TT_NA_PODS`: the 15,000 nodes with
  one filler label and dedicated=batch:PreferNoSchedule on every 8th,
  30,000 pods in 16 app groups, the even ones tolerating the taint, each
  preferring a zone and the odd ones a label value too (perf/harness.py
  `TT_NA_NODES`, `TT_NA_PODS`);
- gang_spread_interpod, where the tree's harness has
  `GANG_SPREAD_INTERPOD_PODS`: spread_interpod's 15,000 nodes and 16
  Services, 24,576 pods of its mix in 3,072 all-or-nothing groups of 8 (6
  batches of P=4096);
- gpu_ports, where the tree's harness has `gpu_ports_cluster`: the 15,000
  nodes, every 4th with 8 GPUs and every one 100Gi of scratch, a bound pod
  with host port 8080 accounted on every 10th; 30,000 pods of 100m / 250Mi,
  every 4th asking a GPU, others 1Gi of scratch or 512Mi of overlay, some
  host port 8080 or 9100 (perf/harness.py `GPU_PORTS_NODES`,
  `GPU_PORTS_PODS`).

Each traffic runs K times (default 2), each on a fresh Scheduler after the
kernels are built and warmed. The script collects garbage before each
clock starts, for every tree alike, and reads each tree's own per-batch
timers. Prints one JSON line: the card (nvidia-smi name and power limit),
the root, and for each run pods/s, the whole run in ms, the tree's
`encode_seconds` and `solve_seconds` per batch in ms (a tree defines its
encode window itself), the remainder (the run less both), and the cache's
hits and misses where the tree has a cache. Exits non-zero without a CUDA
device or when a run leaves a pod unplaced.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def run(torch, sched, pods) -> dict:
    cache = getattr(sched, "encode_cache", None)
    hits0, misses0 = (cache.hits, cache.misses) if cache else (None, None)
    gc.collect()
    t0 = time.perf_counter()
    placed = sched.schedule(pods)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if sum(v is not None for v in placed.values()) != len(pods):
        raise AssertionError(f"{len(pods) - sum(v is not None for v in placed.values())}"
                             f" of {len(pods)} pods unplaced")
    enc, sol = sched.encode_seconds, sched.solve_seconds
    return {"pods_per_sec": len(pods) / seconds, "ms": 1e3 * seconds,
            "batches": len(enc),
            "ms_encode_per_batch": 1e3 * sum(enc) / len(enc),
            "ms_per_solve": 1e3 * sum(sol) / len(sol),
            "remainder_ms": 1e3 * (seconds - sum(enc) - sum(sol)),
            "cache_hits": cache.hits - hits0 if cache else None,
            "cache_misses": cache.misses - misses0 if cache else None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--reps", type=int, default=2)
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("host_times: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, str(opts.root.resolve()))
    from kubernetes_tpu_torch.api.objects import Pod
    from kubernetes_tpu_torch.models.policy import DEFAULT_POLICY
    from kubernetes_tpu_torch.native.build import build
    from kubernetes_tpu_torch.ops import assign_scan as scan_module
    from kubernetes_tpu_torch.perf import fixtures, harness
    from kubernetes_tpu_torch.perf.fixtures import make_nodes, make_pods
    from kubernetes_tpu_torch.perf.harness import default_caps, warm
    from kubernetes_tpu_torch.scheduler import Scheduler

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    build()
    caps = default_caps(smoke.HEADLINE_NODES, smoke.HEADLINE_PODS)
    warm(caps, DEFAULT_POLICY, dev)
    nodes = make_nodes(smoke.HEADLINE_NODES, zones=3)
    # name -> (caps, nodes, pods, services)
    traffic = {
        "one_class": (caps, nodes, make_pods(smoke.HEADLINE_PODS), ()),
        "many_classes": (caps, nodes, [Pod.from_dict(d) for d in
                                       smoke.many_class_pod_dicts(smoke.HEADLINE_PODS)],
                         ()),
    }
    if hasattr(Scheduler, "add_service"):
        traffic["spread"] = (caps, nodes, make_pods(smoke.HEADLINE_PODS,
                                                    app_groups=smoke.SPREAD_GROUPS),
                             fixtures.make_services(smoke.SPREAD_GROUPS))
        warm(caps, DEFAULT_POLICY, dev, n_services=smoke.SPREAD_GROUPS)
    if "anti_affinity_every" in inspect.signature(make_pods).parameters:
        ip_caps = default_caps(smoke.INTERPOD_NODES, smoke.INTERPOD_PODS)
        traffic["interpod"] = (ip_caps, make_nodes(smoke.INTERPOD_NODES, zones=3),
                               make_pods(smoke.INTERPOD_PODS, **smoke.INTERPOD_MIX),
                               ())
        warm(ip_caps, DEFAULT_POLICY, dev, pod_kwargs=smoke.INTERPOD_MIX)
    if "gang_size" in inspect.signature(make_pods).parameters:
        gang_caps = default_caps(smoke.GANG_NODES, smoke.GANG_PODS)
        traffic["gang"] = (gang_caps, make_nodes(smoke.GANG_NODES, zones=3),
                           make_pods(smoke.GANG_PODS, gang_size=smoke.GANG_SIZE), ())
        warm(gang_caps, DEFAULT_POLICY, dev, pod_kwargs={"gang_size": smoke.GANG_SIZE})
    if hasattr(scan_module, "assign_scan_spread_interpod"):
        traffic["spread_interpod"] = (caps, nodes,
                                      make_pods(smoke.HEADLINE_PODS, **smoke.SI_MIX),
                                      fixtures.make_services(smoke.SPREAD_GROUPS))
        warm(caps, DEFAULT_POLICY, dev, n_services=smoke.SPREAD_GROUPS,
             pod_kwargs=smoke.SI_MIX)
    if hasattr(harness, "TT_NA_PODS"):
        traffic["tt_na"] = (caps, make_nodes(smoke.HEADLINE_NODES, **harness.TT_NA_NODES),
                            make_pods(smoke.HEADLINE_PODS, **harness.TT_NA_PODS), ())
        warm(caps, DEFAULT_POLICY, dev, pod_kwargs=harness.TT_NA_PODS)
    if hasattr(harness, "GANG_SPREAD_INTERPOD_PODS"):
        gsi_caps = default_caps(smoke.HEADLINE_NODES, smoke.GSI_PODS)
        traffic["gang_spread_interpod"] = (
            gsi_caps, nodes, make_pods(smoke.GSI_PODS, **harness.GANG_SPREAD_INTERPOD_PODS),
            fixtures.make_services(smoke.SPREAD_GROUPS))
        warm(gsi_caps, DEFAULT_POLICY, dev, n_services=smoke.SPREAD_GROUPS,
             pod_kwargs=harness.GANG_SPREAD_INTERPOD_PODS)
    if hasattr(harness, "gpu_ports_cluster"):
        # (no node list: each run builds the cell's cluster, bound pods and all)
        traffic["gpu_ports"] = (caps, None,
                                make_pods(smoke.HEADLINE_PODS, **harness.GPU_PORTS_PODS), ())
        warm(caps, DEFAULT_POLICY, dev, pod_kwargs=harness.GPU_PORTS_PODS)
    out = {"nvidia_smi": smi.splitlines()[0], "root": str(opts.root.resolve())}
    for name, (caps_, nodes_, pods, services) in traffic.items():
        out[name] = []
        for _ in range(opts.reps):
            if nodes_ is None:
                sched = harness.gpu_ports_cluster(smoke.HEADLINE_NODES, caps_, dev)
            else:
                sched = Scheduler(caps_, device=dev)
                sched.add_nodes(nodes_)
            for svc in services:
                sched.add_service(svc)
            out[name].append(run(torch, sched, pods))
            del sched
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
