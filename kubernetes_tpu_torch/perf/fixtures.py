"""Synthetic cluster fixtures (the scheduler_perf strategy analog): uniform
fake nodes and templated pods at any scale, as v1 objects of this package.
They build the same objects as the reference package's fixtures of the same
name, for the options this package's solver carries; `prefer_taint_every`,
`class_tolerations` and `class_preferred` are this package's own (the tt_na
traffic, perf/harness.py), and so are cycled cpu requests and priorities
(the preemption traffic; the reference sets priorities through
PriorityClasses and its admission plugin, which this package lacks), and
periodic extra allocatable, extra requests and host ports (the gpu_ports
traffic), and periodic volumes (the volumes traffic)."""

from __future__ import annotations

from typing import Sequence

from kubernetes_tpu_torch.api.objects import Node, Pod, Service
from kubernetes_tpu_torch.gang import GROUP_MIN_ANNOTATION, GROUP_NAME_ANNOTATION


def _periodic(i: int, entries) -> dict:
    """The quantities of the (every, offset, {name: quantity}) entries with
    i % every == offset, later entries last."""
    out: dict = {}
    for every, offset, extra in entries:
        if i % every == offset:
            out.update(extra)
    return out


def make_nodes(n: int, cpu: str = "4", memory: str = "8Gi", pods: str = "110",
               zones: int = 3, labels_per_node: int = 0,
               taint_every: int = 0, prefer_taint_every: int = 0,
               extra_allocatable: tuple = ()) -> list[Node]:
    """Uniform ready nodes; optional zone spread, filler labels, periodic
    NoSchedule taints, periodic `dedicated=batch:PreferNoSchedule` taints
    (every `prefer_taint_every`-th node from node 0), and periodic extra
    allocatable: `extra_allocatable` entries (every, offset, {resource:
    quantity}) add to node i where i % every == offset."""
    out = []
    for i in range(n):
        labels = {
            "kubernetes.io/hostname": f"node-{i}",
            "failure-domain.beta.kubernetes.io/zone": f"zone-{i % max(zones, 1)}",
            "failure-domain.beta.kubernetes.io/region": "region-1",
        }
        for j in range(labels_per_node):
            labels[f"label-{j}"] = f"value-{(i + j) % 7}"
        taints = []
        if taint_every and i % taint_every == 0:
            taints = [{"key": "dedicated", "value": "special",
                       "effect": "NoSchedule"}]
        if prefer_taint_every and i % prefer_taint_every == 0:
            taints.append({"key": "dedicated", "value": "batch",
                           "effect": "PreferNoSchedule"})
        out.append(Node.from_dict({
            "metadata": {"name": f"node-{i}", "labels": labels},
            "spec": {"taints": taints},
            "status": {
                "allocatable": {"cpu": cpu, "memory": memory, "pods": pods,
                                **_periodic(i, extra_allocatable)},
                "conditions": [{"type": "Ready", "status": "True"}],
            },
        }))
    return out


def make_pods(n: int, cpu: str | Sequence[str] = "100m", memory: str = "250Mi",
              name_prefix: str = "pod", selector_every: int = 0,
              tolerate: bool = False, namespace: str = "default",
              app_groups: int = 0, anti_affinity_every: int = 0,
              pref_affinity_every: int = 0, gang_size: int = 0,
              gang_min: int | None = None,
              class_tolerations: tuple = (),
              class_preferred: tuple = (),
              priority: int | Sequence[int] = 0,
              extra_requests: tuple = (), host_ports: tuple = (),
              volumes: tuple = ()) -> list[Pod]:
    """Templated pending pods (the basic scheduler_perf pod spec: small cpu
    and memory requests); optional periodic nodeSelector, a toleration of
    the fixtures' NoSchedule taint, and labels app=app-{i % app_groups}
    (the targets of `make_services`). With app groups, every
    `anti_affinity_every`-th pod has required hostname anti-affinity
    against its own group and every `pref_affinity_every`-th a weight-10
    preferred zone affinity toward it (the inter-pod-heavy shape).
    `gang_size` groups consecutive pods into all-or-nothing gangs of that
    size (quorum `gang_min`, default the full size); keep n divisible by
    gang_size, or the trailing group is below its quorum. With app groups,
    `class_tolerations[g]` and `class_preferred[g]` (lists of v1
    tolerations and of preferred node-affinity terms, one a group) are
    added to the pods of group g. `cpu` and `priority` may be sequences,
    cycled over the pods (pod i takes entry i % len); a nonzero priority is
    written to spec.priority. `extra_requests` entries (every, offset,
    {resource: quantity}) add requests to pod i where i % every == offset,
    `host_ports` entries (every, offset, port) a containerPort with
    that hostPort, and `volumes` entries (every, offset, fn) the v1 Volume
    fn(i) (fn(i) None: none) to pod i, in the entries' order."""
    cpus = [cpu] if isinstance(cpu, str) else list(cpu)
    prios = [priority] if isinstance(priority, int) else list(priority)
    out = []
    for i in range(n):
        meta: dict = {"name": f"{name_prefix}-{i}", "namespace": namespace}
        if app_groups:
            meta["labels"] = {"app": f"app-{i % app_groups}"}
        if gang_size:
            meta["annotations"] = {
                GROUP_NAME_ANNOTATION: f"{name_prefix}-gang-{i // gang_size}",
                GROUP_MIN_ANNOTATION: str(gang_min or gang_size)}
        spec: dict = {"containers": [{
            "name": "app",
            "image": "k8s.gcr.io/pause:3.0",
            "resources": {"requests": {"cpu": cpus[i % len(cpus)],
                                       "memory": memory,
                                       **_periodic(i, extra_requests)}},
        }]}
        ports = [port for every, offset, port in host_ports if i % every == offset]
        if ports:
            spec["containers"][0]["ports"] = [
                {"containerPort": port, "hostPort": port} for port in ports]
        vols = [fn(i) for every, offset, fn in volumes if i % every == offset]
        if any(v is not None for v in vols):
            spec["volumes"] = [v for v in vols if v is not None]
        if prios[i % len(prios)]:
            spec["priority"] = prios[i % len(prios)]
        if selector_every and i % selector_every == 0:
            spec["nodeSelector"] = {"label-0": f"value-{i % 7}"}
        if tolerate:
            spec["tolerations"] = [{"key": "dedicated", "operator": "Exists"}]
        if class_tolerations and class_tolerations[i % app_groups]:
            spec["tolerations"] = (spec.get("tolerations", [])
                                   + list(class_tolerations[i % app_groups]))
        affinity: dict = {}
        if class_preferred and class_preferred[i % app_groups]:
            affinity["nodeAffinity"] = {
                "preferredDuringSchedulingIgnoredDuringExecution":
                    list(class_preferred[i % app_groups])}
        sel = {"matchLabels": {"app": f"app-{i % app_groups}"}} \
            if app_groups else None
        if anti_affinity_every and sel and i % anti_affinity_every == 0:
            affinity["podAntiAffinity"] = {
                "requiredDuringSchedulingIgnoredDuringExecution": [{
                    "labelSelector": sel,
                    "topologyKey": "kubernetes.io/hostname"}]}
        if pref_affinity_every and sel and i % pref_affinity_every == 0:
            affinity["podAffinity"] = {
                "preferredDuringSchedulingIgnoredDuringExecution": [{
                    "weight": 10,
                    "podAffinityTerm": {
                        "labelSelector": sel,
                        "topologyKey":
                            "failure-domain.beta.kubernetes.io/zone"}}]}
        if affinity:
            spec["affinity"] = affinity
        out.append(Pod.from_dict({"metadata": meta, "spec": spec}))
    return out


def make_services(n: int, namespace: str = "default") -> list[Service]:
    """Services selecting the app groups of make_pods(app_groups=n)."""
    return [Service.from_dict({
        "metadata": {"name": f"svc-{i}", "namespace": namespace},
        "spec": {"selector": {"app": f"app-{i}"}}})
        for i in range(n)]
