"""Host-side volume analysis: a pod's volumes as interned atoms.

The reference's volume predicates walk per-pod volume lists with string
compares (NoDiskConflict predicates.go:100-195, MaxPDVolumeCountChecker
:215-320, VolumeZoneChecker :395-470, VolumeNodeChecker :1345). Here each
distinct identity becomes an integer atom of a small universe
(cluster_state.NodeTable): the node side carries per-atom counts, the pod
side per-atom rows, and the predicates (ops/predicates.py) are products
over them, or 64-bit words in the scan's EXT variant.

Atom grammars:
- conflict atoms (NoDiskConflict): GCE PD ("gce", pdName), AWS EBS ("aws",
  volumeID), iSCSI ("iscsi", iqn), RBD one atom a monitor ("rbd", monitor,
  pool, image), so that a shared monitor (haveSame, predicates.go:887) is
  a shared atom. Each carries a read-only flag; a conflict needs a
  read-write party, but for AWS EBS, which conflicts regardless
  (predicates.go:121-128), so EBS atoms are always read-write;
- attach atoms (MaxPDVolumeCount): (VolType, the cloud volume id), through
  the claim and its PV for a claim-backed volume. A claim not found gives
  one atom of its own, of type ANY, a pod and volume slot (the reference
  counts a random id toward every limit, predicates.go:240-268);
- zone terms (VolumeZone): a bound PV's zone and region labels, (key,
  value) terms of the selector universe the node must carry;
- volume node selectors (VolumeNode): a bound PV's node-affinity
  annotation, one interned selector whose node membership is evaluated on
  the host.

Resolution errors (a claim without a name, a claim not bound, a PV not
found for the zone and node checks) are the reference's error returns:
the predicate fails the pod on every node, through the batch's fail bits.
"""

from __future__ import annotations

import json

from kubernetes_tpu_torch.api.objects import PersistentVolume, Pod
from kubernetes_tpu_torch.state.context import EncodeContext
from kubernetes_tpu_torch.state.layout import TOPOLOGY_KEYS, VolType

ZONE_LABELS = (TOPOLOGY_KEYS[1], TOPOLOGY_KEYS[2])  # zone, region

# the PV annotation carrying alpha node affinity (the reference's
# v1.AlphaStorageNodeAffinityAnnotation)
NODE_AFFINITY_ANNOTATION = "volume.alpha.kubernetes.io/node-affinity"


class VolumeError(Exception):
    """An unresolvable volume reference: the analog of a predicate
    returning an error (the pod fails its scheduling attempt)."""


def conflict_atoms(volume: dict) -> list[tuple[tuple, bool]]:
    """[(atom, read_only)] of one raw v1 Volume (isVolumeConflict,
    predicates.go:100-147)."""
    gce = volume.get("gcePersistentDisk")
    if gce is not None:
        return [(("gce", gce.get("pdName", "")), bool(gce.get("readOnly")))]
    aws = volume.get("awsElasticBlockStore")
    if aws is not None:
        # EBS conflicts regardless of read-only (predicates.go:121-125)
        return [(("aws", aws.get("volumeID", "")), False)]
    iscsi = volume.get("iscsi")
    if iscsi is not None:
        return [(("iscsi", iscsi.get("iqn", "")), bool(iscsi.get("readOnly")))]
    rbd = volume.get("rbd")
    if rbd is not None:
        pool = rbd.get("pool") or "rbd"
        image = rbd.get("image", "")
        ro = bool(rbd.get("readOnly"))
        return [(("rbd", mon, pool, image), ro) for mon in rbd.get("monitors") or []]
    return []


def pod_conflict_atoms(pod: Pod) -> list[tuple[tuple, bool]]:
    return [atom for vol in pod.spec.volumes for atom in conflict_atoms(vol)]


_FILTERS = (
    (VolType.EBS, "awsElasticBlockStore", "volumeID"),
    (VolType.GCE, "gcePersistentDisk", "pdName"),
    (VolType.AZURE, "azureDisk", "diskName"),
)


def _direct_attach_atom(volume: dict) -> tuple[int, tuple] | None:
    for vtype, key, id_field in _FILTERS:
        src = volume.get(key)
        if src is not None:
            return vtype, (key, src.get(id_field, ""))
    return None


def _resolve_pvc(namespace: str, volume: dict, ctx: EncodeContext):
    """(the claim's PV or None, the claim's name) of a claim-backed
    volume. Raises VolumeError for a claim without a name or not bound;
    None for a claim or PV not found."""
    pvc_name = volume["persistentVolumeClaim"].get("claimName", "")
    if not pvc_name:
        raise VolumeError("PersistentVolumeClaim had no name")
    pvc = ctx.get_pvc(namespace, pvc_name)
    if pvc is None:
        return None, pvc_name
    if not pvc.volume_name:
        raise VolumeError(f"PersistentVolumeClaim is not bound: {pvc_name!r}")
    return ctx.get_pv(pvc.volume_name), pvc_name


def pod_attach_atoms(pod: Pod, ctx: EncodeContext,
                     permissive: bool = False) -> list[tuple[int, tuple]]:
    """The pod's distinct (VolType, atom) pairs for MaxPDVolumeCount.
    Raises VolumeError on the reference's error paths; with `permissive` a
    volume that errs is skipped instead (for a bound pod, whose broken
    claim must not take the node's whole attach row with it)."""
    atoms: dict[tuple, int] = {}
    for idx, vol in enumerate(pod.spec.volumes):
        direct = _direct_attach_atom(vol)
        if direct is not None:
            vtype, atom = direct
            atoms[atom] = vtype
            continue
        if "persistentVolumeClaim" not in vol:
            continue
        try:
            pv, pvc_name = _resolve_pvc(pod.metadata.namespace, vol, ctx)
        except VolumeError:
            if permissive:
                continue
            raise
        if pv is None:
            # not found: an atom of this pod and volume slot that counts
            # toward every limit
            atoms[("missing", pod.metadata.namespace, pvc_name,
                   pod.metadata.uid or pod.key, idx)] = VolType.ANY
            continue
        direct = _direct_attach_atom(pv.spec)
        if direct is not None:
            vtype, atom = direct
            atoms[atom] = vtype
    return [(vtype, atom) for atom, vtype in atoms.items()]


def pod_zone_terms(pod: Pod, ctx: EncodeContext) -> list[tuple[str, str]]:
    """(label key, value) of the bound PVs' zone and region labels
    (VolumeZoneChecker, predicates.go:430-470). Raises VolumeError where a
    claim does not resolve to a PV: VolumeZone treats every miss as an
    error (predicates.go:440-458)."""
    terms: list[tuple[str, str]] = []
    for vol in pod.spec.volumes:
        if "persistentVolumeClaim" not in vol:
            continue
        pv, pvc_name = _resolve_pvc(pod.metadata.namespace, vol, ctx)
        if pv is None:
            raise VolumeError(f"PersistentVolumeClaim or PV not found: {pvc_name!r}")
        terms.extend((k, v) for k, v in pv.metadata.labels.items() if k in ZONE_LABELS)
    return terms


def parse_volume_node_selector(pv: PersistentVolume) -> list | None:
    """The nodeSelectorTerms' matchExpressions of the PV's alpha
    node-affinity annotation, or None without one
    (GetStorageNodeAffinityFromAnnotation, pkg/volume/util.go)."""
    raw = pv.metadata.annotations.get(NODE_AFFINITY_ANNOTATION)
    if not raw:
        return None
    try:
        affinity = json.loads(raw)
    except ValueError as exc:
        raise VolumeError(f"bad node-affinity annotation on PV "
                          f"{pv.metadata.name!r}: {exc}") from exc
    required = (affinity or {}).get("requiredDuringSchedulingIgnoredDuringExecution")
    if not required:
        return None
    return [t.get("matchExpressions") or []
            for t in required.get("nodeSelectorTerms") or []]


def node_selector_canon(terms: list) -> str:
    """The interning key of a node selector (a list of OR-terms)."""
    return json.dumps(terms, sort_keys=True, separators=(",", ":"))


def node_selector_matches(terms: list, labels: dict[str, str]) -> bool:
    """OR over the terms, AND over a term's requirements; an empty term, or
    one with an invalid requirement, matches nothing
    (nodeMatchesNodeSelectorTerms, predicates.go:625-660)."""
    from kubernetes_tpu_torch.state.cluster_state import match_requirement
    from kubernetes_tpu_torch.state.pod_batch import _valid_requirement

    for exprs in terms:
        if not exprs or any(not _valid_requirement(e) for e in exprs):
            continue
        if all(match_requirement(labels, e.get("key", ""), e["operator"],
                                 tuple(e.get("values") or ())) for e in exprs):
            return True
    return False


def pod_volume_node_selectors(pod: Pod, ctx: EncodeContext) -> list[list]:
    """The node selectors the node must satisfy, one a bound PV that has
    one (NoVolumeNodeConflict); none while the feature gate is off
    (predicates.go:1355-1357)."""
    if not ctx.local_volumes_enabled:
        return []
    selectors: list[list] = []
    for vol in pod.spec.volumes:
        if "persistentVolumeClaim" not in vol:
            continue
        pv, pvc_name = _resolve_pvc(pod.metadata.namespace, vol, ctx)
        if pv is None:
            raise VolumeError(f"PersistentVolumeClaim or PV not found: {pvc_name!r}")
        terms = parse_volume_node_selector(pv)
        if terms is not None:
            selectors.append(terms)
    return selectors
