"""Pod-encoding equivalence cache.

Pods with identical scheduling-relevant specs encode to identical batch
rows (the reference scheduler's equivalence classes). Encoding a pod
(quantity parsing, FNV hashing of tolerations and nodeName, interning) is
the expensive host step, so each class is encoded once, straight into a
packed row (state.pod_batch.PackedRow), and that row is copied into the
batch blobs by array assignment.

The fingerprint covers exactly what this package's encoder reads:
container requests, limits presence (QoS) and host ports, nodeSelector,
tolerations, nodeName, priority, the namespace and labels (the spreading
entries and the pod-selector match row), the raw affinity and volumes (a
direct volume's atoms are interned ids, which never change), and the
controller reference. Every miss goes through the encoder. Images and
the gang annotations are read by nothing here and stay out: a gang
member's row carries no group (the driver writes the batch-local gang
columns after encoding), so it shares its class with a plain pod of the
same spec. Rows are stamped with
`NodeTable.pod_row_epoch` (a new pod-selector entry or avoid signature:
the match row of a class encoded before it lacks its column) and the
cache's `generation`, which the driver bumps on every Service or
controller event (the spreading entries depend on those objects). A
class's inter-pod columns hold ids its miss interned (selectors, carried
terms, topology slots), which never change, so they need no stamp of
their own. Pods
with claim-backed volumes are never cached (their rows resolve through
mutable claim state), and no row is cached while the context carries
ServiceAntiAffinity (its totals follow the bound pods). At most
MAX_ENTRIES classes are kept, least recently used evicted first.
"""

from __future__ import annotations

import json
from collections import OrderedDict

import numpy as np

from kubernetes_tpu_torch.api.objects import Pod
from kubernetes_tpu_torch.state.cluster_state import NodeTable, pod_controller_ref
from kubernetes_tpu_torch.state.context import EMPTY_CONTEXT, EncodeContext
from kubernetes_tpu_torch.state.layout import Capacities
from kubernetes_tpu_torch.state.pod_batch import PackedRow, encode_pod_into

# classes kept; the least recently used is evicted first
MAX_ENTRIES = 4096


def cacheable(pod: Pod) -> bool:
    """Claim-backed volumes resolve through mutable PVC/PV state: never
    cache those rows."""
    return not any("persistentVolumeClaim" in v for v in pod.spec.volumes)


def pod_fingerprint(pod: Pod) -> tuple:
    """Hashable equivalence class of everything the encoder reads."""
    spec = pod.spec
    return (
        tuple((tuple(sorted(c.requests.items())), tuple(c.host_ports),
               bool(c.requests or c.limits))
              for c in spec.containers),
        tuple(sorted(spec.node_selector.items())),
        tuple((t.key, t.operator, t.value, t.effect) for t in spec.tolerations),
        spec.node_name,
        spec.priority,
        pod.metadata.namespace,
        tuple(sorted(pod.metadata.labels.items())),
        pod_controller_ref(pod),
        json.dumps(spec.affinity, sort_keys=True) if spec.affinity else "",
        json.dumps(spec.volumes, sort_keys=True) if spec.volumes else "",
    )


class EncodeCache:
    def __init__(self, caps: Capacities, table: NodeTable,
                 ctx: EncodeContext | None = None):
        self.caps = caps
        self.table = table
        self.ctx = ctx or EMPTY_CONTEXT
        # bumped by the driver on every Service or controller event
        self.generation = 0
        self._packed: OrderedDict[tuple, tuple[np.ndarray, np.ndarray]] = OrderedDict()
        self._scratch = PackedRow(caps)
        self.hits = 0
        self.misses = 0

    def _must_reencode(self, pod: Pod) -> bool:
        return not cacheable(pod) or self.ctx.service_anti

    def _key(self, pod: Pod) -> tuple:
        return (pod_fingerprint(pod), self.table.pod_row_epoch, self.generation)

    def _encode(self, pod: Pod) -> tuple[np.ndarray, np.ndarray]:
        """The pod's packed row, encoded now: the scratch row's buffers,
        valid until the next encode."""
        encode_pod_into(self._scratch.batch, 0, pod, self.caps, self.table,
                        self.ctx)
        return self._scratch.pack()

    def _packed_row(self, pod: Pod) -> tuple[np.ndarray, np.ndarray]:
        """The shared packed row of the pod's class, encoded on first
        sight."""
        fp = self._key(pod)
        packed = self._packed.get(fp)
        if packed is None:
            self.misses += 1
            frow, irow = self._encode(pod)
            packed = self._packed[fp] = (frow.copy(), irow.copy())
            if len(self._packed) > MAX_ENTRIES:
                self._packed.popitem(last=False)
        else:
            self.hits += 1
            self._packed.move_to_end(fp)
        return packed

    def encode_packed_into(self, fblob: np.ndarray, iblob: np.ndarray,
                           i: int, pod: Pod) -> None:
        """Encode `pod` into row i of the host blobs: a class hit is two
        row copies; a miss, or a pod with a claim-backed volume, encodes."""
        if self._must_reencode(pod):
            frow, irow = self._encode(pod)
        else:
            frow, irow = self._packed_row(pod)
        fblob[i] = frow
        iblob[i] = irow
