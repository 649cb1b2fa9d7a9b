"""State carried across: host arrays -> this package's tensors on a device.

`state_from_numpy` and `batch_from_numpy` take any object whose attributes
are the ClusterState / PodBatch leaves as numpy arrays: this package's own
host encoders, or the reference package's state, so both packages can be
fed the same encoded inputs. Dtypes follow the CUDA kernels' needs:
- uint32 hashes and condition bits are bit-reinterpreted as int32 (the
  same reinterpretation the reference's Pallas kernel applies);
- float arrays are float32, bools stay bool, other integers become int32.

`rr` (uint32 in the reference) is carried as a Python int in [0, 2^32).
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetes_tpu_torch.state.cluster_state import STATE_FIELDS, ClusterState
from kubernetes_tpu_torch.state.pod_batch import BATCH_FIELDS, PodBatch


def host_tensor(arr) -> torch.Tensor:
    """One host array as a CPU tensor in this package's device dtype."""
    a = np.asarray(arr)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.bool_:
        pass
    elif np.issubdtype(a.dtype, np.floating):
        a = a.astype(np.float32, copy=False)
    else:
        a = a.astype(np.int32, copy=False)
    return torch.from_numpy(np.ascontiguousarray(a))


def to_device(arr, device) -> torch.Tensor:
    """A copy on `device` (never a view of the host array, which the host
    mirror keeps mutating)."""
    return host_tensor(arr).to(device, copy=True)


def state_from_numpy(obj, device) -> ClusterState:
    return ClusterState(**{name: to_device(getattr(obj, name), device)
                           for name in STATE_FIELDS})


def batch_from_numpy(obj, device) -> PodBatch:
    return PodBatch(**{name: to_device(getattr(obj, name), device)
                       for name in BATCH_FIELDS})


def rr_from_numpy(rr) -> int:
    """The round-robin counter as a Python int, reduced mod 2^32."""
    return int(np.asarray(rr).astype(np.int64)) % (1 << 32)
