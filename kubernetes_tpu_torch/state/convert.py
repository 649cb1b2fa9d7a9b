"""State carried across: host arrays -> this package's tensors on a device.

`state_from_numpy` and `batch_from_numpy` take any object whose attributes
are the ClusterState / PodBatch leaves as numpy arrays: this package's own
host encoders, or the reference package's state, so both packages can be
fed the same encoded inputs. Dtypes follow the CUDA kernels' needs:
- uint32 hashes and condition bits are bit-reinterpreted as int32 (the
  same reinterpretation the reference's Pallas kernel applies);
- float arrays are float32, bools stay bool, other integers become int32.

`rr` (uint32 in the reference) is carried as a Python int in [0, 2^32).

`victims_from_numpy` carries a VictimTable of numpy arrays (this package's
`preemption.build_victim_table`'s, or the reference package's) to a device.

`upload_blobs` carries a batch's two packed blobs (state.pod_batch
`pack_batch`) across, from this package's driver or from the reference
package's, and `host_blobs` allocates the driver's reusable host pair.
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


def victims_from_numpy(obj, device):
    """ops.preemption.VictimTable on `device` from any object with prio,
    req and ok numpy arrays (i32[N, S], f32[N, S, R], bool[N, S])."""
    from kubernetes_tpu_torch.ops.preemption import VictimTable

    return VictimTable(**{name: to_device(getattr(obj, name), device)
                          for name in ("prio", "req", "ok")})


def rr_from_numpy(rr) -> int:
    """The round-robin counter as a Python int, reduced mod 2^32."""
    return int(np.asarray(rr).astype(np.int64)) % (1 << 32)


def host_blobs(p: int, f_width: int, i_width: int,
               device) -> tuple[torch.Tensor, torch.Tensor]:
    """A reusable host pair (f32[p, F], i32[p, I]) for uploads to `device`,
    page-locked when `device` is a CUDA card so the copies run
    asynchronously."""
    pin = torch.device(device).type == "cuda"
    return (torch.empty((p, f_width), dtype=torch.float32, pin_memory=pin),
            torch.empty((p, i_width), dtype=torch.int32, pin_memory=pin))


def upload_blobs(fblob, iblob, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The f32 and i32 batch blobs on `device`, from CPU tensors or numpy
    arrays (the reference package's blobs too).

    On a CUDA device the copies are issued with non_blocking=True; from
    page-locked buffers (`host_blobs`) they run asynchronously on the
    current stream. The host buffers may be written again only after that
    stream has passed the copies: the driver reuses its pair only after the
    batch's readback has synchronized the stream. On the CPU the result is
    a copy, never a view of the host buffers."""
    dev = torch.device(device)
    out = []
    for blob, dtype in ((fblob, torch.float32), (iblob, torch.int32)):
        t = blob if isinstance(blob, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(blob))
        if t.dtype != dtype or t.dim() != 2:
            raise TypeError(f"blob of {t.dtype}[{tuple(t.shape)}], want a "
                            f"2-d {dtype}")
        if dev.type == "cuda":
            out.append(t.to(dev, non_blocking=True))
        else:
            out.append(t.to(dev, copy=True))
    return out[0], out[1]
