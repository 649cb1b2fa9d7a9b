"""Kernel 1: the fused static feasibility mask, bool[P, N].

Counterpart of kubernetes_tpu/ops/pallas_kernels.py::fused_static_mask:
node validity, hard node conditions, MemoryPressure for BestEffort pods,
the nodeSelector count test, the hard-taint toleration test and the
spec.nodeName pin, for every (pod, node) pair in one pass. The CUDA source
is csrc/static_mask.cu (its header gives the design and the bound).

`static_mask` is the wrapper: on CUDA tensors it launches the kernel (and
counts the launch in `static_mask.launches`), on CPU tensors it computes
`static_mask_plain`, the same function in plain PyTorch. The kernel packs
its four matching operands into bit sets; `pack_bits_plain` is that
packing's layout in plain PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from kubernetes_tpu_torch.state.cluster_state import ClusterState
from kubernetes_tpu_torch.state.layout import Condition
from kubernetes_tpu_torch.utils.device import check_tensor

HARD_BITS = (Condition.NOT_READY | Condition.NETWORK_UNAVAILABLE
             | Condition.OUT_OF_DISK | Condition.DISK_PRESSURE
             | Condition.UNSCHEDULABLE)
INVALID_ROW = -2147483648  # int32 sign bit: an invalid (padding) node row


def node_bits(state: ClusterState) -> torch.Tensor:
    """i32[N]: condition bits with the invalid-row marker in the sign bit."""
    invalid = torch.full_like(state.conditions, INVALID_ROW)
    return state.conditions | torch.where(
        state.valid, torch.zeros_like(invalid), invalid)


def static_mask_plain(sel_onehot, sel_count, untol, best_effort, pod_lo,
                      pod_hi, sel_member, hard_member, bits, name_lo,
                      name_hi) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the CPU path and the
    reference the kernel is held against on the card)."""
    sat = torch.matmul(sel_onehot, sel_member.T)
    ok = sat >= sel_count[:, None]
    ok &= torch.matmul(untol, hard_member.T) == 0.0
    bits = bits[None, :]
    ok &= (bits & HARD_BITS) == 0
    ok &= ~(((bits & Condition.MEMORY_PRESSURE) != 0) & best_effort[:, None])
    ok &= (bits & INVALID_ROW) == 0
    lo = pod_lo[:, None]
    match = (lo == name_lo[None, :]) & (pod_hi[:, None] == name_hi[None, :])
    ok &= match | (lo == 0)
    return ok


def pack_bits_plain(x: torch.Tensor) -> torch.Tensor:
    """i32[R, ceil(K/32)] from [R, K]: bit b of word w is `x[:, 32w + b] !=
    0`, zero past column K. The layout in which the kernel packs each
    matching operand (its selector words, then its taint words)."""
    rows, k = x.shape
    words = -(-k // 32)
    bits = torch.nn.functional.pad(x != 0, (0, 32 * words - k))
    shifts = torch.arange(32, dtype=torch.int64, device=x.device)
    packed = (bits.reshape(rows, words, 32).to(torch.int64) << shifts).sum(-1)
    return torch.where(packed >= 2**31, packed - 2**32, packed).to(torch.int32)


_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def static_mask(sel_onehot, sel_count, untol, best_effort, pod_lo, pod_hi,
                sel_member, hard_member, bits, name_lo, name_hi) -> torch.Tensor:
    """bool[P, N] fused static mask.

    Pod side: sel_onehot f32[P, US], sel_count f32[P], untol f32[P, UT],
    best_effort bool[P], pod_lo / pod_hi i32[P] (nodeName hash lanes, 0 =
    unpinned). Node side: sel_member f32[N, US], hard_member f32[N, UT],
    bits i32[N] (`node_bits`), name_lo / name_hi i32[N].

    The kernel reads sel_onehot, untol, sel_member and hard_member as bit
    sets (`pack_bits_plain`): it equals `static_mask_plain` when their
    entries are 0 or 1, which the encoders guarantee (one-hot selector
    terms, membership rows, untol = 1 - tolerated)."""
    p, us = sel_onehot.shape
    n = sel_member.shape[0]
    ut = untol.shape[1]
    dev = sel_onehot.device
    f32, i32 = torch.float32, torch.int32
    for args in (("sel_onehot", sel_onehot, f32, (p, us)),
                 ("sel_count", sel_count, f32, (p,)),
                 ("untol", untol, f32, (p, ut)),
                 ("best_effort", best_effort, torch.bool, (p,)),
                 ("pod_lo", pod_lo, i32, (p,)), ("pod_hi", pod_hi, i32, (p,)),
                 ("sel_member", sel_member, f32, (n, us)),
                 ("hard_member", hard_member, f32, (n, ut)),
                 ("bits", bits, i32, (n,)),
                 ("name_lo", name_lo, i32, (n,)),
                 ("name_hi", name_hi, i32, (n,))):
        check_tensor(*args, dev)
    if dev.type == "cpu":
        return static_mask_plain(sel_onehot, sel_count, untol, best_effort,
                                 pod_lo, pod_hi, sel_member, hard_member,
                                 bits, name_lo, name_hi)
    if dev.type != "cuda":
        raise ValueError(f"static_mask: unsupported device {dev}")
    from kubernetes_tpu_torch.native.build import load

    fn = load("static_mask").ktpu_static_mask
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    out = torch.empty((p, n), dtype=torch.bool, device=dev)
    # kernel scratch: the packed pod rows, then the packed node rows
    words = torch.empty((p + n, -(-us // 32) + -(-ut // 32)), dtype=i32,
                        device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(sel_onehot.data_ptr(), sel_count.data_ptr(), untol.data_ptr(),
                 best_effort.data_ptr(), pod_lo.data_ptr(), pod_hi.data_ptr(),
                 sel_member.data_ptr(), hard_member.data_ptr(), bits.data_ptr(),
                 name_lo.data_ptr(), name_hi.data_ptr(), out.data_ptr(),
                 words.data_ptr(), p, n, us, ut, stream)
    if err != 0:
        raise RuntimeError(f"static_mask kernel launch failed: CUDA error {err}")
    static_mask.launches += 1
    return out


static_mask.launches = 0
