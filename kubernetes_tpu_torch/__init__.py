"""kubernetes_tpu_torch — the batch scheduler of kubernetes_tpu on PyTorch
and CUDA.

A second package beside `kubernetes_tpu` (the JAX reference). It mirrors
that package's module names so each counterpart is easy to find, keeps its
own copies of the pure-Python helpers it needs, and imports neither JAX nor
anything of `kubernetes_tpu`.

This slice carries the batch solver's main path: encode nodes and pending
pods into padded tensors (`state`), build the static (pods x nodes) mask
with a hand-written CUDA kernel (`ops.static_mask`), run the serial
assignment scan with a second one (`ops.assign_scan`), and commit the
resulting ledger (`state.statedb`), driven by `scheduler.Scheduler`.

Entry points run on `cuda` unless the caller passes `device="cpu"`; they
raise, and never fall back, when asked for `cuda` on a machine without a
card.
"""

__version__ = "0.1.0"
