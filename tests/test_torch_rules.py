"""kubernetes_tpu_torch house rules: its entry points raise (never fall back
to the CPU) when asked for a CUDA device on a machine without one, nothing
is built without nvcc, and neither the package nor chip_smoke.py imports
JAX, Flax or the reference package."""

import ast
import os
import shutil
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)
try:
    torch.set_num_interop_threads(1)
except RuntimeError:  # the interop pool already started in this process
    pass

from kubernetes_tpu_torch.perf import harness  # noqa: E402
from kubernetes_tpu_torch.scheduler import Scheduler  # noqa: E402
from kubernetes_tpu_torch.state import Capacities  # noqa: E402
from kubernetes_tpu_torch.state.statedb import StateDB  # noqa: E402
from kubernetes_tpu_torch.utils.device import resolve_device  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "kubernetes_tpu")
CAPS = Capacities(num_nodes=64, batch_pods=8)


@pytest.mark.parametrize("entry", [
    lambda: resolve_device(),
    lambda: resolve_device("cuda"),
    lambda: Scheduler(),
    lambda: Scheduler(CAPS, device="cuda:0"),
    lambda: StateDB(CAPS),
    lambda: harness.run_throughput(8, 8),
    lambda: harness.run_device_solve(8, batch_pods=8, iters=1),
], ids=["resolve", "resolve-cuda", "scheduler", "scheduler-cuda0", "statedb",
        "run_throughput", "run_device_solve"])
def test_entry_points_raise_without_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()


def test_kernel_build_needs_nvcc(monkeypatch):
    from kubernetes_tpu_torch.native import build

    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is present")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(FileNotFoundError, match="nvcc"):
        build.nvcc_path()


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            func = node.func
            name = func.attr if isinstance(func, ast.Attribute) else getattr(func, "id", "")
            if name in ("import_module", "__import__"):
                yield node.lineno, node.args[0].value


def test_port_imports_nothing_of_jax_or_the_reference_package():
    files = sorted((REPO / "kubernetes_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "kernel_times.py",
              REPO / "host_times.py"]
    assert len(files) > 20
    bad = [f"{path.relative_to(REPO)}:{line}: {mod}"
           for path in files for line, mod in _imported_modules(path)
           if mod.split(".")[0] in FORBIDDEN]
    assert bad == []
