"""Build and load the package's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface (pointers, ints, a stream; it
returns `cudaGetLastError()`), so it compiles with `nvcc` alone, without
PyTorch's headers, in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -shared -Xcompiler -fPIC -o _build/<name>-<digest>.so csrc/<name>.cu

The library lands in `kubernetes_tpu_torch/_build/` under a name that
carries a digest of its source and flags, so an edited source is rebuilt
and a finished build is reused. `build()` starts one `nvcc` per source, all
at once; a source listed in `PARTS` (the scan, whose 80 kernel instances
take minutes in one process; the EXT variant's 16 are a part of their
own) is compiled as that many objects, one `nvcc
-c -DKTPU_PART=k` each, started with the rest, and linked into its one
library: part k holds the C entries the source marks with it, and so the
kernel instances they launch. Nothing is built at import time: the first
launch builds what it needs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
KERNELS = ("static_mask", "assign_scan", "preemption")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")
# sources compiled in parts (KTPU_PART = 0 .. parts - 1), linked into one library
PARTS = {"assign_scan": 5}

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, nvcc on PATH, or the
    toolkit's default location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise FileNotFoundError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels are built on the machine with the card")


def library_path(name: str) -> Path:
    source = (SRC_DIR / f"{name}.cu").read_bytes()
    flags = " ".join(NVCC_FLAGS) + f" parts={PARTS.get(name, 1)}"
    digest = hashlib.sha1(source + flags.encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=KERNELS) -> dict[str, float]:
    """Compile every listed kernel not yet built, one `nvcc` per source (per
    part of a source in PARTS, then one link), all started together. Returns {name: seconds} for those compiled; raises
    with the compiler's output if any fails. The `-Xptxas=-v` report
    (registers, shared memory, spills) is kept beside each library as
    `<library>.log`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()

    def start(cmd):
        return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)

    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        src = str(SRC_DIR / f"{name}.cu")
        if name in PARTS:
            objs = [tmp.with_name(f"{tmp.name}.{k}.o") for k in range(PARTS[name])]
            compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
            parts = [start([nvcc, *compile_flags, "-c", f"-DKTPU_PART={k}", "-o", str(o), src])
                     for k, o in enumerate(objs)]
            link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]
        else:
            objs, parts, link = [], [start([nvcc, *NVCC_FLAGS, "-o", str(tmp), src])], None
        procs[name] = (parts, objs, link, tmp, out)
    seconds = {}
    failed = []
    for name, (parts, objs, link, tmp, out) in procs.items():
        logs = [proc.communicate()[0] for proc in parts]
        codes = [proc.returncode for proc in parts]
        if link is not None and not any(codes):
            proc = start(link)
            logs.append(proc.communicate()[0])
            codes.append(proc.returncode)
        for o in objs:
            o.unlink(missing_ok=True)
        seconds[name] = time.perf_counter() - t0
        log = "".join(logs)
        if any(codes):
            failed.append(f"{name}: nvcc exited {max(codes)}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        out.with_name(out.name + ".log").write_text(log)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """The compiler's report for a built kernel (empty if none kept)."""
    log = library_path(name).with_name(library_path(name).name + ".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
