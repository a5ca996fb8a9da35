"""Build, load and count the package's hand-written CUDA kernels.

Each kernel source is ``csrc/<name>.cu`` with a plain C entry point.  At
first use it is compiled with ``nvcc`` for ``sm_90a`` into a shared library
under ``csrc/_build/`` (named by a hash of the source, so an edited source
rebuilds) and loaded with :mod:`ctypes`.  Nothing is built at import: the
CPU tests import every module on a host without ``nvcc``.

``build_logs`` keeps each source's compiler output from this process's
builds, with ptxas's report of every kernel's registers, shared memory
and spills (``-Xptxas=-v``).

``launches`` counts kernel launches by name.  A wrapper adds one exactly
where it launches its kernel, so a run can show that its main path went
through the kernel.  Under CUDA-graph capture that launch is recorded, not
run: ``captured`` counts those recorded launches, and ``replayed`` the
kernels each replay of a captured graph launches
(``backends.device.CapturedProgram`` and ``CapturedStep`` add them at
capture and at every replay), so the launches that ran on the card are
``launches - captured + replayed``.
``routes`` counts the calls on a CUDA tensor that a wrapper's resolver
handed its kernel on copies, by ``<kernel>.<route>`` (for example
``flash_attention.kernel:padded``): the views and head dims the kernel
does not read as given.  :func:`reset_launches` zeroes all four.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

from ..utils.env import env_str

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# kernel name -> launches since the last reset_launches()
launches: Dict[str, int] = {}
# kernel name -> launches recorded by CUDA-graph captures since the last
# reset (counted in ``launches`` too, but run only by the replays)
captured: Dict[str, int] = {}
# kernel name -> launches by CUDA-graph replays since the last reset
replayed: Dict[str, int] = {}
# "<kernel>.<route>" -> CUDA calls a resolver handed the kernel on copies
routes: Dict[str, int] = {}
# source name -> nvcc's output of the build this process ran
build_logs: Dict[str, str] = {}
_loaded: Dict[str, ctypes.CDLL] = {}


def ran(name: str) -> int:
    """Launches of kernel ``name`` that ran on the card since the last
    reset: the eager ones and the replays', not the captures' records."""
    return (launches.get(name, 0) - captured.get(name, 0)
            + replayed.get(name, 0))


def reset_launches() -> None:
    for counts in (launches, captured, replayed, routes):
        for name in counts:
            counts[name] = 0


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``CUDA_HOME`` or
    ``/usr/local/cuda``.  Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (env_str("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build only on a host with the "
        "CUDA toolkit"
    )


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(*names: str) -> float:
    """Compile ``csrc/<name>.cu`` for each name not built already, one
    ``nvcc`` per source, all started together.  Returns the wall seconds
    spent; raises with the compiler's output when any build fails."""
    todo = [n for n in dict.fromkeys(names) if not library_path(n).exists()]
    if not todo:
        return 0.0
    # dls-lint: allow(DET001) build wall seconds, reported only
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)  # atomic: concurrent builders never race
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    # dls-lint: allow(DET001) build wall seconds, reported only
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
