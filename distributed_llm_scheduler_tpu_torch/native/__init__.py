"""Native engine loader: builds + binds the C++ list-scheduling engine.

The engine (``engine.cpp``, the JAX package's source byte for byte) is
compiled lazily with the system ``g++`` into a content-addressed shared
library under ``_build/`` the first time it's needed (no pip/pybind11
dependency — plain ctypes over a C ABI).  A build that fails raises: no
caller runs the pure-Python policy in its place.  Transient failures (a
compile timeout, an OS error) are retried on later calls, up to
``_MAX_TRANSIENT_ATTEMPTS``; a real compile error is kept and raised again.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

from ..utils.config import ConfigError, env_str

_HERE = Path(__file__).resolve().parent
_SOURCE = _HERE / "engine.cpp"
_BUILD_DIR = _HERE / "_build"
_ABI_VERSION = 3

_lock = threading.Lock()
_engine: Optional[ctypes.CDLL] = None
_load_error: Optional[str] = None
_transient_attempts = 0
_MAX_TRANSIENT_ATTEMPTS = 3

POLICY_IDS = {
    "roundrobin": 0,
    "dfs": 1,
    "greedy": 2,
    "critical": 3,
    "mru": 4,
    "heft": 5,
    "pipeline": 6,
    "pack": 7,
    "refine": 8,
}


def _so_path() -> Path:
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:12]
    return _BUILD_DIR / f"engine_{digest}.so"


def _compile(so: Path) -> None:
    _BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [
        env_str("CXX", "g++"),
        "-O3", "-std=c++17", "-fPIC", "-shared",
        str(_SOURCE), "-o", str(tmp),
    ]
    try:
        subprocess.run(
            cmd, check=True, capture_output=True, text=True, timeout=120
        )
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
            FileNotFoundError) as e:
        tmp.unlink(missing_ok=True)  # partial output from a failed compile
        detail = getattr(e, "stderr", "") or str(e)
        raise ConfigError(f"native engine build failed: {detail}") from e
    os.replace(tmp, so)  # atomic: concurrent builders race benignly


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.dls_schedule.restype = ctypes.c_int
    lib.dls_schedule.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        f64p, f64p, f64p,      # task_mem, task_time, out_gb
        i32p, i32p,            # dep_off, dep_ids
        i32p, i32p,            # par_off, par_ids
        f64p, f64p, f64p,      # param_gb, node_mem, node_speed
        f64p,                  # link3
        i32p,                  # group_ids (group policies; NULL otherwise)
        i32p, i32p,            # node_rank, group_rank (refine; NULL else)
        i32p, i32p, i32p,      # out_assign, out_order, out_n_assigned
    ]
    lib.dls_abi_version.restype = ctypes.c_int
    lib.dls_abi_version.argtypes = []
    return lib


def _is_transient(e: BaseException) -> bool:
    """Failures worth retrying on a later call: compile timeouts (loaded
    machine), OS-level hiccups (disk full, OOM-killed g++ surfaces as
    CalledProcessError with empty stderr or as OSError).  A real compile
    error (non-empty stderr) is deterministic and cached permanently."""
    cause = e.__cause__
    if isinstance(cause, subprocess.TimeoutExpired) or isinstance(
        cause, OSError
    ):
        return True
    if isinstance(cause, subprocess.CalledProcessError):
        return not (cause.stderr or "").strip()
    return isinstance(e, OSError)


def load_engine() -> ctypes.CDLL:
    """The bound engine library; compiles on first call.  Raises on failure.

    Transient build failures (timeout/OS errors) are retried on later
    calls, up to ``_MAX_TRANSIENT_ATTEMPTS``, instead of permanently
    disabling the engine for the process.
    """
    global _engine, _load_error, _transient_attempts
    with _lock:
        if _engine is not None:
            return _engine
        if _load_error is not None:
            raise ConfigError(_load_error)
        so = _so_path()
        try:
            if not so.exists():
                _compile(so)
            lib = _bind(ctypes.CDLL(str(so)))
            got = lib.dls_abi_version()
            if got != _ABI_VERSION:
                raise ConfigError(
                    f"native engine ABI {got} != expected {_ABI_VERSION}"
                )
            _engine = lib
            return lib
        except Exception as e:
            _transient_attempts += 1
            if (
                _is_transient(e)
                and _transient_attempts < _MAX_TRANSIENT_ATTEMPTS
            ):
                raise  # leave _load_error unset: next call retries
            _load_error = str(e)  # deterministic (or retries exhausted)
            raise


def load_error() -> Optional[str]:
    return _load_error
