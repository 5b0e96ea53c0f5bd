"""Native (C++) host kernels.

The accelerator owns all tensor math; the native library accelerates the sequential
host-side setup path — currently the inventory-space reduction
(``csrc/storage_host_ops.cpp``), the analogue of the reference's natively
compiled ``StorageHelper``/constraint machinery (MKL-backed .NET, SURVEY.md
§2.2).  Loading is best-effort: if the shared library is absent it is built
with ``g++`` on first use; if that fails, callers fall back to the pure-NumPy
implementations transparently.
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger("storage_tpu.native")

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
_SRC = _REPO_ROOT / "csrc" / "storage_host_ops.cpp"
_LIB_PATH = Path(__file__).resolve().parent / "libstorage_host_ops.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _build() -> bool:
    if not _SRC.exists():
        return False
    # Compile to a temp file and atomically rename into place so a concurrent
    # process can never dlopen a partially written library.
    tmp_path = _LIB_PATH.with_name(f".{_LIB_PATH.name}.{os.getpid()}.tmp")
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
        "-o", str(tmp_path), str(_SRC),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.rename(tmp_path, _LIB_PATH)
        return True
    except (subprocess.SubprocessError, FileNotFoundError, OSError) as exc:
        logger.info("Native build failed (%s); using NumPy fallback.", exc)
        try:
            tmp_path.unlink(missing_ok=True)
        except OSError:
            pass
        return False


def load() -> Optional[ctypes.CDLL]:
    """Load (building if necessary) the native library, or None."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            if not _LIB_PATH.exists():
                if not _build():
                    _load_failed = True
                    return None
            lib = ctypes.CDLL(str(_LIB_PATH))
            lib.stpu_abi_version.restype = ctypes.c_int
            if lib.stpu_abi_version() != 1:
                raise OSError("ABI version mismatch")
            lib.stpu_inventory_space.restype = ctypes.c_int
            lib.stpu_inventory_space.argtypes = [
                ctypes.POINTER(ctypes.c_double),  # pillars
                ctypes.POINTER(ctypes.c_int32),  # pillar_counts
                ctypes.c_int32,  # max_pillars
                ctypes.c_int32,  # n_steps
                ctypes.c_int32,  # interp_kind
                ctypes.POINTER(ctypes.c_double),  # min_inv
                ctypes.POINTER(ctypes.c_double),  # max_inv
                ctypes.POINTER(ctypes.c_double),  # loss
                ctypes.c_double,  # start_inventory
                ctypes.c_int32,  # must_be_empty
                ctypes.POINTER(ctypes.c_double),  # out_min
                ctypes.POINTER(ctypes.c_double),  # out_max
            ]
            _lib = lib
        except (OSError, AttributeError, ValueError) as exc:
            # AttributeError: a stale/foreign .so missing the stpu_* symbols —
            # degrade to the NumPy fallback rather than crash the valuation.
            logger.info("Native library unavailable (%s); using NumPy fallback.", exc)
            _load_failed = True
    return _lib


def native_available() -> bool:
    return load() is not None


def inventory_space_native(
    pillar_tables,
    interp_kind: int,
    min_inv: np.ndarray,
    max_inv: np.ndarray,
    loss: np.ndarray,
    starting_inventory: float,
    must_be_empty_at_end: bool,
):
    """Native inventory-space reduction.

    Returns ``(min, max)`` arrays, or ``None`` if the library is unavailable.
    Raises :class:`InventoryConstraintsCannotBeFulfilledError` on infeasible
    configurations, matching the NumPy implementation.
    """
    lib = load()
    if lib is None:
        return None
    from ..exceptions import InventoryConstraintsCannotBeFulfilledError

    n = len(pillar_tables)
    max_pillars = max(t.shape[0] for t in pillar_tables)
    pillars = np.empty((n, max_pillars, 3), dtype=np.float64)
    counts = np.empty(n, dtype=np.int32)
    for k, t in enumerate(pillar_tables):
        counts[k] = t.shape[0]
        pillars[k, : t.shape[0]] = t
        pillars[k, t.shape[0]:] = t[-1]

    min_inv = np.ascontiguousarray(min_inv, dtype=np.float64)
    max_inv = np.ascontiguousarray(max_inv, dtype=np.float64)
    loss = np.ascontiguousarray(loss, dtype=np.float64)
    out_min = np.empty(n + 1, dtype=np.float64)
    out_max = np.empty(n + 1, dtype=np.float64)

    def ptr(arr, typ=ctypes.c_double):
        return arr.ctypes.data_as(ctypes.POINTER(typ))

    status = lib.stpu_inventory_space(
        ptr(pillars), ptr(counts, ctypes.c_int32),
        np.int32(max_pillars), np.int32(n), np.int32(interp_kind),
        ptr(min_inv), ptr(max_inv), ptr(loss),
        ctypes.c_double(float(starting_inventory)),
        np.int32(1 if must_be_empty_at_end else 0),
        ptr(out_min), ptr(out_max),
    )
    if status == 1:
        raise InventoryConstraintsCannotBeFulfilledError()
    if status != 0:
        return None  # defensive: fall back to NumPy on bad args
    return out_min, out_max
