"""Exact EMD transport plans through the C++ network simplex (csrc/emd.cpp).

A copy of kpdiff_tpu/native/emd.py's solver binding, without its silent
fallback: `exact_emd_plan` builds the library with g++ at first use into
`kpdiff_tpu_torch/_build/libemd.so`, loads it with ctypes, and raises if
either fails. `linprog_plan` (scipy's HiGHS) is the solver's plain version,
which the tests hold the library against. Marginals are uniform (1/n).
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "emd.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
MAX_ITERS = 100000
_lib = None
_lock = threading.Lock()


def build() -> Path:
    """Compile csrc/emd.cpp into _build/libemd.so unless it is current;
    raises with the compiler's output on failure."""
    lib = BUILD_DIR / "libemd.so"
    if lib.exists() and lib.stat().st_mtime >= SOURCE.stat().st_mtime:
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the exact OT solver needs a C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libemd.so.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, "-O3", "-fPIC", "-std=c++17", "-Wall", "-shared", "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            lib.emd_plan.restype = ctypes.c_int
            lib.emd_plan.argtypes = [ctypes.c_int, ctypes.c_int, f64, f64, f64, f64, ctypes.c_int]
            _lib = lib
    return _lib


def exact_emd_plan(cost: np.ndarray) -> np.ndarray:
    """Exact transport plan (n, m) float64 for uniform marginals; cost (n, m)."""
    cost = np.ascontiguousarray(cost, np.float64)
    if cost.ndim != 2 or 0 in cost.shape:
        raise ValueError(f"cost must be a non-empty (n, m) matrix, got shape {cost.shape}")
    n, m = cost.shape
    plan = np.zeros((n, m), np.float64)
    err = _load().emd_plan(n, m, cost, np.full(n, 1.0 / n), np.full(m, 1.0 / m), plan, MAX_ITERS)
    if err != 0:
        raise RuntimeError(f"emd_plan failed ({err})")
    return plan


def linprog_plan(cost: np.ndarray) -> np.ndarray:
    """The same plan as a linear program solved by scipy's HiGHS (plain version)."""
    from scipy.optimize import linprog
    from scipy.sparse import coo_matrix

    cost = np.asarray(cost, np.float64)
    n, m = cost.shape
    k = np.arange(n * m)
    rows = np.concatenate([k // m, n + k % m])
    A_eq = coo_matrix((np.ones(2 * n * m), (rows, np.concatenate([k, k]))), shape=(n + m, n * m))
    b_eq = np.concatenate([np.full(n, 1.0 / n), np.full(m, 1.0 / m)])
    # the last constraint is redundant; dropping it keeps HiGHS stable
    res = linprog(cost.ravel(), A_eq=A_eq.tocsr()[:-1], b_eq=b_eq[:-1], bounds=(0, None), method="highs")
    if not res.success:
        raise RuntimeError(f"linprog EMD failed: {res.message}")
    return res.x.reshape(n, m)
