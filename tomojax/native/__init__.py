"""Native CPU engine: ctypes bindings + build-on-demand for tomonative.cpp.

This is the framework's native runtime layer, mirroring the role of the
reference's C++ CPU engine (tomofusion/cpu/utils/ctvlib.cpp + the
Python-side parallelRay generator): exact Siddon measurement matrix,
OpenMP sparse FP/BP, row-action ART, Landweber/Cimmino SIRT, Poisson
noise. The accelerator path never needs it — it exists for (a) fast exact oracles
in tests, (b) CPU-parity reconstruction (`CpuEngine`), (c) host-side
pre/post-processing in streaming mode.

The shared library is compiled on first use with g++ -O3 -fopenmp and
cached next to the source; set TOMOJAX_NATIVE=0 to disable (pure-numpy
fallbacks via tomojax.projector.oracle remain available).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "tomonative.cpp")
_SO = os.path.join(_HERE, "libtomonative.so")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def build(force: bool = False) -> str:
    """Compile the native library if needed; returns the .so path."""
    with _LOCK:
        if force or (not os.path.exists(_SO)) or (
            os.path.getmtime(_SO) < os.path.getmtime(_SRC)
        ):
            cmd = [
                "g++", "-O3", "-march=native", "-shared", "-fPIC",
                "-fopenmp", "-std=c++17", _SRC, "-o", _SO,
            ]
            subprocess.run(cmd, check=True, capture_output=True)
    return _SO


def lib() -> ctypes.CDLL:
    """Load (building if necessary) and return the typed CDLL."""
    global _LIB
    if _LIB is not None:
        return _LIB
    if os.environ.get("TOMOJAX_NATIVE", "1") == "0":
        raise RuntimeError("native engine disabled via TOMOJAX_NATIVE=0")
    build()
    l = ctypes.CDLL(_SO)
    l.build_ray_matrix.restype = ctypes.c_int64
    l.build_ray_matrix.argtypes = [
        ctypes.c_int32, _f64p, ctypes.c_int32, ctypes.c_int64,
        _i64p, _i64p, _f32p,
    ]
    l.csr_fp.restype = None
    l.csr_fp.argtypes = [
        _i64p, _i64p, _f32p, ctypes.c_int64, ctypes.c_int64, _f32p,
        ctypes.c_int64, _f32p,
    ]
    l.csr_bp.restype = None
    l.csr_bp.argtypes = l.csr_fp.argtypes
    l.csr_row_norms_sq.restype = None
    l.csr_row_norms_sq.argtypes = [_i64p, _f32p, ctypes.c_int64, _f32p]
    l.csr_col_sums.restype = None
    l.csr_col_sums.argtypes = [
        _i64p, _i64p, _f32p, ctypes.c_int64, ctypes.c_int64, _f32p,
    ]
    l.art_sweep.restype = None
    l.art_sweep.argtypes = [
        _i64p, _i64p, _f32p, _f32p, ctypes.c_int64, ctypes.c_int64,
        _i64p, ctypes.c_int64, ctypes.c_float, _f32p, ctypes.c_int64, _f32p,
    ]
    l.sirt_sweep.restype = None
    l.sirt_sweep.argtypes = [
        _i64p, _i64p, _f32p, _f32p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_float, ctypes.c_int32, _f32p, ctypes.c_int64, _f32p, _f32p,
    ]
    l.sirt_astra_sweep.restype = None
    l.sirt_astra_sweep.argtypes = [
        _i64p, _i64p, _f32p, _f32p, _f32p, ctypes.c_int64, ctypes.c_int64,
        _f32p, ctypes.c_int64, _f32p, _f32p, _f32p,
    ]
    l.tv_value_3d.restype = ctypes.c_double
    l.tv_value_3d.argtypes = [
        _f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
    ]
    l.tv_gd_3d.restype = None
    l.tv_gd_3d.argtypes = [
        _f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_float, _f32p,
    ]
    l.poisson_noise.restype = None
    l.poisson_noise.argtypes = [
        _f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
    ]
    l.omp_threads.restype = ctypes.c_int32
    l.omp_threads.argtypes = []
    _LIB = l
    return l


def ray_matrix(n: int, angles_deg) -> "scipy.sparse.csr_matrix":
    """Exact Siddon matrix via the native builder (fast path of
    tomojax.projector.oracle.ray_matrix)."""
    import scipy.sparse as sp

    angles = np.ascontiguousarray(angles_deg, np.float64).reshape(-1)
    nproj = len(angles)
    cap = int(3 * n) * n * nproj
    rows = np.empty(cap, np.int64)
    cols = np.empty(cap, np.int64)
    vals = np.empty(cap, np.float32)
    nnz = lib().build_ray_matrix(n, angles, nproj, cap, rows, cols, vals)
    if nnz < 0:
        raise RuntimeError("ray matrix buffer overflow")
    return sp.csr_matrix(
        (vals[:nnz], (rows[:nnz], cols[:nnz])),
        shape=(nproj * n, n * n),
        dtype=np.float32,
    )


class CpuEngine:
    """Exact-matrix CPU reconstructor mirroring the reference ctvlib API
    (load_A / ART / randART / SIRT / cimminoSIRT / data_distance / rmse —
    ctvlib.cpp + cpu/utils/pytvlib.py dispatch)."""

    def __init__(self, nslice: int, n: int, angles_deg):
        self.nslice, self.n = int(nslice), int(n)
        self.angles = np.asarray(angles_deg, np.float64).reshape(-1)
        self.A = ray_matrix(self.n, self.angles)
        self.nrow, self.ncol = self.A.shape
        self._indptr = np.ascontiguousarray(self.A.indptr, np.int64)
        self._indices = np.ascontiguousarray(self.A.indices, np.int64)
        self._data = np.ascontiguousarray(self.A.data, np.float32)
        self._row_nsq = np.empty(self.nrow, np.float32)
        lib().csr_row_norms_sq(self._indptr, self._data, self.nrow, self._row_nsq)
        self.x = np.zeros((self.nslice, self.ncol), np.float32)
        self.b = np.zeros((self.nslice, self.nrow), np.float32)
        # Lipschitz = max(A^T (A 1)) (ctvlib.cpp:194-202)
        ones = np.ones((1, self.ncol), np.float32)
        self.lipschitz = float(self.bp(self.fp(ones)).max())
        self._rng = np.random.default_rng(0)

    # ------------------------------------------------------------- data --
    def set_tilt_series(self, series: np.ndarray):
        """(Nslice, Nray, Nangles) reference layout -> internal rows."""
        ns, nray, na = series.shape
        assert ns == self.nslice and nray == self.n and na == len(self.angles)
        for s in range(ns):
            self.b[s] = series[s].T.ravel()

    def set_sinogram(self, b: np.ndarray):
        """(Nslice, Nangles, Nray)."""
        self.b = np.ascontiguousarray(
            b.reshape(self.nslice, self.nrow), np.float32
        )

    # -------------------------------------------------------- operators --
    def fp(self, x=None) -> np.ndarray:
        x = self.x if x is None else np.ascontiguousarray(x, np.float32)
        out = np.empty((x.shape[0], self.nrow), np.float32)
        lib().csr_fp(self._indptr, self._indices, self._data, self.nrow,
                     self.ncol, x, x.shape[0], out)
        return out

    def bp(self, y) -> np.ndarray:
        y = np.ascontiguousarray(y, np.float32)
        out = np.empty((y.shape[0], self.ncol), np.float32)
        lib().csr_bp(self._indptr, self._indices, self._data, self.nrow,
                     self.ncol, y, y.shape[0], out)
        return out

    # --------------------------------------------------------- solvers --
    def art(self, beta: float = 1.0, random_order: bool = False):
        order = np.arange(self.nrow, dtype=np.int64)
        if random_order:
            order = self._rng.permutation(self.nrow).astype(np.int64)
        lib().art_sweep(self._indptr, self._indices, self._data,
                        self._row_nsq, self.nrow, self.ncol, order,
                        len(order), np.float32(beta), self.b, self.nslice,
                        self.x)
        return self

    def rand_art(self, beta: float = 1.0):
        return self.art(beta, random_order=True)

    def sirt(self, beta: float | None = None, n_iter: int = 1,
             cimmino: bool = False):
        """Landweber (beta defaults to 1/L) or Cimmino SIRT (beta
        defaults to 1 — the row-norm weighting self-normalizes,
        ctvlib.cpp:245-251)."""
        if beta is None:
            beta = 1.0 if cimmino else 1.0 / self.lipschitz
        scratch = np.empty((self.nslice, self.nrow), np.float32)
        for _ in range(n_iter):
            lib().sirt_sweep(self._indptr, self._indices, self._data,
                             self._row_nsq, self.nrow, self.ncol,
                             np.float32(beta), 1 if cimmino else 0,
                             self.b, self.nslice, self.x, scratch)
        return self

    def sirt_astra(self, n_iter: int = 1):
        """ASTRA-weighted SIRT x <- clamp0(x + C A^T R (b - Ax)) with
        R/C = inverse row/col sums — the flavor the reference GPU engine
        runs per slice (tomoengine.cpp:181-205, ASTRA CCudaSirtAlgorithm
        with min-constraint 0). This is the exact-matrix oracle for the
        JAX `sirt_sweep(variant='astra')` and the FISTA gradient step."""
        if not hasattr(self, "_inv_row"):
            row_sums = np.asarray(self.A.sum(axis=1)).ravel().astype(np.float32)
            col_sums = np.asarray(self.A.sum(axis=0)).ravel().astype(np.float32)
            self._inv_row = np.where(row_sums > 1e-6, 1.0 / np.maximum(row_sums, 1e-6), 0.0).astype(np.float32)
            self._inv_col = np.where(col_sums > 1e-6, 1.0 / np.maximum(col_sums, 1e-6), 0.0).astype(np.float32)
        sr = np.empty((self.nslice, self.nrow), np.float32)
        sc = np.empty((self.nslice, self.ncol), np.float32)
        for _ in range(n_iter):
            lib().sirt_astra_sweep(self._indptr, self._indices, self._data,
                                   self._inv_row, self._inv_col, self.nrow,
                                   self.ncol, self.b, self.nslice, self.x,
                                   sr, sc)
        return self

    def update_proj_angles(self, angles_deg):
        """Grow/replace the measurement operator for a new angle set
        (dynamic acquisition; ctvlib.cpp:317-333 rebuilds/extends the
        sparse A and re-derives weights). Existing measurement rows are
        preserved for angles that stay prefix-identical; b is resized to
        the new row count (new rows zero until data arrives)."""
        old_b, old_nrow = self.b, self.nrow
        old_angles = self.angles
        self.angles = np.asarray(angles_deg, np.float64).reshape(-1)
        self.A = ray_matrix(self.n, self.angles)
        self.nrow, self.ncol = self.A.shape
        self._indptr = np.ascontiguousarray(self.A.indptr, np.int64)
        self._indices = np.ascontiguousarray(self.A.indices, np.int64)
        self._data = np.ascontiguousarray(self.A.data, np.float32)
        self._row_nsq = np.empty(self.nrow, np.float32)
        lib().csr_row_norms_sq(self._indptr, self._data, self.nrow,
                               self._row_nsq)
        for attr in ("_inv_row", "_inv_col"):
            if hasattr(self, attr):
                delattr(self, attr)
        ones = np.ones((1, self.ncol), np.float32)
        self.lipschitz = float(self.bp(self.fp(ones)).max())
        self.b = np.zeros((self.nslice, self.nrow), np.float32)
        n_keep = min(len(old_angles), len(self.angles))
        if np.array_equal(old_angles[:n_keep], self.angles[:n_keep]):
            keep = min(old_nrow, self.nrow)
            self.b[:, :keep] = old_b[:, :keep]
        return self

    # ------------------------------------------------------------- TV --
    def tv(self) -> float:
        """Isotropic TV value, periodic BCs, eps=1e-8 (ctvlib.cpp:336-367
        intended math — the reference's uninitialized `float tv;`
        reduction accumulator is not replicated)."""
        vol = np.ascontiguousarray(self.get_recon(), np.float32)
        return float(lib().tv_value_3d(vol, self.nslice, self.n, self.n))

    def tv_gd(self, ng: int, dpocs: float):
        """`ng` normalized TV-subgradient steps + positivity
        (ctvlib.cpp:406-462 intended math; the gradient norm is reset
        every step — the reference's `tv_norm` carries over, UB)."""
        vol = np.ascontiguousarray(self.get_recon(), np.float32)
        scratch = np.empty(vol.size, np.float32)
        lib().tv_gd_3d(vol.reshape(-1), 1, self.nslice, self.n, self.n,
                       int(ng), np.float32(dpocs), scratch)
        self.set_recon(vol)
        return self

    # --------------------------------------------------------- metrics --
    def data_distance(self) -> float:
        return float(np.linalg.norm(self.fp() - self.b))

    def rmse(self, ground_truth) -> float:
        gt = np.asarray(ground_truth, np.float32).reshape(self.x.shape)
        return float(np.sqrt(np.mean((self.x - gt) ** 2)))

    def get_recon(self) -> np.ndarray:
        return self.x.reshape(self.nslice, self.n, self.n)

    def set_recon(self, vol: np.ndarray):
        self.x = np.ascontiguousarray(
            vol.reshape(self.nslice, self.ncol), np.float32
        )

    def positivity(self):
        np.maximum(self.x, 0.0, out=self.x)
        return self

    def poisson_noise(self, n_counts: int, seed: int = 0):
        lib().poisson_noise(self.b, self.b.size, int(n_counts), int(seed))
        return self
