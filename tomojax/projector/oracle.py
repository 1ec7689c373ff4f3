"""Exact ray-tracing system-matrix oracle (numpy, test/CPU-parity use).

Functional re-implementation of the reference CPU projector generator
``parallelRay`` (reference tomofusion/cpu/utils/pytvlib.py:8-121): a
Siddon-style exact-intersection-length parallel-beam matrix, returned as a
scipy sparse matrix. The reference builds this in Python and feeds it to
the Eigen-based CPU engine (ctvlib.cpp:309-315); here its role is

* the *oracle* for unit-testing the Joseph projector pair (SURVEY.md §4
  recommends exactly this), and
* the exact operator behind the CPU-parity ART/SIRT configurations.

This is a clean-room reimplementation from the algorithm's math: rays at
unit spacing intersect the pixel grid; intersection-segment lengths are the
matrix weights; row index is ``angle * Nray + ray`` (angle-major, matching
the reference sinogram layout, cpu/utils/pytvlib.py:110).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def ray_matrix(n: int, angles_deg) -> sp.csr_matrix:
    """Build the (Nproj*Nray, N*N) exact parallel-beam matrix.

    Args:
      n: image side == number of rays (the reference fixes Nray = Nside,
         cpu/utils/pytvlib.py:10).
      angles_deg: projection angles in DEGREES (the reference converts
         inside, :34).
    """
    angles = np.asarray(angles_deg, dtype=np.float64).reshape(-1)
    nproj = angles.size
    half = n / 2.0
    # Ray offsets at unit spacing centered on the origin (:20-21).
    offsets = np.linspace(-(n - 1) / 2.0, (n - 1) / 2.0, n)
    # Grid lines (:23-24).
    grid = np.linspace(-half, half, n + 1)

    rows, cols, vals = [], [], []
    for i, ang_deg in enumerate(angles):
        ang = np.deg2rad(ang_deg)
        dx, dy = -np.sin(ang), np.cos(ang)  # ray direction
        if abs(dx) < 1e-10:
            dx = 0.0
        if abs(dy) < 1e-10:
            dy = 0.0
        ox_all = np.cos(ang) * offsets
        oy_all = np.sin(ang) * offsets
        ox_all[np.abs(ox_all) < 1e-8] = 0.0
        oy_all[np.abs(oy_all) < 1e-8] = 0.0

        for j in range(n):
            ox, oy = ox_all[j], oy_all[j]
            with np.errstate(all="ignore"):
                # Parameter values where the ray crosses vertical grid
                # lines (x = const) and horizontal ones (y = const).
                t_x = (grid - ox) / dx if dx != 0.0 else np.full(n + 1, np.inf)
                t_y = (grid - oy) / dy if dy != 0.0 else np.full(n + 1, np.inf)
            ts = np.concatenate([t_x, t_y])
            xs = np.concatenate([grid, ox + dx * t_y])
            ys = np.concatenate([oy + dy * t_x, grid])
            order = np.argsort(ts)
            xs, ys = xs[order], ys[order]
            keep = (
                (xs >= -half)
                & (xs <= half)
                & (ys >= -half)
                & (ys <= half)
                & np.isfinite(xs)
                & np.isfinite(ys)
            )
            xs, ys = xs[keep], ys[keep]
            if xs.size < 2:
                continue
            # Merge duplicate crossing points (:74-79).
            dup = (np.abs(np.diff(xs)) <= 1e-8) & (np.abs(np.diff(ys)) <= 1e-8)
            mask = np.concatenate([~dup, [True]])
            xs, ys = xs[mask], ys[mask]
            if xs.size < 2:
                continue
            # Rays grazing the top/right boundary are dropped (:88-92).
            if (dy == 0.0 and abs(oy - half) < 1e-15) or (
                dx == 0.0 and abs(ox - half) < 1e-15
            ):
                continue
            seg = np.sqrt(np.diff(xs) ** 2 + np.diff(ys) ** 2)
            mx = 0.5 * (xs[:-1] + xs[1:])
            my = 0.5 * (ys[:-1] + ys[1:])
            mx[np.abs(mx) < 1e-10] = 0.0
            my[np.abs(my) < 1e-10] = 0.0
            # Pixel index: row-major with row 0 at the TOP (max y), col 0
            # at min x (:101-103).
            pr = np.floor(half - my).astype(np.int64)
            pc = np.floor(mx + half).astype(np.int64)
            ok = (seg > 0) & (pr >= 0) & (pr < n) & (pc >= 0) & (pc < n)
            rows.append(np.full(ok.sum(), i * n + j, dtype=np.int64))
            cols.append((pr * n + pc)[ok])
            vals.append(seg[ok])

    rows = np.concatenate(rows) if rows else np.zeros(0, np.int64)
    cols = np.concatenate(cols) if cols else np.zeros(0, np.int64)
    vals = np.concatenate(vals) if vals else np.zeros(0, np.float64)
    return sp.csr_matrix(
        (vals, (rows, cols)), shape=(nproj * n, n * n), dtype=np.float64
    )


def fp_oracle(a: sp.csr_matrix, vol: np.ndarray) -> np.ndarray:
    """(Ns, N, N) -> (Ns, Nproj, Nray) via the exact matrix."""
    ns, n, _ = vol.shape
    nproj = a.shape[0] // n
    out = a @ vol.reshape(ns, n * n).T
    return out.T.reshape(ns, nproj, n)


def bp_oracle(a: sp.csr_matrix, sino: np.ndarray) -> np.ndarray:
    """(Ns, Nproj, Nray) -> (Ns, N, N) via the exact transpose."""
    ns = sino.shape[0]
    n = int(np.sqrt(a.shape[1]))
    out = a.T @ sino.reshape(ns, -1).T
    return out.T.reshape(ns, n, n)
