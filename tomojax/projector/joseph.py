"""Batched Joseph (driving-axis, linearly-interpolated) projector pair.

This is the batched replacement for ASTRA's 2D parallel-beam CUDA
forward/back projectors that power every algorithm in the reference
(reference tomofusion/gpu/utils/tomoengine.cpp:109-127 forward,
:279-291 backward, consumed per-slice from a host loop). Here the whole
``(Nslice, N, N)`` volume is projected in one XLA program; the slice axis is
a pure batch axis, so it shards trivially over a device mesh (z-slab
data-parallelism, the counterpart of the reference's MPI slab split,
mpi_astra_ctvlib.cpp:53-58).

Math
----
For angle ``theta`` the Joseph forward projector steps along the dominant
axis of the ray direction and linearly interpolates along the other:

* row-driven (``|cos| >= |sin|``): for each image row ``r`` interpolate the
  row at column coordinate ``c_pos = (t_j - y_r sin)/cos + (N-1)/2``, sum
  over rows and scale by ``1/|cos|``.
* col-driven: transpose roles (interpolate rows for each column, scale by
  ``1/|sin|``).

Writing the weight of pixel ``(r, c)`` for detector bin ``j`` in both
branches gives the *same* closed form

    ``W[a, j, r, c] = hat((j - J*)/D_a) / D_a``,
    ``J*[a, r, c]  = x_c cos_a + y_r sin_a + (Nray-1)/2``,
    ``D_a = max(|cos_a|, |sin_a|)``,

with ``hat(u) = max(0, 1-|u|)``. Since the window ``|j - J*| < D_a <= 1``
contains at most the two integers ``floor(J*)`` and ``floor(J*)+1``, the
backprojector is a branch-free 2-point *gather* from the sinogram — no
scatter — and is the **exact transpose** of the forward projector by
construction. Adjoint consistency (``<Ax, y> == <x, A^T y>``) is enforced
by tests (reference has this only implicitly via ASTRA; SURVEY.md §7.3
flags it as the determinant of iterative convergence parity).

Forms
-----
Three forms compute the same operator (``config.projector_mode``):

* ``gather`` (this module): both operators transpose to a **slice-last**
  layout (``(step, interp, Ns)`` / ``(angle, det, Ns)``) so every 2-point
  gather fetches a contiguous ``(Ns,)`` vector, and scan one step/angle at
  a time so XLA fuses gather+weight+accumulate without materializing
  ``(angles, det, N, Ns)`` intermediates.
* ``mxu`` (this module): the same weights as a dense banded matrix,
  contracted with ``dot_general`` at ``config.mxu_precision``.
* ``triton`` (projector/triton_joseph.py): the gather form as GPU kernels
  that keep the accumulator in registers; the GPU default.

Both operators are wrapped in ``jax.custom_vjp`` so autodiff through
``fp``/``bp`` uses the matched partner instead of differentiating the
gather graph.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tomojax.geometry import Geometry
from tomojax import config as tjconfig


def _hat_weights(pos, n_valid):
    """Linear-interpolation indices and weights with out-of-range masking.

    Returns (i0, i1, w0, w1) where contributions at indices outside
    [0, n_valid) get zero weight. Indices are clipped so they are always
    safe to gather with.
    """
    f = jnp.floor(pos)
    frac = pos - f
    i0 = f.astype(jnp.int32)
    i1 = i0 + 1
    w0 = jnp.where((i0 >= 0) & (i0 < n_valid), 1.0 - frac, 0.0)
    w1 = jnp.where((i1 >= 0) & (i1 < n_valid), frac, 0.0)
    i0 = jnp.clip(i0, 0, n_valid - 1)
    i1 = jnp.clip(i1, 0, n_valid - 1)
    return i0, i1, w0, w1


def _fp_branch(x, cosv, sinv, row_driven: bool, nray: int):
    """Forward-project one driving-axis branch.

    x: (Ns, N, N) volume slices (slice-first, public layout).
    cosv/sinv: (Na,) trig of this branch's angles (numpy constants).
    Returns (Ns, Na, Nray).
    """
    ns, n, _ = x.shape
    na = cosv.shape[0]
    if na == 0:
        return jnp.zeros((ns, 0, nray), x.dtype)

    if row_driven:
        # step over rows r, interpolate along columns:
        #   c_pos(a, j, r) = (t_j - y_r sin_a) / cos_a + (N-1)/2
        img = x.transpose(1, 2, 0)  # (step=r, interp=c, Ns)
        denom = cosv
        shear = -sinv / cosv  # coefficient of y_r
    else:
        # step over columns c, interpolate along rows:
        #   r_pos(a, j, c) = (N-1)/2 - (t_j - x_c cos_a) / sin_a
        img = x.transpose(2, 1, 0)  # (step=c, interp=r, Ns)
        denom = sinv
        shear = cosv / sinv  # coefficient of x_c

    scale = jnp.asarray(1.0 / np.abs(denom), x.dtype)
    inv_d = jnp.asarray(1.0 / denom, jnp.float32)
    shear = jnp.asarray(shear, jnp.float32)
    tj = jnp.arange(nray, dtype=jnp.float32) - (nray - 1) / 2.0
    ctr = (n - 1) / 2.0
    steps = jnp.arange(n, dtype=jnp.float32)

    def body(acc, args):
        img_k, s_idx = args  # (N, Ns), scalar step index
        coord = (ctr - s_idx) if row_driven else (s_idx - ctr)
        if row_driven:
            pos = tj[None, :] * inv_d[:, None] + coord * shear[:, None] + ctr
        else:
            pos = ctr - tj[None, :] * inv_d[:, None] + coord * shear[:, None]
        i0, i1, w0, w1 = _hat_weights(pos, n)  # (Na, Nt)
        # gather contiguous (Ns,) lane vectors: g[a, j, :] = img_k[i, :]
        g0 = jnp.take_along_axis(
            img_k[None, None, :, :], i0[:, :, None, None], axis=2
        )[:, :, 0, :]
        g1 = jnp.take_along_axis(
            img_k[None, None, :, :], i1[:, :, None, None], axis=2
        )[:, :, 0, :]
        return acc + g0 * w0[..., None] + g1 * w1[..., None], None

    acc0 = jnp.zeros((na, nray, ns), x.dtype)
    acc, _ = jax.lax.scan(body, acc0, (img, steps))
    return (acc * scale[:, None, None]).transpose(2, 0, 1)


def _fp_branch_mxu(x, cosv, sinv, row_driven: bool, nray: int):
    """Matrix variant of `_fp_branch`: per step, build the 2-banded
    interpolation matrix W[a, j, i] = hat(pos(a, j) - i) and contract it
    against the step plane — the irregular gather becomes a dense
    (Na*Nt, N) @ (N, Ns) matmul (N/2 wasted multiply-adds per useful one,
    traded for matrix-unit throughput)."""
    ns, n, _ = x.shape
    na = cosv.shape[0]
    if na == 0:
        return jnp.zeros((ns, 0, nray), x.dtype)

    if row_driven:
        img = x.transpose(1, 2, 0)
        denom, shear = cosv, -sinv / cosv
    else:
        img = x.transpose(2, 1, 0)
        denom, shear = sinv, cosv / sinv

    scale = jnp.asarray(1.0 / np.abs(denom), x.dtype)
    inv_d = jnp.asarray(1.0 / denom, jnp.float32)
    shear = jnp.asarray(shear, jnp.float32)
    tj = jnp.arange(nray, dtype=jnp.float32) - (nray - 1) / 2.0
    ctr = (n - 1) / 2.0
    steps = jnp.arange(n, dtype=jnp.float32)
    iota_i = jnp.arange(n, dtype=jnp.float32)
    prec = tjconfig.mxu_precision

    def body(acc, args):
        img_k, s_idx = args  # (N, Ns), scalar
        coord = (ctr - s_idx) if row_driven else (s_idx - ctr)
        if row_driven:
            pos = tj[None, :] * inv_d[:, None] + coord * shear[:, None] + ctr
        else:
            pos = ctr - tj[None, :] * inv_d[:, None] + coord * shear[:, None]
        w = jnp.maximum(
            0.0, 1.0 - jnp.abs(pos[:, :, None] - iota_i[None, None, :])
        )
        contrib = jax.lax.dot_general(
            w.reshape(na * nray, n),
            img_k,
            (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=prec,
        )
        return acc + contrib.reshape(na, nray, ns), None

    acc0 = jnp.zeros((na, nray, ns), x.dtype)
    acc, _ = jax.lax.scan(body, acc0, (img, steps))
    return (acc * scale[:, None, None]).transpose(2, 0, 1)


def _triton(kernel, arr, geom: Geometry):
    """Run a Triton projector kernel, per z-slab under shard_map when a
    multi-device mesh is in scope and the slice axis divides it."""
    from tomojax.projector.triton_joseph import on_slabs

    return on_slabs(lambda v: kernel(v, geom), arr, tjconfig.active_mesh)


def _fp_impl(x, geom: Geometry, mode: str | None = None):
    """Forward projection: (Ns, N, N) -> (Ns, Nproj, Nray)."""
    mode = tjconfig.resolve_projector_mode(mode)
    if mode == "triton":
        from tomojax.projector.triton_joseph import fp_triton

        return _triton(fp_triton, x, geom)
    branch = _fp_branch_mxu if mode == "mxu" else _fp_branch
    rd = geom.row_driven
    p_row = branch(x, geom.cos[rd], geom.sin[rd], True, geom.nray)
    p_col = branch(x, geom.cos[~rd], geom.sin[~rd], False, geom.nray)
    p = jnp.concatenate([p_row, p_col], axis=1)
    inv = jnp.asarray(geom.inv_perm)
    return p[:, inv, :]


def _bp_impl(y, geom: Geometry):
    """Exact-adjoint backprojection: (Ns, Nproj, Nray) -> (Ns, N, N).

    Branch-free gather formulation (see module docstring): for each pixel
    the detector coordinate J* is affine in (r, c); only bins floor(J*)
    and floor(J*)+1 have nonzero Joseph weight. Scans angle-by-angle with
    the sinogram in (angle, det, Ns) layout.
    """
    ns, na, nt = y.shape
    n = geom.n
    assert na == geom.nproj and nt == geom.nray

    cosv = jnp.asarray(geom.cos, jnp.float32)
    sinv = jnp.asarray(geom.sin, jnp.float32)
    dv = jnp.asarray(geom.driving, jnp.float32)

    xc = jnp.arange(n, dtype=jnp.float32) - (n - 1) / 2.0  # x_c
    yr = (n - 1) / 2.0 - jnp.arange(n, dtype=jnp.float32)  # y_r
    off = (nt - 1) / 2.0
    yt = y.transpose(1, 2, 0)  # (Na, Nt, Ns)

    def body(acc, args):
        yk, ck, sk, dk = args  # (Nt, Ns), scalars
        jstar = ck * xc[None, :] + sk * yr[:, None] + off  # (N, N)
        j0 = jnp.floor(jstar).astype(jnp.int32)
        j1 = j0 + 1
        invd = 1.0 / dk
        w0 = jnp.maximum(0.0, 1.0 - jnp.abs(j0 - jstar) * invd) * invd
        w1 = jnp.maximum(0.0, 1.0 - jnp.abs(j1 - jstar) * invd) * invd
        w0 = jnp.where((j0 >= 0) & (j0 < nt), w0, 0.0)
        w1 = jnp.where((j1 >= 0) & (j1 < nt), w1, 0.0)
        j0 = jnp.clip(j0, 0, nt - 1)
        j1 = jnp.clip(j1, 0, nt - 1)
        # gather contiguous (Ns,) lane vectors: g[r, c, :] = yk[j, :]
        g0 = jnp.take_along_axis(
            yk[None, None, :, :], j0[:, :, None, None], axis=2
        )[:, :, 0, :]
        g1 = jnp.take_along_axis(
            yk[None, None, :, :], j1[:, :, None, None], axis=2
        )[:, :, 0, :]
        return acc + g0 * w0[..., None] + g1 * w1[..., None], None

    acc0 = jnp.zeros((n, n, ns), y.dtype)
    acc, _ = jax.lax.scan(body, acc0, (yt, cosv, sinv, dv))
    return acc.transpose(2, 0, 1)


def _bp_mxu(y, geom: Geometry, row_block: int = 16):
    """Matrix variant of `_bp_impl`: per (row-block, angle), build the
    2-banded dual interpolation matrix W[(r, c), j] = hat((J* - j)/D)/D and
    contract it (same trick as `_fp_branch_mxu`; exact transpose of it in
    exact arithmetic)."""
    ns, na, nt = y.shape
    n = geom.n
    cosv = jnp.asarray(geom.cos, jnp.float32)
    sinv = jnp.asarray(geom.sin, jnp.float32)
    dv = jnp.asarray(geom.driving, jnp.float32)
    xc = jnp.arange(n, dtype=jnp.float32) - (n - 1) / 2.0
    yr = (n - 1) / 2.0 - jnp.arange(n, dtype=jnp.float32)
    off = (nt - 1) / 2.0
    iota_j = jnp.arange(nt, dtype=jnp.float32)
    yt = y.transpose(1, 2, 0)  # (Na, Nt, Ns)
    while n % row_block:
        row_block //= 2
    nrb = n // row_block
    yr_blocks = yr.reshape(nrb, row_block)
    prec = tjconfig.mxu_precision

    def outer(rb_idx):
        yr_b = yr_blocks[rb_idx]

        def body(acc, args):
            yk, ck, sk, dk = args  # (Nt, Ns), scalars
            jstar = ck * xc[None, :] + sk * yr_b[:, None] + off  # (RB, N)
            invd = 1.0 / dk
            w = (
                jnp.maximum(
                    0.0,
                    1.0
                    - jnp.abs(jstar[:, :, None] - iota_j[None, None, :]) * invd,
                )
                * invd
            )
            contrib = jax.lax.dot_general(
                w.reshape(row_block * n, nt),
                yk,
                (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
                precision=prec,
            )
            return acc + contrib.reshape(row_block, n, ns), None

        acc0 = jnp.zeros((row_block, n, ns), y.dtype)
        acc, _ = jax.lax.scan(body, acc0, (yt, cosv, sinv, dv))
        return acc

    out = jax.lax.map(outer, jnp.arange(nrb))
    return out.reshape(n, n, ns).transpose(2, 0, 1)


# ---------------------------------------------------------------------------
# Public API: custom-vjp wrapped pair (A and A^T are each other's vjp).
# ---------------------------------------------------------------------------


def fp(x, geom: Geometry, mode: str | None = None):
    """Forward projection A x : (Ns, N, N) -> (Ns, Nproj, Nray)."""
    return _fp_impl(x, geom, mode)


def bp(y, geom: Geometry, mode: str | None = None):
    """Matched backprojection A^T y : (Ns, Nproj, Nray) -> (Ns, N, N)."""
    mode = tjconfig.resolve_projector_mode(mode)
    if mode == "triton":
        from tomojax.projector.triton_joseph import bp_triton

        return _triton(bp_triton, y, geom)
    if mode == "mxu":
        return _bp_mxu(y, geom)
    return _bp_impl(y, geom)


@partial(jax.custom_vjp, nondiff_argnums=(1,))
def fp_adjointable(x, geom: Geometry):
    return fp(x, geom)


def _fp_fwd(x, geom):
    return fp(x, geom), None


def _fp_bwd(geom, _res, g):
    return (bp(g, geom),)


fp_adjointable.defvjp(_fp_fwd, _fp_bwd)


@partial(jax.custom_vjp, nondiff_argnums=(1,))
def bp_adjointable(y, geom: Geometry):
    return bp(y, geom)


def _bp_fwd(y, geom):
    return bp(y, geom), None


def _bp_bwd(geom, _res, g):
    return (fp(g, geom),)


bp_adjointable.defvjp(_bp_fwd, _bp_bwd)
