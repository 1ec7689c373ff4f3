"""Joseph projector pair as Pallas kernels for the Triton route (GPU).

Same arithmetic as the XLA gather form in ``projector/joseph.py``
(``_fp_branch`` / ``_bp_impl``): every weight is a 2-point linear
interpolation, computed where it is used, and no interpolation matrix is
ever formed. What the kernels change is where the accumulator lives. The
XLA form is a ``lax.scan`` whose every step reads and writes the whole
``(angles, det, slices)`` (FP) or ``(N, N, slices)`` (BP) accumulator in
device memory; here one program owns a tile of the output and keeps its
sum in registers for the whole loop.

Layout: both kernels work slice-last, so one interpolation index selects a
contiguous row of ``BS`` slices (a coalesced read) and is shared by the
whole slice block.

* FP: one program per (angle, detector block of ``BT`` bins, slice block),
  looping over the N driving steps. Row- and column-driven angles are two
  calls that read the same slice-last volume with swapped strides.
* BP: one program per (block of ``BP`` pixels, slice block), looping over
  the angles with the closed form ``J* = x_c cos + y_r sin + (Nray-1)/2``.

``interpret=True`` runs the kernels through the Pallas interpreter, which
is how they are tested without a GPU; nothing infers it from the backend.
``fp_triton`` and ``bp_triton`` are each other's VJP.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from tomojax.geometry import Geometry
from tomojax.projector.joseph import _hat_weights

# Tile sizes (powers of two, as Triton requires). BS slices per program
# give 128-byte rows per gathered index at f32.
FP_BT = 64
FP_BS = 32
BP_PIX = 64
BP_BS = 32
NUM_WARPS = 4


def _pow2_at_most(cap: int, n: int) -> int:
    """The smallest power of two >= n, capped at cap."""
    b = 1
    while b < cap and b < n:
        b *= 2
    return b


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _call(kernel, out_shape, grid, interpret, name):
    return pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=grid,
        interpret=interpret,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        name=name,
    )


def _fp_kernel(inv_d_ref, shear_ref, scale_ref, vol_ref, out_ref, *,
               n, nray, bt, bs, row_driven):
    a = pl.program_id(0)
    t0 = pl.program_id(1) * bt
    s0 = pl.program_id(2) * bs
    inv_d = inv_d_ref[a]
    shear = shear_ref[a]
    ctr = (n - 1) / 2.0
    tj = (t0 + jax.lax.iota(jnp.int32, bt)).astype(jnp.float32) - (
        (nray - 1) / 2.0)
    sl = pl.ds(s0, bs)

    def body(k, acc):
        kf = k.astype(jnp.float32)
        if row_driven:
            pos = tj * inv_d + (ctr - kf) * shear + ctr
        else:
            pos = ctr - tj * inv_d + (kf - ctr) * shear
        i0, i1, w0, w1 = _hat_weights(pos, n)
        # slice-last volume rows are r * n + c: a row-driven angle steps
        # over rows (r = k, c = i), a column-driven one over columns
        if row_driven:
            r0, r1 = k * n + i0, k * n + i1
        else:
            r0, r1 = i0 * n + k, i1 * n + k
        g0 = vol_ref[r0, sl]
        g1 = vol_ref[r1, sl]
        return acc + g0 * w0[:, None] + g1 * w1[:, None]

    acc = jax.lax.fori_loop(0, n, body, jnp.zeros((bt, bs), jnp.float32))
    out_ref[a, pl.ds(t0, bt), sl] = acc * scale_ref[a]


def _fp_branch_triton(vol2d, geom: Geometry, idx, row_driven, nt_pad, bt, bs,
                      interpret):
    """One driving-axis branch: (N*N, Ns_pad) -> (len(idx), Nt_pad, Ns_pad)."""
    ns_pad = vol2d.shape[1]
    cosv, sinv = geom.cos[idx], geom.sin[idx]
    denom = cosv if row_driven else sinv
    shear = -sinv / cosv if row_driven else cosv / sinv
    inv_d = jnp.asarray(1.0 / denom, jnp.float32)
    shear = jnp.asarray(shear, jnp.float32)
    scale = jnp.asarray(1.0 / np.abs(denom), jnp.float32)
    kernel = partial(_fp_kernel, n=geom.n, nray=geom.nray, bt=bt, bs=bs,
                     row_driven=row_driven)
    na = len(idx)
    return _call(
        kernel,
        jax.ShapeDtypeStruct((na, nt_pad, ns_pad), jnp.float32),
        (na, nt_pad // bt, ns_pad // bs),
        interpret,
        "joseph_fp_row" if row_driven else "joseph_fp_col",
    )(inv_d, shear, scale, vol2d)


def _fp_triton_impl(x, geom: Geometry, interpret=False):
    ns, n, _ = x.shape
    nt = geom.nray
    if geom.nproj == 0:
        return jnp.zeros((ns, 0, nt), x.dtype)
    bs = _pow2_at_most(FP_BS, ns)
    bt = _pow2_at_most(FP_BT, nt)
    ns_pad, nt_pad = _round_up(ns, bs), _round_up(nt, bt)
    vol = jnp.pad(x.astype(jnp.float32).transpose(1, 2, 0),
                  ((0, 0), (0, 0), (0, ns_pad - ns))).reshape(n * n, ns_pad)
    rd = geom.row_driven
    parts = [
        _fp_branch_triton(vol, geom, np.nonzero(sel)[0], row, nt_pad, bt, bs,
                          interpret)
        for sel, row in ((rd, True), (~rd, False))
        if sel.any()
    ]
    p = jnp.concatenate(parts, axis=0)[jnp.asarray(geom.inv_perm)]
    return p[:, :nt, :ns].transpose(2, 0, 1).astype(x.dtype)


def _bp_kernel(cos_ref, sin_ref, d_ref, sino_ref, out_ref, *,
               n, nray, na, bpix, bs):
    p0 = pl.program_id(0) * bpix
    s0 = pl.program_id(1) * bs
    pix = p0 + jax.lax.iota(jnp.int32, bpix)
    xc = (pix % n).astype(jnp.float32) - (n - 1) / 2.0
    yr = (n - 1) / 2.0 - (pix // n).astype(jnp.float32)
    off = (nray - 1) / 2.0
    sl = pl.ds(s0, bs)

    def body(a, acc):
        ck, sk = cos_ref[a], sin_ref[a]
        invd = 1.0 / d_ref[a]
        jstar = ck * xc + sk * yr + off
        j0 = jnp.floor(jstar).astype(jnp.int32)
        j1 = j0 + 1
        w0 = jnp.maximum(0.0, 1.0 - jnp.abs(j0 - jstar) * invd) * invd
        w1 = jnp.maximum(0.0, 1.0 - jnp.abs(j1 - jstar) * invd) * invd
        w0 = jnp.where((j0 >= 0) & (j0 < nray), w0, 0.0)
        w1 = jnp.where((j1 >= 0) & (j1 < nray), w1, 0.0)
        j0 = jnp.clip(j0, 0, nray - 1)
        j1 = jnp.clip(j1, 0, nray - 1)
        g0 = sino_ref[a * nray + j0, sl]
        g1 = sino_ref[a * nray + j1, sl]
        return acc + g0 * w0[:, None] + g1 * w1[:, None]

    acc = jax.lax.fori_loop(0, na, body, jnp.zeros((bpix, bs), jnp.float32))
    out_ref[pl.ds(p0, bpix), sl] = acc


def _bp_triton_impl(y, geom: Geometry, interpret=False):
    ns, na, nt = y.shape
    n = geom.n
    assert na == geom.nproj and nt == geom.nray, (y.shape, geom.nproj)
    if na == 0:
        return jnp.zeros((ns, n, n), y.dtype)
    bs = _pow2_at_most(BP_BS, ns)
    bpix = _pow2_at_most(BP_PIX, n * n)
    ns_pad, npix_pad = _round_up(ns, bs), _round_up(n * n, bpix)
    sino = jnp.pad(y.astype(jnp.float32).transpose(1, 2, 0),
                   ((0, 0), (0, 0), (0, ns_pad - ns))).reshape(na * nt, ns_pad)
    kernel = partial(_bp_kernel, n=n, nray=nt, na=na, bpix=bpix, bs=bs)
    out = _call(
        kernel,
        jax.ShapeDtypeStruct((npix_pad, ns_pad), jnp.float32),
        (npix_pad // bpix, ns_pad // bs),
        interpret,
        "joseph_bp",
    )(
        jnp.asarray(geom.cos, jnp.float32),
        jnp.asarray(geom.sin, jnp.float32),
        jnp.asarray(geom.driving, jnp.float32),
        sino,
    )
    return out[: n * n, :ns].reshape(n, n, ns).transpose(2, 0, 1).astype(
        y.dtype)


@partial(jax.custom_vjp, nondiff_argnums=(1, 2))
def fp_triton(x, geom: Geometry, interpret: bool = False):
    """Forward projection A x: (Ns, N, N) -> (Ns, Nproj, Nray)."""
    return _fp_triton_impl(x, geom, interpret)


fp_triton.defvjp(
    lambda x, geom, interpret: (_fp_triton_impl(x, geom, interpret), None),
    lambda geom, interpret, _res, g: (_bp_triton_impl(g, geom, interpret),),
)


@partial(jax.custom_vjp, nondiff_argnums=(1, 2))
def bp_triton(y, geom: Geometry, interpret: bool = False):
    """Matched backprojection A^T y: (Ns, Nproj, Nray) -> (Ns, N, N)."""
    return _bp_triton_impl(y, geom, interpret)


bp_triton.defvjp(
    lambda y, geom, interpret: (_bp_triton_impl(y, geom, interpret), None),
    lambda geom, interpret, _res, g: (_fp_triton_impl(g, geom, interpret),),
)


def on_slabs(f, arr, mesh):
    """Apply a slice-parallel kernel ``f`` to ``arr`` (slice axis 0).

    A pallas_call has no partitioning rule, so under a multi-device slab
    mesh the kernel runs per shard inside shard_map; each device projects
    its own z-slab with no cross-device traffic (the data term is
    slice-parallel, as in the reference's MPI slabs,
    mpi_astra_ctvlib.cpp:211-231). Without a mesh, or when the slice
    count does not divide it, ``f`` runs on the whole array."""
    if mesh is None or mesh.size == 1 or arr.shape[0] % mesh.size:
        return f(arr)
    from jax.sharding import PartitionSpec as P

    from tomojax.dist import SLAB_AXIS

    spec = P(SLAB_AXIS, None, None)
    return jax.shard_map(f, mesh=mesh, in_specs=(spec,), out_specs=spec,
                         check_vma=False)(arr)
