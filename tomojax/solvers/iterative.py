"""SIRT / SART / ART / CGLS / Poisson-ML iterations, batched over slices.

Each reference algorithm is re-derived as a pure, jit-compiled function of
the whole ``(Ns, N, N)`` volume (the reference loops 2D ASTRA solvers over
slices from C++, tomoengine.cpp:162-315). Semantics match ASTRA's CUDA
algorithms as configured by the reference:

* SIRT:  x <- clamp0( x + C A^T R (b - A x) ),  R = 1/row-sums,
  C = 1/col-sums, nonnegativity from ``setConstraints(true, 0, ...)``
  (tomoengine.cpp:184).
* SART:  ordered block-Kaczmarz over angles with relaxation beta and
  'sequential' or 'random' order (tomoengine.cpp:151-179); per-block
  weights R_a, C_a; clamp after every block.
* ART (Kaczmarz): true row-action sweep, CPU-parity feature
  (cpu/utils/ctvlib.cpp:137-191).
* CGLS: standard conjugate gradient on the normal equations with
  *per-slice* scalars (each 2D slice is an independent least-squares
  problem, as in the reference's per-slice ASTRA CGLS, tomoengine.cpp:214-229).
* Poisson-ML / KL: x <- clamp0(x - (lam/L) A^T((Ax - b)/(Ax + eps))),
  eps = 0.1, cost = sum(Ax - b log(Ax + eps)) (tomoengine.cpp:293-315).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tomojax import config as tjconfig
from tomojax.projector.joseph import fp, bp
from tomojax.solvers.base import System, bp_single_angle

POISSON_EPS = 0.1  # tomoengine.cpp:295


# ----------------------------------------------------------------- SIRT ---


def sirt_sweep(x, b, sys: System, n_iter: int = 1, variant: str = "astra",
               beta=None, row_nsq=None, nonneg: bool | None = None):
    """`n_iter` SIRT iterations. x: (Ns, N, N); b: (Ns, Na, Nt).

    variant:
      'astra'     — x += C A^T R (b - Ax), R/C = inverse row/col sums,
                    nonneg clamp per iteration (ASTRA semantics as
                    configured by the reference, tomoengine.cpp:181-205).
      'landweber' — x += beta A^T (b - Ax), beta defaults to 1/L
                    (reference ctvlib.cpp:205-221 SIRT).
      'cimmino'   — x += (beta/Nrow) A^T M (b - Ax), M = 1/||a_r||^2
                    (ctvlib.cpp:245-251; pass row_nsq from
                    solvers.base.row_norms_sq, beta defaults 1).
    nonneg: clamp each iteration; defaults True for 'astra' (ASTRA's
    min-constraint), False otherwise (the reference CPU variants leave
    positivity to the caller)."""
    geom = sys.geom
    if nonneg is None:
        nonneg = variant == "astra"
    if variant == "astra":
        inv_r, inv_c = sys.inv_row, sys.inv_col

        def update(xx):
            resid = (b - fp(xx, geom)) * inv_r
            return xx + inv_c * bp(resid, geom)
    elif variant == "landweber":
        lw_beta = (1.0 / sys.lipschitz) if beta is None else beta

        def update(xx):
            return xx + lw_beta * bp(b - fp(xx, geom), geom)
    elif variant == "cimmino":
        assert row_nsq is not None, "pass row_nsq=base.row_norms_sq(geom)"
        m = jnp.where(row_nsq > 1e-12, 1.0 / jnp.maximum(row_nsq, 1e-12), 0.0)
        nrow = geom.nproj * geom.nray
        ci_beta = 1.0 if beta is None else beta

        def update(xx):
            resid = m * (b - fp(xx, geom))
            return xx + (ci_beta / nrow) * bp(resid, geom)
    else:
        raise ValueError(f"unknown SIRT variant {variant!r}")

    def body(_, xx):
        xx = update(xx)
        return jnp.maximum(xx, 0.0) if nonneg else xx

    return jax.lax.fori_loop(0, n_iter, body, x)


# ----------------------------------------------------------------- SART ---


def make_sart_weights(sys: System):
    """Per-angle inverse row/column sums.

    inv_row is sliced from the full-system row sums; per-angle column sums
    are one BP of a ones-sinogram masked per angle — computed as Na
    single-angle BPs (setup cost, once per geometry)."""
    geom = sys.geom
    cosv = jnp.asarray(geom.cos, jnp.float32)
    sinv = jnp.asarray(geom.sin, jnp.float32)

    def one(c, s):
        return bp_single_angle(
            jnp.ones((1, geom.nray), jnp.float32), c, s, geom.n
        )[0]

    col_a = jax.vmap(one)(cosv, sinv)  # (Na, N, N)
    inv_col_a = jnp.where(col_a > 1e-6, 1.0 / jnp.maximum(col_a, 1e-6), 0.0)
    return inv_col_a


def sart_sweep(x, b, sys: System, inv_col_a, beta=1.0, order=None):
    """One ordered pass over all angle blocks (== ASTRA SART `run(Nproj)`).

    order: (Na,) int32 angle visiting order (sequential = arange; random =
    a permutation, reference tomoengine.cpp:164 updateProjOrder).

    Uses the *unified* Joseph closed form (projector/joseph.py docstring:
    ``W[j, r, c] = hat((j - J*)/D)/D`` with ``J* = x_c cos + y_r sin``),
    which is branch-free in the driving axis — the volume stays in one
    (row, col, slice) layout for the entire sweep instead of being
    transposed per angle (a per-angle ``lax.cond`` layout flip would cost
    two full-volume transposes per angle). Per angle: one row-chunked FP
    contraction, then an update scan that
    applies ``W^T resid`` chunk-by-chunk (same W => exact per-block
    adjoint), with relaxation/weights/clamp per ASTRA semantics. The
    contractions run at config.mxu_precision."""
    geom = sys.geom
    na, n, nt = geom.nproj, geom.n, geom.nray
    ns = x.shape[0]
    if order is None:
        order = jnp.arange(na, dtype=jnp.int32)
    cosv = jnp.asarray(geom.cos, jnp.float32)
    sinv = jnp.asarray(geom.sin, jnp.float32)
    invd_all = jnp.asarray(1.0 / geom.driving, jnp.float32)
    inv_row = sys.inv_row[0]  # (Na, Nt)
    ctr = (n - 1) / 2.0
    off = (nt - 1) / 2.0
    xcoord = jnp.arange(n, dtype=jnp.float32) - ctr  # x_c per column
    ycoord = ctr - jnp.arange(n, dtype=jnp.float32)  # y_r per row
    iota_j = jnp.arange(nt, dtype=jnp.float32)
    prec = tjconfig.mxu_precision

    ch = 32
    while n % ch:
        ch //= 2
    nch = n // ch
    yrc = ycoord.reshape(nch, ch)

    xT = x.transpose(1, 2, 0)  # (r, c, Ns) for the whole sweep

    def body(xT, a):
        cv, sv, invd = cosv[a], sinv[a], invd_all[a]
        ba = b[:, a, :].T  # (Nt, Ns)
        invr = inv_row[a]  # (Nt,)
        invc = inv_col_a[a]  # (N, N) in (r, c)

        def wmat(yr_b):  # (CH,) row y-coords -> (CH*N, Nt) hat weights
            jstar = cv * xcoord[None, :] + sv * yr_b[:, None] + off  # (CH,N)
            w = (
                jnp.maximum(
                    0.0,
                    1.0
                    - jnp.abs(jstar[:, :, None] - iota_j[None, None, :])
                    * invd,
                )
                * invd
            )  # (CH, N, Nt)
            return w.reshape(ch * n, nt)

        xc4 = xT.reshape(nch, ch, n, ns)

        def fp_body(acc, args):
            img_k, yr_b = args  # (CH, N, Ns), (CH,)
            return acc + jax.lax.dot_general(
                wmat(yr_b), img_k.reshape(ch * n, ns),
                (((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32, precision=prec,
            ), None

        proj, _ = jax.lax.scan(
            fp_body, jnp.zeros((nt, ns), xT.dtype), (xc4, yrc)
        )
        resid = (ba - proj) * invr[:, None]  # (Nt, Ns)

        invc4 = invc.reshape(nch, ch, n)

        def upd_body(_, args):
            img_k, invc_k, yr_b = args
            upd = jax.lax.dot_general(
                wmat(yr_b), resid, (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32, precision=prec,
            ).reshape(ch, n, ns)
            new = img_k + beta * invc_k[..., None] * upd
            return None, jnp.maximum(new, 0.0)

        _, xnew = jax.lax.scan(upd_body, None, (xc4, invc4, yrc))
        return xnew.reshape(n, n, ns), None

    xT, _ = jax.lax.scan(body, xT, order)
    return xT.transpose(2, 0, 1)


# ------------------------------------------------------------------ ART ---


def art_sweep(x, b, sys: System, beta=1.0, ray_order=None):
    """True Kaczmarz sweep over individual rays (CPU-parity,
    ctvlib.cpp:137-191): x += beta * (b_i - <a_i, x>)/||a_i||^2 * a_i,
    sequentially. Rays are visited angle-major; `ray_order` permutes
    (randART). Slow by construction (inherently sequential)."""
    geom = sys.geom
    na, nt = geom.nproj, geom.nray
    nrow = na * nt
    if ray_order is None:
        ray_order = jnp.arange(nrow, dtype=jnp.int32)
    cosv = jnp.asarray(geom.cos, jnp.float32)
    sinv = jnp.asarray(geom.sin, jnp.float32)
    rowdrv = jnp.asarray(geom.row_driven)
    n = geom.n
    ctr = (n - 1) / 2.0
    steps = jnp.arange(n, dtype=jnp.float32)
    bflat = b.reshape(b.shape[0], nrow)

    def body(xx, ridx):
        a = ridx // nt
        j = ridx % nt
        c, s, rd = cosv[a], sinv[a], rowdrv[a]
        tj = j.astype(jnp.float32) - (nt - 1) / 2.0
        safe_c = jnp.where(jnp.abs(c) < 1e-8, 1.0, c)
        safe_s = jnp.where(jnp.abs(s) < 1e-8, 1.0, s)
        # positions along the step axis for both branches
        pos_row = tj / safe_c + (ctr - steps) * (-s / safe_c) + ctr
        pos_col = ctr - tj / safe_s + (steps - ctr) * (c / safe_s)
        pos = jnp.where(rd, pos_row, pos_col)
        scale = 1.0 / jnp.maximum(jnp.abs(jnp.where(rd, c, s)), 1e-8)
        f = jnp.floor(pos)
        frac = pos - f
        i0 = f.astype(jnp.int32)
        i1 = i0 + 1
        w0 = jnp.where((i0 >= 0) & (i0 < n), 1.0 - frac, 0.0) * scale
        w1 = jnp.where((i1 >= 0) & (i1 < n), frac, 0.0) * scale
        i0 = jnp.clip(i0, 0, n - 1)
        i1 = jnp.clip(i1, 0, n - 1)
        # row-driven: pixel (m, i*) ; col-driven: pixel (i*, m)
        xr = jnp.where(rd, xx, xx.transpose(0, 2, 1))
        m = jnp.arange(n)
        v0 = xr[:, m, i0]
        v1 = xr[:, m, i1]
        dot = (v0 * w0[None] + v1 * w1[None]).sum(-1)  # (Ns,)
        row_nsq = (w0 * w0 + w1 * w1).sum()
        coeff = beta * (bflat[:, ridx] - dot) / jnp.maximum(row_nsq, 1e-12)
        xr = xr.at[:, m, i0].add(coeff[:, None] * w0[None])
        xr = xr.at[:, m, i1].add(coeff[:, None] * w1[None])
        xx = jnp.where(rd, xr, xr.transpose(0, 2, 1))
        return xx, None

    x, _ = jax.lax.scan(body, x, ray_order)
    return x


# ----------------------------------------------------------------- CGLS ---


def cgls_run(x, b, sys: System, n_iter: int):
    """`n_iter` CGLS steps from the current volume, per-slice scalars.

    Matches the reference behavior of re-initializing CG state each call
    (tomoengine.cpp:214-229); positivity is NOT applied here (the caller
    applies it after the run, tomoengine.cpp:228)."""
    geom = sys.geom

    def dots_img(v):
        return jnp.sum(v * v, axis=(1, 2), keepdims=True)  # (Ns,1,1)

    def dots_sino(v):
        return jnp.sum(v * v, axis=(1, 2))[:, None, None]

    r = b - fp(x, geom)
    s = bp(r, geom)
    p = s
    gamma = dots_img(s)

    def body(_, carry):
        x, r, p, gamma = carry
        q = fp(p, geom)
        denom = dots_sino(q)
        alpha = jnp.where(denom > 0, gamma / jnp.maximum(denom, 1e-30), 0.0)
        x = x + alpha * p
        r = r - alpha * q
        s = bp(r, geom)
        gamma_new = dots_img(s)
        beta = jnp.where(gamma > 0, gamma_new / jnp.maximum(gamma, 1e-30), 0.0)
        p = s + beta * p
        return x, r, p, gamma_new

    x, _, _, _ = jax.lax.fori_loop(0, n_iter, body, (x, r, p, gamma))
    return x


# ----------------------------------------------- Poisson-ML (KL) ----------


def poisson_ml_step(x, b, sys: System, lam):
    """One Poisson maximum-likelihood gradient step + positivity.

    Returns (x_new, kl_cost). b must be pre-normalized to max <= 1
    (tomoengine.cpp:245, done by the API layer)."""
    geom = sys.geom
    ax = fp(x, geom)
    upd = bp((ax - b) / (ax + POISSON_EPS), geom)
    x = jnp.maximum(x - (lam / sys.lipschitz) * upd, 0.0)
    cost = jnp.sum(ax - b * jnp.log(ax + POISSON_EPS))
    return x, cost


# ------------------------------------------------- least squares ----------


def least_squares_step(x, b, sys: System):
    """Plain gradient step x -= (1/L) A^T (A x - b) (tomoengine.cpp:386-401)."""
    geom = sys.geom
    return x - (1.0 / sys.lipschitz) * bp(fp(x, geom) - b, geom)
