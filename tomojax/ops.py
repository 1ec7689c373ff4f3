"""Elementwise / reduction volume ops.

Batched equivalents of the reference's CUDA container kernels
(tomofusion/gpu/utils/container/matrix_ops.cu — norm/l1/sum, squared
difference reductions, positivity clamp, background fill, soft threshold,
Nesterov momentum; SURVEY.md N8/N10). There each call does its own
malloc → H2D → kernel → D2H round trip; here they are plain jnp functions
that XLA fuses into the surrounding jitted solver step, so most of them
cost zero extra HBM traffic.

All functions work on arrays of any shape (3D ``(Ns, N, N)`` volumes or 4D
``(Nel, Ns, N, N)`` chemistry stacks) unless noted.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def positivity(x):
    """Clamp negatives to zero (matrix_ops.cu:266-293)."""
    return jnp.maximum(x, 0.0)


def set_background(x, value):
    """Fill exact zeros with `value` (matrix_ops.cu:295-321)."""
    return jnp.where(x == 0.0, value, x)


def soft_threshold(x, lam):
    """sign(x) * max(|x| - lam, 0) (matrix_ops.cu:64-75)."""
    return jnp.sign(x) * jnp.maximum(jnp.abs(x) - lam, 0.0)


def nesterov(xk, xk_old, beta):
    """y = x + beta (x - x_old) (matrix_ops.cu:77-86)."""
    return xk + beta * (xk - xk_old)


def norm2(x):
    """Frobenius norm sqrt(sum x^2) (matrix_ops.cu cuda_norm)."""
    return jnp.sqrt(jnp.sum(x * x))


def l1_norm(x):
    return jnp.sum(jnp.abs(x))


def euclidean_dist(a, b):
    """sqrt(sum (a-b)^2) — reference matrix_2norm (tomoengine.cpp:407)."""
    d = a - b
    return jnp.sqrt(jnp.sum(d * d))


def rmse(x, ref):
    """Root-mean-square error vs ground truth (tomoengine.cpp:430)."""
    d = x - ref
    return jnp.sqrt(jnp.mean(d * d))


def rmse_per_element(x, ref):
    """Per-element RMSE vector for 4D chemistry volumes
    (chemistry/utils/multimodal.cpp:503-505)."""
    d = x - ref
    return jnp.sqrt(jnp.mean(d * d, axis=tuple(range(1, x.ndim))))


def data_distance(g, b):
    """Unnormalized ||g - b||_F between model and measured projections
    (tomoengine.cpp:410-413 — deliberately unnormalized, SURVEY.md §2.5)."""
    return euclidean_dist(g, b)


def poisson_noise(key, b, n_counts: int):
    """Poisson-corrupt a sinogram at a mean count level.

    Functional version of reference tomoengine.cpp:471-484: scale so the
    mean *total* is `n_counts * size / sum`, draw Poisson, scale back.

    Sampling happens on the HOST (native OpenMP C++ when available, numpy
    otherwise) like the reference's std::poisson_distribution loop:
    `jax.random.poisson` at high count levels is a rejection sampler
    whose cost grows with the count level.

    Pod-safe sharded path (the reference's MPI design,
    mpi_astra_ctvlib.cpp:152-173: `MPI_Allreduce` of the local sums for
    the global mean, then each rank corrupts its local slab): when `b`
    is sharded over more than one device, the global sum is ONE jitted
    scalar reduction (lowers to psum) and each addressable shard is
    corrupted locally with a deterministic per-shard seed — the global
    sinogram never materializes on any host. Per-shard seeding means the
    sampled noise depends on the shard layout (the reference's
    per-rank std::poisson streams likewise differ by rank count)."""
    seed = int(np.asarray(jax.random.key_data(key)).ravel()[-1]) & 0x7FFFFFFF
    if isinstance(b, jax.Array) and len(b.sharding.device_set) > 1:
        total = float(jax.jit(jnp.sum)(b))  # psum over shards
        if total <= 0:
            return b
        scale = n_counts * b.size / total
        pieces = []
        for sh in b.addressable_shards:
            off = tuple(int(s.start or 0) for s in sh.index)
            sseed = seed
            for o in off:
                sseed = (sseed * 1000003 + o * 7919 + 1) & 0x7FFFFFFF
            rng = np.random.default_rng(sseed)
            local = np.asarray(sh.data)
            noisy = (rng.poisson(local * scale) / scale).astype(np.float32)
            pieces.append(jax.device_put(noisy, sh.device))
        return jax.make_array_from_single_device_arrays(
            b.shape, b.sharding, pieces
        )
    b_host = np.asarray(b)
    try:
        from tomojax import native

        # forced copy: np.ascontiguousarray can return the caller's own
        # buffer (or a zero-copy view of a jax array) and the native
        # kernel writes in place
        noisy = np.array(b_host, np.float32)
        native.lib().poisson_noise(noisy, noisy.size, int(n_counts), seed)
    except Exception:
        total = float(b_host.sum())
        scale = n_counts * b_host.size / total
        rng = np.random.default_rng(seed)
        noisy = (rng.poisson(b_host * scale) / scale).astype(b_host.dtype)
    return jnp.asarray(noisy, jnp.float32)
