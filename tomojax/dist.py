"""Distribution: device mesh, z-slab sharding, halo exchange, reductions.

Replacement for the reference's entire distributed stack
(SURVEY.md §2.3): the MPI slab decomposition (mpi_astra_ctvlib.cpp:53-64),
ring halo exchange for the TV stencil (:360-386), MPI_Allreduce'd scalar
metrics (:297-357), and OpenMP multi-GPU slice scheduling
(multigpuengine.cpp:159-194) all collapse into ONE mechanism here: the
volume is sharded on its slice axis over a 1D `jax.sharding.Mesh` and every
solver step is jit-compiled under that sharding.

Why no hand-written halo code is needed for correctness: the projector
treats the slice axis as a pure batch axis (zero cross-slice
communication — the data term is embarrassingly parallel, exactly like the
reference), and the TV stencils use `jnp.roll` along the slice axis, which
XLA's SPMD partitioner lowers to an ICI `CollectivePermute` of the one
boundary plane — the same 1-slice halo the reference exchanges by hand.
Scalar reductions (`jnp.sum` inside metrics) lower to `AllReduce` over ICI
(the reference's MPI_Allreduce). `shard_map`-based manual variants can be
added per-kernel when profiling justifies it.

Multi-host: `init_distributed()` wraps `jax.distributed.initialize()`;
the mesh then spans all hosts' devices and the same jitted programs run
unchanged, with slab traffic riding ICI within a slice and DCN across
hosts (BASELINE.json north star).

Deviation noted in SURVEY.md §3.3: the reference's multi-rank TV-GD
normalizes the gradient by the *local* slab norm (tv_gd.cu:194-195 is
never all-reduced) and treats each slab as an independent periodic
volume. We compute the global norm by default — sharded and unsharded
runs are consistent by construction; pass
``tv.tv_gd(..., compat='reference-mpi')`` under a mesh scope to opt in
to the reference's shard-count-dependent behavior for trace-matching.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SLAB_AXIS = "z"


def init_distributed(**kwargs) -> None:
    """Multi-host bring-up (replaces MPI_Init, mpi_astra_ctvlib.cpp:48).

    No-op when running single-process. Must be called before any JAX
    call that initializes the XLA backend — so kwargs are checked FIRST
    (jax.process_count() itself would initialize the backend)."""
    if kwargs:
        jax.distributed.initialize(**kwargs)
    elif jax.process_count() > 1:
        jax.distributed.initialize()


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1D mesh over (a prefix of) all devices; axis name 'z' = slice slabs."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (SLAB_AXIS,))


def slab_spec(ndim: int, axis: int = 0) -> P:
    """PartitionSpec sharding `axis` over the slab mesh axis."""
    spec = [None] * ndim
    spec[axis] = SLAB_AXIS
    return P(*spec)


def shard_volume(x, mesh: Mesh, axis: int = 0):
    """Place a (Ns, N, N) volume (or (Ns, Na, Nt) sinogram) as z-slabs.

    The slab split is XLA's even partition of axis 0 — the analog of the
    reference's `Nslice_loc = Nslice/nproc` (+ remainder) slab math
    (mpi_astra_ctvlib.cpp:53-58); uneven sizes are handled by padding at
    the XLA level, not by user code."""
    return jax.device_put(x, NamedSharding(mesh, slab_spec(np.ndim(x), axis)))


def shard_global(x, mesh: Mesh, axis: int = 0):
    """Place a host array that every process holds in full as z-slabs of
    a (possibly multi-process) global array.

    `shard_volume`'s device_put requires every shard to be addressable,
    which fails on a mesh spanning processes; `make_array_from_callback`
    lets each process contribute only the slabs it owns — the analog of
    each MPI rank loading `recon[s + firstSlice()]` from the replicated
    host data (reference examples/sim_ASD.py:49-50). On a single-process
    mesh the two are equivalent. axis=None replicates instead of
    sharding (for masks/small operands fed to the same jit)."""
    x = np.asarray(x)
    spec = P() if axis is None else slab_spec(x.ndim, axis)
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(
        x.shape, sharding, lambda idx: x[idx]
    )


def shard_volume_4d(x, mesh: Mesh):
    """(Nel, Ns, N, N) chemistry stack: shard the slice axis (axis 1)."""
    return jax.device_put(x, NamedSharding(mesh, slab_spec(4, 1)))


def replicate(x, mesh: Mesh):
    return jax.device_put(x, NamedSharding(mesh, P()))


def pad_slices(x, mesh: Mesh, axis: int = 0):
    """Pad the slice axis with zero slices to a multiple of the mesh size.

    jit requires the sharded dimension to divide evenly; the reference
    instead spreads remainder slices over ranks (mpi_astra_ctvlib.cpp:53-58).
    Returns (padded, original_count). NOTE: padding adds zero slices at the
    high end; the periodic TV wrap then couples slice Ns-1 to a zero slice
    instead of slice 0 — a boundary-plane-sized deviation, documented in
    the API layer (use `unpad_slices` to recover the original extent).
    """
    import jax.numpy as jnp

    ns = x.shape[axis]
    ndev = mesh.devices.size
    pad = (-ns) % ndev
    if pad:
        widths = [(0, 0)] * x.ndim
        widths[axis] = (0, pad)
        x = jnp.pad(x, widths)
    return x, ns


def unpad_slices(x, ns: int, axis: int = 0):
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(0, ns)
    return x[tuple(idx)]


def sharded_jit(fun, mesh: Mesh, in_specs, out_specs):
    """jit with explicit slab shardings.

    in_specs/out_specs: pytrees matching the signature whose leaves are
    PartitionSpecs (use `slab_spec(ndim)`) or None for replicated."""
    import jax.tree_util as jtu

    def to_sharding(leaf):
        return NamedSharding(mesh, leaf if isinstance(leaf, P) else P())

    is_leaf = lambda l: l is None or isinstance(l, P)
    return jax.jit(
        fun,
        in_shardings=jtu.tree_map(to_sharding, in_specs, is_leaf=is_leaf),
        out_shardings=jtu.tree_map(to_sharding, out_specs, is_leaf=is_leaf),
    )


def process_zero_value(x):
    """Host-side broadcast helper for streaming-mode control decisions
    (the reference rank-0 bcast, mpi_logger.py:176-180)."""
    if jax.process_count() == 1:
        return x
    from jax.experimental import multihost_utils

    return multihost_utils.broadcast_one_to_all(x)
