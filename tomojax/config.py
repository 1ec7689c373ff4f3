"""Which kernel family runs on which platform, and the knobs of the XLA forms.

This module is the one place that reads the JAX backend. Everything else
asks `resolve_projector_mode`.

projector_mode:
  'auto'   — the platform's family (`PROJECTOR_FAMILY`): the Triton kernel
             pair on a GPU, the XLA 'mxu' form on the CPU.
  'triton' — Pallas kernels for the Triton route (projector/triton_joseph.py):
             the gather form with the accumulator in registers. GPU only.
             Measured on one H100 (400 W limit) at 256^3 x 90: FP 1.27 ms,
             BP 1.19 ms, against 7.64 / 5.57 ms for 'gather' and
             16.1 / 34.4 ms for 'mxu' at HIGH (scripts/compare_projectors.py).
  'gather' — XLA 2-point gather form; exact transpose pair to f32
             rounding. The strict-adjoint reference.
  'mxu'    — XLA dense interpolation-matrix contraction at `mxu_precision`.

A mode the platform cannot run raises; nothing falls back quietly.

mxu_precision: the `jax.lax.Precision` of the 'mxu' projector and of the
SART sweep's contractions. HIGHEST by default. On XLA:GPU, HIGH leaves the
cuBLAS algorithm unset and runs TF32-class arithmetic: measured on an H100,
'mxu' BP at HIGH has the same 3.0e-5 relative L2 error against 'gather' as
DEFAULT, FP 1.8e-5; HIGHEST measured 3.6e-7 (FP) and 2.1e-7 (BP). The CPU
backend computes float32 products in float32 whatever the setting.

Set via `tomojax.config.set_projector_mode(...)` BEFORE building jitted
steps (jit closures capture the mode at trace time).
"""

from __future__ import annotations

from contextlib import contextmanager as _contextmanager

import jax

PROJECTOR_FAMILY = {"gpu": "triton", "cpu": "mxu"}
_PLATFORMS = {"triton": ("gpu",), "gather": ("cpu", "gpu"), "mxu": ("cpu", "gpu")}

projector_mode: str = "auto"
mxu_precision = jax.lax.Precision.HIGHEST

# active_mesh: the slab mesh solver programs run under. Scoped, not
# global: the API layer (TomoTPU/ChemicalTomo) wraps every method body in
# `mesh_scope(self.mesh)`, so dispatch is per-reconstructor — two live
# reconstructors with different meshes can't silently re-route each
# other's kernels. Under a multi-device mesh the Triton projector runs
# per z-slab inside shard_map (a pallas_call has no partitioning rule);
# the data term is slice-parallel, so no slab talks to another.
active_mesh = None


@_contextmanager
def mesh_scope(mesh):
    """Dynamically scope the slab mesh used for sharded-kernel dispatch.

    jit closures capture the dispatch decision at TRACE time, so a step
    built and first called inside the scope keeps its routing for the
    lifetime of its compiled program even after the scope exits."""
    global active_mesh
    prev = active_mesh
    active_mesh = mesh
    try:
        yield mesh
    finally:
        active_mesh = prev


def set_mesh(mesh) -> None:
    """Deprecated process-global registration (last-caller-wins). Prefer
    `mesh_scope` (what the API layer uses) — kept as a shim for scripts
    that build jitted steps outside a reconstructor object."""
    global active_mesh
    active_mesh = mesh


def set_projector_mode(mode: str, precision=None):
    global projector_mode, mxu_precision
    if mode != "auto" and mode not in _PLATFORMS:
        raise ValueError(f"unknown projector mode {mode!r}")
    projector_mode = mode
    if precision is not None:
        mxu_precision = precision


def platform() -> str:
    """The JAX backend the next program compiles for ('cpu', 'gpu', ...)."""
    return jax.default_backend()


def resolve_projector_mode(mode: str | None = None) -> str:
    """The projector form to trace: 'auto' maps the platform to its
    family; an explicit mode is checked against the platform."""
    mode = mode or projector_mode
    plat = platform()
    if mode == "auto":
        if plat not in PROJECTOR_FAMILY:
            raise RuntimeError(f"no projector family for platform {plat!r}")
        return PROJECTOR_FAMILY[plat]
    if mode not in _PLATFORMS:
        raise ValueError(f"unknown projector mode {mode!r}")
    if plat not in _PLATFORMS[mode]:
        raise RuntimeError(
            f"projector mode {mode!r} cannot run on platform {plat!r}"
        )
    return mode
