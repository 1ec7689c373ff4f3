"""tomojax — tomographic reconstruction in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
jtschwar/tomo_TV ("tomofusion"): matched forward/back-projection for
parallel-beam tilt-series geometry, WBP/FBP, SIRT, SART/ART, CGLS,
Poisson-ML (KL), FISTA-TV, ASD-POCS, fused multi-modal chemical
tomography, simulation utilities and dynamic/streaming reconstruction.

Unlike the reference (per-slice 2D ASTRA CUDA calls looped from the host,
OpenMP threads over GPUs, MPI slabs over nodes — see
reference tomofusion/gpu/utils/tomoengine.cpp:189-205 and
mpi_astra_ctvlib.cpp:53-118), every per-iteration computation here is a
single jitted XLA program over the whole (sharded) volume: the slice loop
is a batched axis, halo exchange and reductions are XLA collectives over
the device mesh, and the hot kernels are fused stencils / gathers, with
the projector pair as Pallas kernels on the GPU.
"""

from tomojax.geometry import Geometry

__version__ = "0.1.0"


def enable_compilation_cache() -> None:
    """Persistent XLA compilation cache. Called on import.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here. Otherwise the cache lives in ``.jax_cache`` at the
    root of the checkout (listed in .gitignore)."""
    import os

    import jax

    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(root, ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


enable_compilation_cache()


def __getattr__(name):
    # Lazy to keep `import tomojax` light and avoid cycles during buildout.
    if name in ("TomoTPU", "ChemicalTomo"):
        from tomojax import api

        return getattr(api, name)
    raise AttributeError(name)


def device_count() -> int:
    """Number of accelerator devices visible to this process.

    Mirrors tomofusion/__init__.py:10-18 (pycuda device count) but via JAX.
    """
    import jax

    return jax.local_device_count()


def determine_config(device_id: int = -1) -> str:
    """Mirror of reference tomofusion/__init__.py:21-34 `determine_gpu_config`.

    In JAX the distinction between 'singleconfig' and 'multigpu' is moot —
    the same pjit'd program runs on any mesh — but the helper is kept for
    API parity. Returns 'singledevice' or 'multidevice'.
    """
    if device_id >= 0:
        return "singledevice"
    return "singledevice" if device_count() <= 1 else "multidevice"


__all__ = [
    "Geometry",
    "TomoTPU",
    "ChemicalTomo",
    "device_count",
    "determine_config",
    "__version__",
]
