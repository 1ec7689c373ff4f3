"""Compatibility helper layer mirroring the reference `pytvlib` modules.

The reference exposes two helper libraries (tomofusion/pytvlib.py for the
GPU engines, tomofusion/cpu/utils/pytvlib.py for the CPU engines) with
name-based algorithm dispatch, filter/order lists, data loaders and HDF5
savers. This module provides the same surface on top of tomojax so driver
scripts written against the reference port mechanically.
"""

from __future__ import annotations

from tomojax.projector.filters import FILTERS
from tomojax import io as _io


# ------------------------------------------------------ dispatch ----------

_ALG_ALIASES = {
    "sirt": "sirt",
    "cgls": "cgls",
    "fista": "fista",
    "poisson_ml": "kl_divergence",
    "kl-divergence": "kl_divergence",
    "sart": "sart",
    "asd-pocs": "asd_pocs",
    "fbp": "wbp",
    "wbp": "wbp",
    "art": "art",
    "randart": "randart",
    "cimminosirt": "cimmino_sirt",
}


def initialize_algorithm(tomo, alg: str, init_alg: str = ""):
    """Name-based dispatch (reference tomofusion/pytvlib.py:5-19).

    tomojax reconstructors fuse initialize+run, so this only validates the
    name and stashes the sub-option (SART order / FBP filter)."""
    key = alg.lower()
    if key not in _ALG_ALIASES:
        raise ValueError(f"unknown algorithm {alg!r}")
    tomo._alg = _ALG_ALIASES[key]
    tomo._alg_opt = init_alg
    return tomo


def run(tomo, alg: str, beta: float = 1.0, niter: int = 1, **kw):
    """Run dispatch (reference pytvlib.py:21-31 and cpu pytvlib.py:171-189).
    Executes `niter` iterations of the named algorithm on a TomoTPU
    instance — every alias `initialize_algorithm` accepts is runnable."""
    key = _ALG_ALIASES[alg.lower()]
    opt = getattr(tomo, "_alg_opt", "")
    if key == "sirt" or key == "fista":
        return tomo.sirt(Niter=niter, show_convergence=False)
    if key == "cimmino_sirt":
        return tomo.sirt(Niter=niter, show_convergence=False, variant="cimmino")
    if key == "cgls":
        return tomo.cgls(Niter=niter, show_convergence=False)
    if key == "sart":
        return tomo.sart(Niter=niter, init=opt or "sequential", beta=beta,
                         show_convergence=False)
    if key == "art":
        return tomo.art(Niter=niter, beta=beta, show_convergence=False)
    if key == "randart":
        return tomo.art(Niter=niter, beta=beta, random_order=True,
                        show_convergence=False)
    if key == "asd_pocs":
        return tomo.asd_pocs(Niter=niter, beta0=beta)
    if key == "kl_divergence":
        return tomo.kl_divergence(Niter=niter, lambda_param=beta)
    if key == "wbp":
        return tomo.wbp(opt or "ram-lak")
    raise ValueError(f"run() does not handle {alg!r}")


def wbp_filters():
    """Reference pytvlib.py:33-36 exposes the commonly-used subset; we
    return the full supported bank."""
    return [f for f in FILTERS if f != "none"]


def sart_orders():
    return ["sequential", "random"]


def check_devices():
    """Reference `check_cuda` analog (pytvlib.py:42-51): verify an
    accelerator (or CPU fallback) is available."""
    import jax

    try:
        devs = jax.devices()
    except RuntimeError as e:  # pragma: no cover
        print("No JAX backend available:", e)
        raise
    return devs


# ------------------------------------------------------ io shims ----------


def load_h5_data(vol_size, file_name, dir: str = "Tilt_Series/"):
    """Reference cpu/utils/pytvlib.py:132-145 layout."""
    full = f"{vol_size}_{file_name}" if vol_size else file_name
    series, angles = _io.load_h5_data(dir + full)
    return (file_name.replace(".h5", ""), angles, series)


def load_data(vol_size, file_name, dir: str = "Tilt_Series/"):
    """tiff/npy loader with the reference axis swap (pytvlib.py:147-169)."""
    series = _io.load_tilt_series(dir + vol_size + file_name)
    for suffix in ("_tiltser.tiff", "_tiltser.tif", "_tiltser.npy"):
        file_name = file_name.replace(suffix, "")
    return (file_name, series)


def save_results(fname, meta, results, tomo=None, save_recon: bool = False):
    """Reference pytvlib.py:97-139 layout: results/<name>/<alg>.h5."""
    path = f"results/{fname[0]}/{fname[1]}.h5"
    recon = tomo.get_recon() if (save_recon and tomo is not None) else None
    _io.save_results(path, meta, results, recon)
    return path
