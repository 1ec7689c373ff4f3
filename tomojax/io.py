"""I/O: tilt-series loaders, HDF5 results/checkpoint files, sharded saves.

Mirrors the reference conventions so files interchange:
  * `load_h5_data`: h5 files with `tiltSeries` + `tiltAngles` datasets
    (cpu/utils/pytvlib.py:132-145).
  * `save_results`: HDF5 with a `parameters` group of hyperparameter
    attrs, a `results` group of convergence curves, and a
    `Reconstruction/recon` dataset (pytvlib.py:97-139).
  * checkpoint/resume for dynamic experiments (recon + dd/tv history,
    cpu/utils/logger.py:184-233).

The MPI-parallel HDF5 hyperslab path (mpi_astra_ctvlib.cpp:439-469) maps
to process-0 gather for small volumes and an orbax/tensorstore sharded
checkpoint (`save_sharded` / `load_sharded`) for pod-scale arrays.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np


# ------------------------------------------------------------ loaders -----


def load_h5_data(path: str, series_key: str = "tiltSeries",
                 angles_key: str = "tiltAngles") -> Tuple[np.ndarray, np.ndarray]:
    """Returns (tilt_series (Nslice, Nray, Nangles), angles_deg)."""
    import h5py

    with h5py.File(path, "r") as f:
        series = np.asarray(f[series_key], np.float32)
        angles = np.asarray(f[angles_key], np.float64)
    return series, angles


def load_tilt_series(path: str) -> np.ndarray:
    """tiff/npy loaders with the reference's axis convention
    (cpu/utils/pytvlib.py:147-169: tiff stacks arrive (z,y,x) and are
    swapped to put the tilt axis first)."""
    if path.endswith((".npy",)):
        return np.load(path).astype(np.float32)
    if path.endswith((".tif", ".tiff")):
        from PIL import Image

        im = Image.open(path)
        frames = []
        for k in range(getattr(im, "n_frames", 1)):
            im.seek(k)
            frames.append(np.asarray(im, np.float32))
        arr = np.stack(frames)
        return np.swapaxes(arr, 0, 2)
    raise ValueError(f"unsupported tilt-series file: {path}")


# ------------------------------------------------------------- savers -----


def save_results(
    path: str,
    meta: Optional[Dict] = None,
    results: Optional[Dict] = None,
    recon: Optional[np.ndarray] = None,
):
    """Reference-layout results file (pytvlib.py:120-139)."""
    import h5py

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, "w") as f:
        if meta:
            params = f.create_group("parameters")
            for key, item in meta.items():
                params.attrs[key] = item
        if results:
            conv = f.create_group("results")
            for key, item in results.items():
                conv.create_dataset(key, dtype=np.float32, data=np.asarray(item))
        if recon is not None:
            recon = np.asarray(recon)
            grp = f.create_group("Reconstruction")
            grp.create_dataset("recon", dtype=np.float32, data=recon)
            grp.attrs["Nslice"] = recon.shape[0]
            grp.attrs["Nray"] = recon.shape[1]


def load_results(path: str):
    """Returns (recon or None, results dict, parameters dict)."""
    import h5py

    with h5py.File(path, "r") as f:
        recon = None
        if "Reconstruction" in f:
            recon = np.asarray(f["Reconstruction"]["recon"], np.float32)
        results = {}
        if "results" in f:
            results = {k: np.asarray(v) for k, v in f["results"].items()}
        params = {}
        if "parameters" in f:
            params = dict(f["parameters"].attrs)
    return recon, results, params


# -------------------------------------------- checkpoint / resume ---------


def save_checkpoint(path: str, recon, history: Dict, params: Optional[Dict] = None):
    """Dynamic-experiment checkpoint (logger.py:216-233): recon + metric
    history, resumable mid-acquisition. recon=None writes a history-only
    sidecar (the sharded streaming path stores the volume separately via
    `save_sharded`)."""
    save_results(
        path, meta=params or {}, results=history,
        recon=None if recon is None else np.asarray(recon),
    )


def load_checkpoint(path: str):
    recon, results, params = load_results(path)
    return recon, results, params


# ------------------------------------------- sharded (pod-scale) I/O ------


def save_sharded(directory: str, arrays: Dict):
    """Sharded checkpoint of jax arrays via orbax/tensorstore: each host
    writes only its shards (the counterpart of the reference's parallel
    HDF5 hyperslab writes, mpi_astra_ctvlib.cpp:439-469)."""
    import orbax.checkpoint as ocp

    path = os.path.abspath(directory)
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path, arrays, force=True)
    ckptr.wait_until_finished()


def load_sharded(directory: str, like: Dict):
    """Restore with the shardings of the `like` pytree of abstract arrays."""
    import jax
    import orbax.checkpoint as ocp

    path = os.path.abspath(directory)
    ckptr = ocp.StandardCheckpointer()
    target = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=x.sharding)
        if hasattr(x, "sharding")
        else jax.ShapeDtypeStruct(np.shape(x), np.asarray(x).dtype),
        like,
    )
    return ckptr.restore(path, target)
