"""FBP/WBP filter bank (frequency-domain, batched over slices+angles).

Batched replacement for ASTRA's `CCudaFilteredBackProjectionAlgorithm`
filter set used by the reference (tomofusion/gpu/utils/tomoengine.cpp:317-327
lists the accepted names; tomofusion/pytvlib.py:33-36 exposes the commonly
used subset). Filtering is a single batched rFFT->window->irFFT over the
detector axis of the whole ``(Ns, Nproj, Nray)`` sinogram.

The ramp is realized through the band-limited spatial-domain kernel
``h[0]=1/4, h[odd n]=-1/(pi n)^2, h[even]=0`` (Kak & Slaney, Ch.3), which
avoids the DC bias of a naive ``|f|`` ramp; smoothing windows are applied on
the normalized frequency ``u = |f|/f_nyq`` in ``[0, 1]``.

Window provenance (documented deviation per CLAUDE.md): the 18 names are
ASTRA's accepted list (tomoengine.cpp:317-321), but ASTRA's own window
formulas (astra-toolbox src/Filters.cpp) are NOT verifiable here — the
reference pins a custom ASTRA fork as an EMPTY git submodule
(.gitmodules:4-6; /root/reference/thirdparty/astra-toolbox contains no
sources) and this environment has no network egress. Each window
therefore uses the standard published formula for its name, cited below,
with parameter choices called out explicitly where the name alone does
not pin them:

* shepp-logan ``sinc(u/2)``, cosine ``cos(pi u/2)``, hamming
  ``0.54 + 0.46 cos(pi u)``, hann ``0.5 (1 + cos(pi u))``: the classical
  CT filter set (Kak & Slaney Ch.3; identical in ASTRA, scikit-image,
  MATLAB iradon).
* blackman / nuttall / blackman-harris / blackman-nuttall / flat-top /
  bartlett-hann / lanczos / triangular / parzen: coefficient tables from
  Harris (1978) "On the use of windows for harmonic analysis" and the
  standard DSP references (identical to scipy.signal.windows), mapped to
  one-sided frequency form ``w(u)``.
* PARAMETERIZED windows — values chosen, not ASTRA-verified:
  kaiser ``beta = 4.0`` (scipy.signal's documented example default; ASTRA
  exposes a ``Parameter`` field for it), gaussian ``sigma = 1/3`` (window
  reaches ~1% at the Nyquist edge), tukey ``alpha = 0.5`` (scipy's
  default taper fraction). If trace-parity against a specific ASTRA
  build is ever needed, match that build's parameter fields here.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def _window(name: str, u: np.ndarray) -> np.ndarray:
    """Smoothing window on normalized frequency u in [0, 1]."""
    pi = np.pi
    if name in ("ram-lak", "ramlak"):
        return np.ones_like(u)
    if name == "shepp-logan":
        return np.sinc(u / 2.0)
    if name == "cosine":
        return np.cos(pi * u / 2.0)
    if name == "hamming":
        return 0.54 + 0.46 * np.cos(pi * u)
    if name in ("hann", "hanning"):
        return 0.5 * (1.0 + np.cos(pi * u))
    if name == "tukey":
        alpha = 0.5
        w = np.ones_like(u)
        m = u > (1.0 - alpha)
        w[m] = 0.5 * (1.0 + np.cos(pi * (u[m] - (1.0 - alpha)) / alpha))
        return w
    if name == "lanczos":
        return np.sinc(u)
    if name == "triangular":
        return 1.0 - u
    if name == "gaussian":
        sigma = 1.0 / 3.0
        return np.exp(-0.5 * (u / sigma) ** 2)
    if name in ("barlett-hann", "bartlett-hann"):
        return 0.62 - 0.24 * u + 0.38 * np.cos(pi * u)
    if name == "blackman":
        return 0.42 + 0.5 * np.cos(pi * u) + 0.08 * np.cos(2 * pi * u)
    if name == "nuttall":
        return (
            0.355768
            + 0.487396 * np.cos(pi * u)
            + 0.144232 * np.cos(2 * pi * u)
            + 0.012604 * np.cos(3 * pi * u)
        )
    if name == "blackman-harris":
        return (
            0.35875
            + 0.48829 * np.cos(pi * u)
            + 0.14128 * np.cos(2 * pi * u)
            + 0.01168 * np.cos(3 * pi * u)
        )
    if name == "blackman-nuttall":
        return (
            0.3635819
            + 0.4891775 * np.cos(pi * u)
            + 0.1365995 * np.cos(2 * pi * u)
            + 0.0106411 * np.cos(3 * pi * u)
        )
    if name == "flat-top":
        return (
            0.21557895
            + 0.41663158 * np.cos(pi * u)
            + 0.277263158 * np.cos(2 * pi * u)
            + 0.083578947 * np.cos(3 * pi * u)
            + 0.006947368 * np.cos(4 * pi * u)
        )
    if name == "kaiser":
        beta = 4.0
        return np.i0(beta * np.sqrt(np.maximum(0.0, 1.0 - u**2))) / np.i0(beta)
    if name == "parzen":
        w = np.where(
            u <= 0.5, 1.0 - 6.0 * u**2 * (1.0 - u), 2.0 * (1.0 - u) ** 3
        )
        return w
    raise ValueError(f"unknown FBP filter: {name!r}")


# Full ASTRA-parity list (tomoengine.cpp:317-321) plus 'none' (plain BP).
FILTERS = (
    "none",
    "ram-lak",
    "shepp-logan",
    "cosine",
    "hamming",
    "hann",
    "tukey",
    "lanczos",
    "triangular",
    "gaussian",
    "barlett-hann",
    "blackman",
    "nuttall",
    "blackman-harris",
    "blackman-nuttall",
    "flat-top",
    "kaiser",
    "parzen",
)


def _ramp_response(m: int) -> np.ndarray:
    """rFFT of the band-limited ramp kernel of length m (even)."""
    h = np.zeros(m)
    h[0] = 0.25
    nn = np.arange(1, m // 2 + 1)
    odd = nn[nn % 2 == 1]
    h[odd] = -1.0 / (np.pi * odd) ** 2
    h[-odd] = -1.0 / (np.pi * odd) ** 2
    return np.real(np.fft.rfft(h))


def make_filter(name: str, nray: int) -> tuple[np.ndarray, int]:
    """Precompute the frequency response; returns (response, padded_len)."""
    m = max(64, int(2 ** np.ceil(np.log2(2 * nray))))
    resp = _ramp_response(m)
    freqs = np.fft.rfftfreq(m)  # cycles/sample in [0, 0.5]
    u = freqs / 0.5
    if name != "ram-lak":
        resp = resp * _window(name, u)
    return resp.astype(np.float32), m


def filter_sinogram(sino, name: str = "ram-lak"):
    """Apply the named FBP filter along the detector (last) axis.

    sino: (..., Nray). Returns the filtered sinogram, already including the
    ``pi / Nproj`` angular-integration factor *per projection is NOT
    applied here* — the FBP solver applies ``pi / (2*Nproj) * 2`` once
    (see tomojax/solvers/wbp.py).
    """
    if name == "none":
        return sino
    nray = sino.shape[-1]
    resp, m = make_filter(name, nray)
    pad = m - nray
    s = jnp.pad(sino, [(0, 0)] * (sino.ndim - 1) + [(0, pad)])
    f = jnp.fft.rfft(s, axis=-1)
    f = f * jnp.asarray(resp)
    out = jnp.fft.irfft(f, n=m, axis=-1)
    return out[..., :nray].astype(sino.dtype)
