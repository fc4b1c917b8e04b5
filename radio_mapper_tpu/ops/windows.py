"""Window functions for spectral analysis.

Covers the window set of the reference's `rtl_power` scanner
(`Code/src/rtl_power.c:318-397`: rectangle, hamming, blackman,
blackman-harris, hann-poisson, bartlett, youssef/kaiser) implemented as
pure functions returning float32 arrays, computed eagerly with NumPy so the
coefficients are constants baked into the jit graph (they never change at
runtime — no reason to spend device cycles re-deriving them).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

_REGISTRY = {}


def _register(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


@_register("rectangle")
def rectangle(n: int) -> np.ndarray:
    return np.ones(n, dtype=np.float32)


@_register("hamming")
def hamming(n: int) -> np.ndarray:
    k = np.arange(n)
    return (0.54 - 0.46 * np.cos(2 * np.pi * k / (n - 1))).astype(np.float32)


@_register("hann")
def hann(n: int) -> np.ndarray:
    k = np.arange(n)
    return (0.5 - 0.5 * np.cos(2 * np.pi * k / (n - 1))).astype(np.float32)


@_register("blackman")
def blackman(n: int) -> np.ndarray:
    k = np.arange(n)
    x = 2 * np.pi * k / (n - 1)
    return (0.42 - 0.5 * np.cos(x) + 0.08 * np.cos(2 * x)).astype(np.float32)


@_register("blackman_harris")
def blackman_harris(n: int) -> np.ndarray:
    k = np.arange(n)
    x = 2 * np.pi * k / (n - 1)
    w = 0.35875 - 0.48829 * np.cos(x) + 0.14128 * np.cos(2 * x) - 0.01168 * np.cos(3 * x)
    return w.astype(np.float32)


@_register("hann_poisson")
def hann_poisson(n: int, alpha: float = 2.0) -> np.ndarray:
    k = np.arange(n)
    hannw = 0.5 - 0.5 * np.cos(2 * np.pi * k / (n - 1))
    poisson = np.exp(-alpha * np.abs(n - 1 - 2 * k) / (n - 1))
    return (hannw * poisson).astype(np.float32)


@_register("bartlett")
def bartlett(n: int) -> np.ndarray:
    k = np.arange(n)
    return (1.0 - np.abs(2 * k / (n - 1) - 1.0)).astype(np.float32)


@_register("kaiser")
def kaiser(n: int, beta: float = 8.6) -> np.ndarray:
    return np.kaiser(n, beta).astype(np.float32)


@lru_cache(maxsize=None)
def get_window(name: str, n: int) -> np.ndarray:
    """Look up a window by name. Cached — coefficients are jit constants."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown window {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](n)


def available_windows():
    return sorted(_REGISTRY)


def coherent_gain(name: str, n: int) -> float:
    """Mean of the window — amplitude correction factor for tones."""
    return float(np.mean(get_window(name, n)))


def noise_gain(name: str, n: int) -> float:
    """RMS gain — power correction factor for noise-like signals."""
    return float(np.sqrt(np.mean(get_window(name, n) ** 2)))
