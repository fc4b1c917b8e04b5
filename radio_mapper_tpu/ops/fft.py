"""The framework's FFT entry points, on XLA's native FFT.

Every transform in the pipeline goes through this module: the complex
``fft``/``ifft`` used by the complex-dtype paths, and ``fft_re_im`` /
``ifft_re_im`` for the split (re, im) float32 paths that the uint8
ingest feeds. All of them lower to XLA's FFT op, which is cuFFT on the
GPU and DUCC on the CPU. The split forms assemble a complex64 array,
transform it and take it apart again; XLA fuses the assembly into the
surrounding elementwise work.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import jax
import jax.numpy as jnp


@lru_cache(maxsize=None)
def friendly_fft_len(min_len: int) -> int:
    """Smallest 5-smooth (2^a·3^b·5^c) length ≥ min_len.

    cuFFT runs 2-3-5-smooth lengths with its fast radix kernels, so
    padding to the next smooth composite (≤ ~8% oversize) costs far less
    than padding to the next power of two (up to 2× oversize): the
    flagship's 16896-sample minimum pads to 17280, not 32768.
    """
    best = 1 << (int(min_len) - 1).bit_length()  # pow2 fallback
    p5 = 1
    while p5 < best:
        p3 = p5
        while p3 < best:
            p2 = p3
            while p2 < min_len:
                p2 *= 2
            if p2 < best:
                best = p2
            p3 *= 3
        p5 *= 5
    return best


def fft(x: jnp.ndarray, n: Optional[int] = None, axis: int = -1) -> jnp.ndarray:
    """``jnp.fft.fft`` over one axis, zero-padded or trimmed to ``n``."""
    return jnp.fft.fft(x, n=n, axis=axis)


def ifft(x: jnp.ndarray, n: Optional[int] = None, axis: int = -1) -> jnp.ndarray:
    """``jnp.fft.ifft`` over one axis, zero-padded or trimmed to ``n``."""
    return jnp.fft.ifft(x, n=n, axis=axis)


def _join(re: jnp.ndarray, im: jnp.ndarray) -> jnp.ndarray:
    return jax.lax.complex(re.astype(jnp.float32), im.astype(jnp.float32))


def _split(z: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    return jnp.real(z), jnp.imag(z)


def fft_re_im(
    re: jnp.ndarray, im: jnp.ndarray, n: Optional[int] = None
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Forward FFT over the last axis of an (re, im) float32 pair,
    zero-padded or trimmed to ``n``."""
    return _split(jnp.fft.fft(_join(re, im), n=n, axis=-1))


def ifft_re_im(
    re: jnp.ndarray, im: jnp.ndarray, n: Optional[int] = None
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Inverse FFT (1/N normalised) over the last axis of an (re, im)
    pair, zero-padded or trimmed to ``n``."""
    return _split(jnp.fft.ifft(_join(re, im), n=n, axis=-1))
