"""uint8 interleaved I/Q codec.

RTL-SDR dongles emit unsigned 8-bit samples interleaved ``I0 Q0 I1 Q1 ...``
centered at 127.5; the reference decodes them as
``(u8 - 127.5) -> I + jQ`` (``buoy_node.py:392-398``,
``iq_stream_client.py:134-159``, ``signal_analyzer.py:27-36``).

The decode runs on device: the raw ``uint8`` bytes are the cheapest
thing to copy into device memory (1 byte/sample-component vs 8 for complex64), so ingest
ships bytes and this module widens them next to the compute. All functions are
jit-friendly and operate on arbitrary leading batch dims.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Decode offset used by the reference (`buoy_node.py:394`).
UINT8_OFFSET = 127.5
# Full-scale normalization: ±127.5 maps to ±1.0.
UINT8_SCALE = 1.0 / 127.5


def decode_uint8_iq(raw: jax.Array, *, scale: float = 1.0) -> jax.Array:
    """Decode interleaved uint8 I/Q to complex64.

    Args:
      raw: ``[..., 2*N]`` uint8 (or any integer dtype) interleaved I/Q.
      scale: multiplier applied after centering. ``1.0`` reproduces the
        reference's raw-count units (its "dBm" figures are
        ``20*log10(|FFT|)`` of these counts, ``buoy_node.py:404``);
        ``UINT8_SCALE`` gives unit full-scale.

    Returns:
      ``[..., N]`` complex64 baseband samples.
    """
    if raw.shape[-1] % 2 != 0:
        raise ValueError(f"interleaved I/Q length must be even, got {raw.shape[-1]}")
    f = (raw.astype(jnp.float32) - UINT8_OFFSET) * jnp.float32(scale)
    deinterleaved = f.reshape(*f.shape[:-1], f.shape[-1] // 2, 2)
    return jax.lax.complex(deinterleaved[..., 0], deinterleaved[..., 1])


def encode_uint8_iq(iq: jax.Array, *, scale: float = 1.0) -> jax.Array:
    """Inverse of :func:`decode_uint8_iq` (with saturation to [0, 255])."""
    i = jnp.real(iq) / scale + UINT8_OFFSET
    q = jnp.imag(iq) / scale + UINT8_OFFSET
    interleaved = jnp.stack([i, q], axis=-1).reshape(*iq.shape[:-1], 2 * iq.shape[-1])
    return jnp.clip(jnp.round(interleaved), 0.0, 255.0).astype(jnp.uint8)


def encode_uint8_iq_numpy(iq: np.ndarray, *, scale: float = 1.0) -> np.ndarray:
    """Host-side (numpy) encoder — for network/file IO paths that must not
    touch the accelerator (the jnp version would round-trip every chunk
    through the device)."""
    i = np.clip(np.round(np.real(iq) / scale + UINT8_OFFSET), 0, 255)
    q = np.clip(np.round(np.imag(iq) / scale + UINT8_OFFSET), 0, 255)
    out = np.empty((*np.shape(iq)[:-1], 2 * np.shape(iq)[-1]), dtype=np.uint8)
    out[..., 0::2] = i.astype(np.uint8)
    out[..., 1::2] = q.astype(np.uint8)
    return out


def decode_uint8_iq_numpy(raw: np.ndarray, *, scale: float = 1.0) -> np.ndarray:
    """NumPy float64 golden-model decode (for tests and offline tools)."""
    f = (raw.astype(np.float64) - UINT8_OFFSET) * scale
    return (f[..., 0::2] + 1j * f[..., 1::2]).astype(np.complex128)


def load_iq_bin(path: str, *, scale: float = 1.0) -> np.ndarray:
    """Load a raw ``.bin`` capture file (uint8 interleaved I/Q).

    File format parity with `sdr_capture.py:24-26` / `signal_analyzer.py:14-45`.
    """
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.size % 2 != 0:
        raw = raw[:-1]
    return decode_uint8_iq_numpy(raw, scale=scale)


def save_iq_bin(path: str, iq: np.ndarray, *, scale: float = 1.0) -> None:
    """Write complex samples as a raw uint8 interleaved capture file."""
    i = np.clip(np.round(np.real(iq) / scale + UINT8_OFFSET), 0, 255)
    q = np.clip(np.round(np.imag(iq) / scale + UINT8_OFFSET), 0, 255)
    out = np.empty(2 * iq.size, dtype=np.uint8)
    out[0::2] = i.astype(np.uint8)
    out[1::2] = q.astype(np.uint8)
    out.tofile(path)
