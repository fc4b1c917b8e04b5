"""Polyphase filterbank (PFB) channelizer.

The reference serializes frequency coverage in *time*: every buoy hops
through a 35 s schedule, one narrow channel per dwell
(`buoy_node.py:146-153`), and `rtl_power` hops a single dongle across a
sweep (`Code/src/rtl_power.c:427-530`). This design replaces
hopping with *simultaneity*: one wideband stream is split into M uniformly
spaced channels in a single batched op, so all monitored frequencies are
watched continuously — the channel axis then becomes a batch/shard axis.

Structure (critically sampled PFB):
  1. frame the stream into windows of M·T samples, stride M;
  2. weight by the polyphase-reshaped prototype lowpass (T taps/branch);
  3. sum the T tap blocks — an ``[F, T, M] × [T, M] → [F, M]`` contraction;
  4. FFT across the M branch axis → per-channel complex baseband at fs/M.

Steps 2–3 are T shifted multiply-adds and step 4 is XLA's batched FFT. The prototype filter is designed
once in NumPy (Kaiser-windowed sinc) and baked into the graph as a constant.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from radio_mapper_tpu.ops import fft as fft_ops


@lru_cache(maxsize=None)
def prototype_filter(num_channels: int, taps_per_channel: int = 8, beta: float = 9.0) -> np.ndarray:
    """Kaiser-windowed sinc lowpass, cutoff at the channel half-width.

    Returns ``[taps_per_channel, num_channels]`` — the polyphase matrix, and
    is normalized for unity DC gain per branch-sum.
    """
    m, t = num_channels, taps_per_channel
    n = m * t
    k = np.arange(n) - (n - 1) / 2.0
    h = np.sinc(k / m) * np.kaiser(n, beta)
    h = h / np.sum(h)
    # Polyphase decomposition: branch p takes taps p, p+M, p+2M, ...
    return (h.reshape(t, m) * m).astype(np.float32)


def polyphase_filter_apply(cols: jnp.ndarray, h: jnp.ndarray, num_frames: int) -> jnp.ndarray:
    """``filtered[..., f, m] = Σ_t cols[..., f+t, m] · h[t, m]`` as T
    shifted multiply-adds.

    The framed formulation (``cols[..., idx, :]`` → ``[..., F, T, M]``
    einsum) materializes T copies of the stream — at the config-4 shape
    that is ~4 GB of device-memory traffic. T strided slices of the SAME
    buffer read ~T× less; the T-term sum order (ascending t, f32) differs
    from the einsum's only in rounding (≤1 ulp per term).
    """
    t = h.shape[0]
    acc = cols[..., 0:num_frames, :] * h[0]
    for k in range(1, t):
        acc = acc + cols[..., k : k + num_frames, :] * h[k]
    return acc


class ChannelizedStream(NamedTuple):
    channels: jnp.ndarray  # [..., M, F] complex — per-channel baseband
    channel_offset_hz: np.ndarray  # [M] static — offset of each channel center
    channel_rate_hz: float


def channelize(
    x: jnp.ndarray,
    num_channels: int,
    *,
    sample_rate_hz: float,
    taps_per_channel: int = 8,
    shift: bool = True,
) -> ChannelizedStream:
    """Split ``[..., N]`` wideband IQ into ``num_channels`` basebands.

    N must be a multiple of ``num_channels``; the filter history shortens the
    output by ``taps_per_channel − 1`` frames (streaming callers carry those
    samples as state — see :mod:`radio_mapper_tpu.models.streaming`).

    With ``shift=True`` channels are ordered by increasing frequency offset
    (−fs/2 … +fs/2), matching a viewer's spectrum layout.
    """
    m = num_channels
    t = taps_per_channel
    n = x.shape[-1]
    if n % m != 0:
        raise ValueError(f"block length {n} must be a multiple of num_channels {m}")
    num_cols = n // m
    num_frames = num_cols - t + 1
    if num_frames <= 0:
        raise ValueError(f"need at least {m * t} samples, got {n}")

    h = jnp.asarray(prototype_filter(m, t))

    # [..., num_cols, M] — column-major polyphase layout.
    cols = x.reshape(*x.shape[:-1], num_cols, m)
    filtered = polyphase_filter_apply(cols, h.astype(x.dtype), num_frames)

    # Branch FFT; channel c of the FFT corresponds to offset c·fs/M (aliased).
    ch = fft_ops.fft(filtered, axis=-1)  # [..., F, M]
    ch = jnp.moveaxis(ch, -1, -2)  # [..., M, F]

    offsets = np.fft.fftfreq(m, d=1.0 / sample_rate_hz)
    if shift:
        order = np.argsort(np.fft.fftshift(np.arange(m)))  # inverse fftshift perm
        ch = jnp.take(ch, jnp.asarray(np.fft.fftshift(np.arange(m))), axis=-2)
        offsets = np.fft.fftshift(offsets)
        del order
    return ChannelizedStream(
        channels=ch,
        channel_offset_hz=offsets,
        channel_rate_hz=sample_rate_hz / m,
    )


def synthesize_tone_response(num_channels: int, taps_per_channel: int = 8, points: int = 512) -> np.ndarray:
    """|H(f)| of the prototype across ±2 channel widths (for tests/docs)."""
    h = prototype_filter(num_channels, taps_per_channel).reshape(-1) / num_channels
    w = np.linspace(0, 2.0 / num_channels, points)
    e = np.exp(-2j * np.pi * np.outer(w, np.arange(h.size)))
    return np.abs(e @ h)
