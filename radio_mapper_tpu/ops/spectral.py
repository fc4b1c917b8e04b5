"""Batched spectral analysis: power spectra, Welch averaging, spectrograms.

Batched replacement for the per-block FFT analysis scattered through the
reference (`buoy_node.py:401-405`, `iq_stream_client.py:181-195`,
`signal_analyzer.py:47-86`, `Code/src/rtl_power.c:631-710`). Everything is
batched over arbitrary leading dims so hundreds of channels FFT in one XLA
call, and all shapes are static.

Conventions:
  * complex baseband input ``[..., N]``
  * un-shifted spectra (DC at bin 0) by default, matching the reference's
    detector which runs `find_peaks` on the raw FFT order
    (`buoy_node.py:401-415`); helpers to fftshift for display.
  * power in dB: ``20*log10(|X| + eps)`` with the reference's
    ``eps = 1e-12`` guard (`buoy_node.py:404`).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from radio_mapper_tpu.ops import fft as fft_ops
import numpy as np

from radio_mapper_tpu.ops.windows import get_window

DB_EPS = 1e-12


def power_spectrum_db(
    iq: jnp.ndarray,
    *,
    window: Optional[str] = None,
    nfft: Optional[int] = None,
    shift: bool = False,
) -> jnp.ndarray:
    """``20*log10(|FFT(iq)|)`` over the last axis.

    With ``window=None`` and ``nfft=None`` this reproduces the reference
    detector's spectrum (`buoy_node.py:401-404`) bit-for-bit in float32.
    """
    n = iq.shape[-1]
    if window is not None:
        iq = iq * jnp.asarray(get_window(window, n))
    x = fft_ops.fft(iq, n=nfft, axis=-1)
    if shift:
        x = jnp.fft.fftshift(x, axes=-1)
    return 20.0 * jnp.log10(jnp.abs(x) + DB_EPS)


def fft_frequencies_hz(n: int, sample_rate_hz: float, *, shift: bool = False) -> np.ndarray:
    """Baseband bin frequencies for an ``n``-point FFT (NumPy; static)."""
    f = np.fft.fftfreq(n, d=1.0 / sample_rate_hz)
    return np.fft.fftshift(f) if shift else f


def absolute_frequencies_hz(
    n: int, sample_rate_hz: float, center_frequency_hz: float, *, shift: bool = False
) -> np.ndarray:
    """Absolute RF frequency per bin (`buoy_node.py:407`)."""
    return fft_frequencies_hz(n, sample_rate_hz, shift=shift) + center_frequency_hz


def frame_signal(iq: jnp.ndarray, frame_len: int, hop: int) -> jnp.ndarray:
    """Split ``[..., N]`` into overlapping frames ``[..., num_frames, frame_len]``.

    Static frame count; trailing remainder is dropped (the streaming layer
    carries it into the next block instead).
    """
    n = iq.shape[-1]
    num_frames = 1 + (n - frame_len) // hop if n >= frame_len else 0
    if num_frames <= 0:
        raise ValueError(f"signal length {n} < frame_len {frame_len}")
    # Gather via strided reshape: indices are static so XLA lowers this to a
    # cheap gather/reshape rather than a dynamic loop.
    idx = (np.arange(num_frames)[:, None] * hop + np.arange(frame_len)[None, :])
    return iq[..., idx]


def welch_psd_db(
    iq: jnp.ndarray,
    *,
    nfft: int = 1024,
    overlap: float = 0.5,
    window: str = "hann",
    shift: bool = True,
    reduce: str = "mean",
) -> jnp.ndarray:
    """Welch-averaged power spectral density in dB, ``[..., nfft]``.

    The reference configures ``fft_size: 1024, overlap: 0.5``
    (`config.yaml:102-103`) but never implements averaging; `rtl_power`
    accumulates |X|^2 over an integration interval
    (`Code/src/rtl_power.c:700-708`). This is the batched equivalent.
    ``reduce="peak"`` keeps the per-bin maximum across frames instead of
    the mean — rtl_power's peak-hold mode (``-P``, `rtl_power.c:703-706`).
    """
    if reduce not in ("mean", "peak"):
        raise ValueError(f"unknown reduce {reduce!r}")
    hop = max(1, int(nfft * (1.0 - overlap)))
    frames = frame_signal(iq, nfft, hop)
    w = jnp.asarray(get_window(window, nfft))
    spec = fft_ops.fft(frames * w, axis=-1)
    mag2 = jnp.abs(spec) ** 2
    p = jnp.max(mag2, axis=-2) if reduce == "peak" else jnp.mean(mag2, axis=-2)
    if shift:
        p = jnp.fft.fftshift(p, axes=-1)
    return 10.0 * jnp.log10(p + DB_EPS)


def spectrogram_db(
    iq: jnp.ndarray,
    *,
    nfft: int = 1024,
    overlap: float = 0.5,
    window: str = "hann",
    shift: bool = True,
) -> jnp.ndarray:
    """Per-frame power spectra ``[..., num_frames, nfft]`` in dB."""
    hop = max(1, int(nfft * (1.0 - overlap)))
    frames = frame_signal(iq, nfft, hop)
    w = jnp.asarray(get_window(window, nfft))
    spec = fft_ops.fft(frames * w, axis=-1)
    if shift:
        spec = jnp.fft.fftshift(spec, axes=-1)
    return 20.0 * jnp.log10(jnp.abs(spec) + DB_EPS)


def estimate_bandwidth_hz(
    power_db: jnp.ndarray,
    peak_bin: jnp.ndarray,
    sample_rate_hz: float,
    *,
    drop_db: float = 3.0,
    max_halfwidth_bins: int = 256,
    smooth_bins: int = 1,
) -> jnp.ndarray:
    """−3 dB bandwidth around a peak bin (vectorized, static shapes).

    Capability parity with `iq_stream_client.py:254-278`, which walks left and
    right from the peak until power drops 3 dB. Here the walk is a masked
    reduction over a fixed ±``max_halfwidth_bins`` neighborhood so it stays
    jit-compatible and batched.

    Args:
      power_db: ``[..., F]`` spectra.
      peak_bin: ``[...]`` integer peak indices (broadcastable to batch dims).
      smooth_bins: odd boxcar width for pre-smoothing. Raw FFT bins of a
        noise-like signal fluctuate by tens of dB bin-to-bin, which stops
        the −3 dB walk immediately; smoothing over ~bandwidth/50 bins makes
        the estimate meaningful for modulated signals.
    Returns:
      ``[...]`` bandwidth estimate in Hz (at least one bin wide).
    """
    from radio_mapper_tpu.ops import safe

    f = power_db.shape[-1]
    if smooth_bins > 1:
        if safe.enabled():
            # Boxcar via static rolls (safe mode avoids reduce_window;
            # smooth_bins is small).
            h = smooth_bins // 2
            acc = power_db
            for d in range(1, h + 1):
                acc = acc + jnp.roll(power_db, d, axis=-1)
                acc = acc + jnp.roll(power_db, -d, axis=-1)
            power_db = acc / smooth_bins
        else:
            ndim = power_db.ndim
            window = (1,) * (ndim - 1) + (smooth_bins,)
            summed = jax.lax.reduce_window(
                power_db, 0.0, jax.lax.add, window, (1,) * ndim, padding="SAME"
            )
            power_db = summed / smooth_bins

    # Gather-free walk: the first below-threshold bin on each side is a
    # masked min-reduction over signed bin distance — comparisons and
    # reductions only, identical semantics to the ±halfwidth walk and safe
    # on runtimes where take_along_axis/argmax are not.
    peak_val = (
        safe.take1_last(power_db, peak_bin)
        if safe.enabled()
        else jnp.take_along_axis(power_db, peak_bin[..., None], axis=-1)[..., 0]
    )
    idxs = jax.lax.broadcasted_iota(jnp.int32, power_db.shape, power_db.ndim - 1)
    delta = idxs - peak_bin[..., None]
    below = power_db < (peak_val[..., None] - drop_db)
    big = jnp.int32(max_halfwidth_bins)
    first_right = jnp.minimum(
        jnp.min(jnp.where(below & (delta > 0), delta, big), axis=-1), big
    )
    first_left = jnp.minimum(
        jnp.min(jnp.where(below & (delta < 0), -delta, big), axis=-1), big
    )
    width_bins = jnp.maximum(first_right + first_left, 1)
    bin_hz = sample_rate_hz / f
    return width_bins.astype(jnp.float32) * jnp.float32(bin_hz)
