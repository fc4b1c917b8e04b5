"""Batched GCC-PHAT cross-correlation with sub-sample peak interpolation.

This is the framework's core TDOA measurement kernel — the capability the
reference *specifies* but never ships: its docs call for waveform
cross-correlation (`Documents/TDOA_README.md:66-67`) and it imports
`scipy.signal.correlate` without using it (`tdoa_processor.py:20`); what it
actually does is difference coarse detection timestamps
(`tdoa_processor.py:166-170`). Here the time difference of arrival between
two receivers is measured from the waveforms themselves:

    R(f)   = X(f) · conj(Y(f))            (cross-power spectrum)
    W(f)   = 1 / |R(f)|                   (PHAT whitening)
    r(τ)   = IFFT(W · R)                  (generalized cross-correlation)
    τ̂      = argmax |r| + parabolic sub-sample refinement

Everything is batched over arbitrary leading dims and all shapes are static:
FFT length is padded so the ±max_lag region is free of circular aliasing,
and the peak search is a fixed-size top-k over 2·max_lag+1 lags. The
FFTs run as XLA's native FFT (cuFFT on the GPU) and the whitening/multiply fuse into the
surrounding elementwise ops.

A float64 NumPy golden model (:func:`radio_mapper_tpu.golden.gcc_phat_numpy`)
implements the same math for the sub-0.1-sample parity tests.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from radio_mapper_tpu.ops import fft as fft_ops
from radio_mapper_tpu.ops import safe

WEIGHTINGS = ("cc", "phat", "scot", "roth")


def next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


class CorrelationPeak(NamedTuple):
    """Result of a (batched) GCC peak pick; fields are ``[...]`` shaped."""

    lag_samples: jnp.ndarray  # float32 — sub-sample lag of x relative to y
    tau_s: jnp.ndarray  # float32 — lag / sample_rate
    peak_value: jnp.ndarray  # float32 — |r| at the (integer) peak
    psr: jnp.ndarray  # float32 — peak-to-sidelobe ratio (quality metric)


def _weight_cross_spectrum(
    r: jnp.ndarray, x_f: jnp.ndarray, y_f: jnp.ndarray, weighting: str, eps: float
) -> jnp.ndarray:
    """Apply a generalized cross-correlation weighting to R = X·conj(Y).

    The whitening is *magnitude-gated*: the regularizer is ``eps`` relative
    to the per-spectrum peak magnitude, so bins whose cross-power is far
    below the strongest bins (noise-only regions of the band) are attenuated
    roughly in proportion to |R| instead of being whitened up to unit weight.
    Textbook PHAT (divide by |R| exactly) is catastrophically noise-dominated
    for narrowband signals in a wide capture — an RTL-SDR sees a 12.5 kHz
    voice channel inside a 2.4 MHz capture, so >99% of bins are noise. Gating
    keeps the PHAT phase-only property in-band while suppressing the rest;
    it is also scale-invariant.
    """
    if weighting == "cc":
        return r
    mag = jnp.abs(r)
    scale = jnp.max(mag, axis=-1, keepdims=True)
    if weighting == "phat":
        return r / (mag + eps * scale + 1e-30)
    if weighting == "scot":
        d = jnp.sqrt((jnp.abs(x_f) ** 2) * (jnp.abs(y_f) ** 2))
        ds = jnp.max(d, axis=-1, keepdims=True)
        return r / (d + eps * ds + 1e-30)
    if weighting == "roth":
        d = jnp.abs(x_f) ** 2
        ds = jnp.max(d, axis=-1, keepdims=True)
        return r / (d + eps * ds + 1e-30)
    raise ValueError(f"unknown weighting {weighting!r}; expected one of {WEIGHTINGS}")


def cross_correlate(
    x: jnp.ndarray,
    y: jnp.ndarray,
    *,
    max_lag: int,
    weighting: str = "phat",
    eps: float = 0.05,
) -> jnp.ndarray:
    """Generalized cross-correlation magnitude-preserving lag slice.

    Args:
      x, y: ``[..., N]`` complex baseband blocks (same shape).
      max_lag: half-width of the returned lag window.
    Returns:
      complex ``[..., 2*max_lag+1]`` correlation at lags −max_lag..+max_lag,
      where a positive lag means ``x`` is *delayed* relative to ``y``.
    """
    n = x.shape[-1]
    if max_lag >= n:
        raise ValueError(f"max_lag {max_lag} must be < block length {n}")
    nfft = fft_ops.friendly_fft_len(n + max_lag)
    x_f = fft_ops.fft(x, n=nfft, axis=-1)
    y_f = fft_ops.fft(y, n=nfft, axis=-1)
    r = x_f * jnp.conj(y_f)
    r = _weight_cross_spectrum(r, x_f, y_f, weighting, eps)
    corr = fft_ops.ifft(r, axis=-1)
    neg = corr[..., nfft - max_lag :]
    pos = corr[..., : max_lag + 1]
    return jnp.concatenate([neg, pos], axis=-1)


def parabolic_refine(m: jnp.ndarray, k: jnp.ndarray) -> jnp.ndarray:
    """Sub-sample offset from 3-point parabola through m[k−1], m[k], m[k+1].

    ``m``: ``[..., L]`` magnitudes; ``k``: ``[...]`` integer argmax. Returns
    a float offset clamped to (−1, 1); 0 at the edges or on degenerate fits.
    """
    length = m.shape[-1]
    kc = jnp.clip(k, 1, length - 2)
    if safe.enabled():
        ym1 = safe.take1_last(m, kc - 1)
        y0 = safe.take1_last(m, kc)
        yp1 = safe.take1_last(m, kc + 1)
    else:
        ym1 = jnp.take_along_axis(m, (kc - 1)[..., None], axis=-1)[..., 0]
        y0 = jnp.take_along_axis(m, kc[..., None], axis=-1)[..., 0]
        yp1 = jnp.take_along_axis(m, (kc + 1)[..., None], axis=-1)[..., 0]
    denom = ym1 - 2.0 * y0 + yp1
    delta = 0.5 * (ym1 - yp1) / jnp.where(jnp.abs(denom) < 1e-12, 1.0, denom)
    delta = jnp.where(jnp.abs(denom) < 1e-12, 0.0, delta)
    delta = jnp.clip(delta, -0.999, 0.999)
    # No refinement when the raw argmax sat on an edge of the lag window.
    return jnp.where((k >= 1) & (k <= length - 2), delta, 0.0)


def peak_to_sidelobe(m: jnp.ndarray, k: jnp.ndarray, *, exclude: int = 8) -> jnp.ndarray:
    """Peak magnitude over the largest magnitude >``exclude`` bins away.

    ``exclude`` must cover the correlation main lobe (width ≈ fs/bandwidth
    samples for a band-limited signal), otherwise the "sidelobe" reading
    lands on the lobe shoulder and the ratio saturates near 1.
    """
    length = m.shape[-1]
    idx = jnp.arange(length)
    dist = jnp.abs(idx - k[..., None])
    side = jnp.where(dist > exclude, m, -jnp.inf)
    side_max = jnp.max(side, axis=-1)
    peak = (
        safe.take1_last(m, k)
        if safe.enabled()
        else jnp.take_along_axis(m, k[..., None], axis=-1)[..., 0]
    )
    return peak / (jnp.maximum(side_max, 0.0) + 1e-12)


def peaks_from_lag_mags(
    m: jnp.ndarray,
    *,
    sample_rate_hz: float,
    max_lag: int,
    psr_exclude: int = 8,
) -> CorrelationPeak:
    """Peak pick from a ``[..., 2·max_lag+1]`` correlation-magnitude window.

    Shared tail of the split-complex, wideband and pair-EP GCC paths:
    integer argmax → parabolic sub-sample refine → PSR quality.
    """
    k = safe.argmax_last(m) if safe.enabled() else jnp.argmax(m, axis=-1)
    delta = parabolic_refine(m, k)
    lag = k.astype(jnp.float32) - jnp.float32(max_lag) + delta
    peak = (
        safe.take1_last(m, k)
        if safe.enabled()
        else jnp.take_along_axis(m, k[..., None], axis=-1)[..., 0]
    )
    return CorrelationPeak(
        lag_samples=lag,
        tau_s=lag / jnp.float32(sample_rate_hz),
        peak_value=peak,
        psr=peak_to_sidelobe(m, k, exclude=psr_exclude),
    )


def gcc_phat(
    x: jnp.ndarray,
    y: jnp.ndarray,
    *,
    sample_rate_hz: float,
    max_lag: int,
    weighting: str = "phat",
    eps: float = 0.05,
    psr_exclude: int = 8,
) -> CorrelationPeak:
    """Sub-sample TDOA between ``x`` and ``y`` (positive ⇒ x arrived later)."""
    corr = cross_correlate(x, y, max_lag=max_lag, weighting=weighting, eps=eps)
    m = jnp.abs(corr)
    k = safe.argmax_last(m) if safe.enabled() else jnp.argmax(m, axis=-1)
    delta = parabolic_refine(m, k)
    lag = k.astype(jnp.float32) - jnp.float32(max_lag) + delta
    peak = (
        safe.take1_last(m, k)
        if safe.enabled()
        else jnp.take_along_axis(m, k[..., None], axis=-1)[..., 0]
    )
    return CorrelationPeak(
        lag_samples=lag,
        tau_s=lag / jnp.float32(sample_rate_hz),
        peak_value=peak,
        psr=peak_to_sidelobe(m, k, exclude=psr_exclude),
    )


def pair_indices(num_receivers: int) -> Tuple[np.ndarray, np.ndarray]:
    """Static (i, j) index arrays for all i<j pairs (`tdoa_processor.py:156-160`)."""
    i, j = np.triu_indices(num_receivers, k=1)
    return i.astype(np.int32), j.astype(np.int32)


def gcc_phat_all_pairs(
    signals: jnp.ndarray,
    *,
    sample_rate_hz: float,
    max_lag: int,
    weighting: str = "phat",
    eps: float = 0.05,
) -> CorrelationPeak:
    """All-pairs GCC-PHAT over the receiver axis.

    Args:
      signals: ``[..., B, N]`` — B receivers' aligned blocks.
    Returns:
      :class:`CorrelationPeak` with ``[..., P]`` fields, P = B(B−1)/2,
      ordered as :func:`pair_indices`. ``lag > 0`` ⇒ receiver i heard the
      signal *later* than receiver j (x=signals[i], y=signals[j]).

    The pair axis is a pure batch axis: sharding it over a mesh axis and
    psum/all_gather-ing the peaks is how pair-parallelism scales O(B²) work
    (the reference walks pairs in a Python double loop,
    `tdoa_processor.py:156-193`).
    """
    n = signals.shape[-1]
    if max_lag >= n:
        raise ValueError(f"max_lag {max_lag} must be < block length {n}")
    b = signals.shape[-2]
    nfft = fft_ops.friendly_fft_len(n + max_lag)
    # Per-receiver spectra computed once (B FFTs), pairs combine them —
    # not 2·P redundant forward transforms.
    spectra = fft_ops.fft(signals, n=nfft, axis=-1)
    i_idx, j_idx = pair_indices(b)
    x_f = jnp.take(spectra, jnp.asarray(i_idx), axis=-2)
    y_f = jnp.take(spectra, jnp.asarray(j_idx), axis=-2)
    r = x_f * jnp.conj(y_f)
    r = _weight_cross_spectrum(r, x_f, y_f, weighting, eps)
    corr = fft_ops.ifft(r, axis=-1)
    corr = jnp.concatenate(
        [corr[..., nfft - max_lag :], corr[..., : max_lag + 1]], axis=-1
    )
    m = jnp.abs(corr)
    k = safe.argmax_last(m) if safe.enabled() else jnp.argmax(m, axis=-1)
    delta = parabolic_refine(m, k)
    lag = k.astype(jnp.float32) - jnp.float32(max_lag) + delta
    peak = (
        safe.take1_last(m, k)
        if safe.enabled()
        else jnp.take_along_axis(m, k[..., None], axis=-1)[..., 0]
    )
    return CorrelationPeak(
        lag_samples=lag,
        tau_s=lag / jnp.float32(sample_rate_hz),
        peak_value=peak,
        psr=peak_to_sidelobe(m, k),
    )


def gcc_phat_all_pairs_coherent(
    signals: jnp.ndarray,
    *,
    sample_rate_hz: float,
    max_lag: int,
    num_blocks: int,
    weighting: str = "phat",
    eps: float = 0.05,
) -> CorrelationPeak:
    """All-pairs GCC-PHAT with coherent cross-spectrum integration.

    Splits each receiver's capture into ``num_blocks`` consecutive dwells
    and *averages the pair cross-spectra across dwells before* whitening
    and the inverse transform:

        R̄_ij(f) = (1/K) Σ_k X_ik(f)·conj(X_jk(f))

    The geometry phase e^{−j2πfτ} is identical in every dwell while noise
    cross-terms are random, so R̄ keeps the full capture's τ information
    at 1/K the FFT length — the memory-light alternative to one long
    correlation: nfft stays ~n instead of ~K·n, so memory per FFT row
    shrinks K× (measured equal fix accuracy to the K·n-long correlation
    for *stationary* signals, e.g. 20 kHz noise-like at 5 dB SNR:
    97.3 m median both ways at K ∈ {1, 4, 16}).

    Scope (measured, tests/test_gcc_phat.py): valid for signals that are
    wide-sense stationary across dwells. For SWEPT narrowband signals
    (ELT audio sweeps) it *degrades* accuracy: each dwell sees a
    quasi-monochromatic slice, whose whitened per-bin phase SNR drops √K
    versus the long transform that concentrates the sweep into one sharp
    ridge (5 kHz chirp @22 dB: 1319 m at K=1 → 3011 m at K=4). Narrowband
    beacons want `PipelineConfig.correlation_dwells` — ONE coherent
    correlation over the concatenated capture — instead.

    Args:
      signals: ``[..., B, K·N]`` — receivers' aligned long captures.
      num_blocks: K consecutive dwells to integrate (must divide the
        capture length). τ is assumed constant across the capture
        (static-emitter dwell scale; K·N/fs ≪ any motion timescale).
    """
    n_total = signals.shape[-1]
    if n_total % num_blocks:
        raise ValueError(f"capture {n_total} not divisible into {num_blocks} blocks")
    n = n_total // num_blocks
    if max_lag >= n:
        raise ValueError(f"max_lag {max_lag} must be < per-block length {n}")
    b = signals.shape[-2]
    nfft = fft_ops.friendly_fft_len(n + max_lag)
    blocks = signals.reshape(*signals.shape[:-1], num_blocks, n)  # [..., B, K, n]
    spectra = fft_ops.fft(blocks, n=nfft, axis=-1)  # [..., B, K, nfft]
    i_idx, j_idx = pair_indices(b)
    x_f = jnp.take(spectra, jnp.asarray(i_idx), axis=-3)  # [..., P, K, nfft]
    y_f = jnp.take(spectra, jnp.asarray(j_idx), axis=-3)
    r = jnp.mean(x_f * jnp.conj(y_f), axis=-2)  # [..., P, nfft]
    # scot/roth denominators use the dwell-averaged auto-powers.
    xa = jnp.sqrt(jnp.mean(jnp.abs(x_f) ** 2, axis=-2))
    ya = jnp.sqrt(jnp.mean(jnp.abs(y_f) ** 2, axis=-2))
    r = _weight_cross_spectrum(r, xa, ya, weighting, eps)
    corr = fft_ops.ifft(r, axis=-1)
    corr = jnp.concatenate(
        [corr[..., nfft - max_lag :], corr[..., : max_lag + 1]], axis=-1
    )
    return peaks_from_lag_mags(
        jnp.abs(corr), sample_rate_hz=sample_rate_hz, max_lag=max_lag
    )
