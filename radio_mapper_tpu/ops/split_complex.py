"""Split-complex (re, im) float32 versions of the hot pipeline stages.

The uint8 ingest decodes straight into (re, im) float32 planes, and the
block pipeline's entry points take them in that form
(:meth:`models.pipeline.TDOAPipeline.step_split`). This module provides
the detect + GCC-PHAT chain and the channelizer on those pairs, sharing
the transforms of :mod:`radio_mapper_tpu.ops.fft`.

Numerically identical to the complex path (same operations in the same
order); tested against it (≤1e-5) on CPU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax.numpy as jnp

from radio_mapper_tpu.ops import channelizer as pfb
from radio_mapper_tpu.ops import fft as fft_ops
from radio_mapper_tpu.ops import gcc_phat as gcc
from radio_mapper_tpu.ops import safe
from radio_mapper_tpu.ops.iq import UINT8_OFFSET


class CorrelationPeakSC(NamedTuple):
    lag_samples: jnp.ndarray
    tau_s: jnp.ndarray
    peak_value: jnp.ndarray
    psr: jnp.ndarray


def decode_uint8_split(raw: jnp.ndarray, *, scale: float = 1.0) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """uint8 interleaved I/Q → (re, im) float32 (no complex dtype)."""
    f = (raw.astype(jnp.float32) - UINT8_OFFSET) * jnp.float32(scale)
    d = f.reshape(*f.shape[:-1], f.shape[-1] // 2, 2)
    return d[..., 0], d[..., 1]


def power_spectrum_db_split(re: jnp.ndarray, im: jnp.ndarray) -> jnp.ndarray:
    """20·log10|FFT| from split parts (matches spectral.power_spectrum_db)."""
    fre, fim = fft_ops.fft_re_im(re, im)
    return 10.0 * jnp.log10(fre * fre + fim * fim + 1e-24)


def cross_correlate_split(
    xre: jnp.ndarray, xim: jnp.ndarray,
    yre: jnp.ndarray, yim: jnp.ndarray,
    *,
    max_lag: int,
    weighting: str = "phat",
    eps: float = 0.05,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Split-complex mirror of :func:`radio_mapper_tpu.ops.gcc_phat.cross_correlate`."""
    xfr, xfi, _ = receiver_spectra_split(xre, xim, max_lag=max_lag)
    yfr, yfi, _ = receiver_spectra_split(yre, yim, max_lag=max_lag)
    rre, rim = _weighted_cross_spectrum(xfr, xfi, yfr, yfi, weighting, eps)
    cre, cim = fft_ops.ifft_re_im(rre, rim)
    return _lag_window(cre, max_lag), _lag_window(cim, max_lag)


def _weighted_cross_spectrum(xfr, xfi, yfr, yfi, weighting: str, eps: float):
    """R = X·conj(Y) with the GCC weighting (phat/scot/roth/cc) applied."""
    rre = xfr * yfr + xfi * yfi
    rim = xfi * yfr - xfr * yfi
    if weighting == "cc":
        return rre, rim
    if weighting == "phat":
        denom_base = jnp.sqrt(rre * rre + rim * rim)
    elif weighting == "scot":
        denom_base = jnp.sqrt((xfr * xfr + xfi * xfi) * (yfr * yfr + yfi * yfi))
    elif weighting == "roth":
        denom_base = xfr * xfr + xfi * xfi
    else:
        raise ValueError(f"unknown weighting {weighting!r}")
    scale = jnp.max(denom_base, axis=-1, keepdims=True)
    denom = denom_base + eps * scale + 1e-30
    return rre / denom, rim / denom


def _lag_window(a: jnp.ndarray, max_lag: int) -> jnp.ndarray:
    """Circular correlation → lags −max_lag..max_lag on the last axis."""
    nfft = a.shape[-1]
    return jnp.concatenate([a[..., nfft - max_lag :], a[..., : max_lag + 1]], axis=-1)


def gcc_phat_split(
    xre, xim, yre, yim,
    *,
    sample_rate_hz: float,
    max_lag: int,
    weighting: str = "phat",
    eps: float = 0.05,
    psr_exclude: int = 8,
) -> CorrelationPeakSC:
    cre, cim = cross_correlate_split(
        xre, xim, yre, yim, max_lag=max_lag, weighting=weighting, eps=eps
    )
    m = jnp.sqrt(cre * cre + cim * cim)
    k = safe.argmax_last(m) if safe.enabled() else jnp.argmax(m, axis=-1)
    delta = gcc.parabolic_refine(m, k)
    lag = k.astype(jnp.float32) - jnp.float32(max_lag) + delta
    peak = (
        safe.take1_last(m, k)
        if safe.enabled()
        else jnp.take_along_axis(m, k[..., None], axis=-1)[..., 0]
    )
    return CorrelationPeakSC(
        lag_samples=lag,
        tau_s=lag / jnp.float32(sample_rate_hz),
        peak_value=peak,
        psr=gcc.peak_to_sidelobe(m, k, exclude=psr_exclude),
    )


def receiver_spectra_split(
    sig_re: jnp.ndarray, sig_im: jnp.ndarray, *, max_lag: int
) -> Tuple[jnp.ndarray, jnp.ndarray, int]:
    """Padded per-receiver spectra for GCC: ``(fr, fi, nfft)``.

    Exposed separately so callers can REUSE the spectra: when the block
    length is a power of two the pad goes to exactly 2N, and the even bins
    of the padded transform equal the plain N-point FFT bit-for-bit —
    i.e. the detector's power spectrum falls out of the correlation FFTs
    for free (see TDOAPipeline.step_split).
    """
    n = sig_re.shape[-1]
    if max_lag >= n:
        raise ValueError(f"max_lag {max_lag} must be < block length {n}")
    nfft = fft_ops.friendly_fft_len(n + max_lag)
    fr, fi = fft_ops.fft_re_im(sig_re, sig_im, n=nfft)
    return fr, fi, nfft


def gcc_phat_all_pairs_split(
    sig_re: jnp.ndarray,
    sig_im: jnp.ndarray,
    *,
    sample_rate_hz: float,
    max_lag: int,
    weighting: str = "phat",
    eps: float = 0.05,
    psr_exclude: int = 8,
    spectra: "Optional[Tuple[jnp.ndarray, jnp.ndarray, int]]" = None,
) -> CorrelationPeakSC:
    """All-pairs over the receiver axis; inputs ``[..., B, N]`` f32 pairs.

    Each receiver's padded spectrum is computed ONCE (B forward FFTs) and
    pairs combine the cached spectra — vs. 2·P forward FFTs when calling
    the pairwise API in a loop. For 8 receivers (28 pairs) that removes
    ~60% of the FFT work in the hot loop. Pass ``spectra`` (from
    :func:`receiver_spectra_split`) to skip even those B transforms.
    """
    b = sig_re.shape[-2]
    fr, fi, nfft = (
        spectra
        if spectra is not None
        else receiver_spectra_split(sig_re, sig_im, max_lag=max_lag)
    )
    if nfft < sig_re.shape[-1] + max_lag or fr.shape[-1] != nfft:
        raise ValueError(
            f"provided spectra (nfft={nfft}, last dim {fr.shape[-1]}) violate the "
            f"alias-free bound for block {sig_re.shape[-1]} + max_lag {max_lag}"
        )

    i_idx, j_idx = gcc.pair_indices(b)
    m = pair_lag_mags(
        fr, fi, i_idx, j_idx, max_lag=max_lag, weighting=weighting, eps=eps
    )
    return CorrelationPeakSC(*gcc.peaks_from_lag_mags(
        m, sample_rate_hz=sample_rate_hz, max_lag=max_lag, psr_exclude=psr_exclude
    ))


def pair_lag_mags(
    fr: jnp.ndarray,
    fi: jnp.ndarray,
    i_idx,
    j_idx,
    *,
    max_lag: int,
    weighting: str = "phat",
    eps: float = 0.05,
) -> jnp.ndarray:
    """Pair stage on per-receiver spectra ``[..., B, nfft]``.

    Gathers pair k's spectra (``i_idx[k]``, ``j_idx[k]``; static or
    traced indices), forms R = X·conj(Y), applies the weighting, inverse
    transforms and returns ``|r|`` at lags −max_lag..max_lag,
    ``[..., P, 2·max_lag+1]``.
    """
    gi = lambda a: jnp.take(a, jnp.asarray(i_idx), axis=-2)
    gj = lambda a: jnp.take(a, jnp.asarray(j_idx), axis=-2)
    rre, rim = _weighted_cross_spectrum(gi(fr), gi(fi), gj(fr), gj(fi), weighting, eps)
    cre, cim = fft_ops.ifft_re_im(rre, rim)
    cre, cim = _lag_window(cre, max_lag), _lag_window(cim, max_lag)
    return jnp.sqrt(cre * cre + cim * cim)


def channelize_split(
    re: jnp.ndarray,
    im: jnp.ndarray,
    num_channels: int,
    *,
    sample_rate_hz: float,
    taps_per_channel: int = 8,
    shift: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Split-complex polyphase channelizer (mirrors ops.channelizer).

    The prototype filter is real, so filtering applies to each part
    independently; only the branch FFT mixes them. Returns
    ``(ch_re, ch_im)`` of shape ``[..., M, F]``.
    """
    m, t = num_channels, taps_per_channel
    n = re.shape[-1]
    if n % m != 0:
        raise ValueError(f"block length {n} must be a multiple of num_channels {m}")
    num_cols = n // m
    num_frames = num_cols - t + 1
    if num_frames <= 0:
        raise ValueError(f"need at least {m * t} samples, got {n}")
    h = jnp.asarray(pfb.prototype_filter(m, t))

    def filter_part(x):
        cols = x.reshape(*x.shape[:-1], num_cols, m)
        # T shifted multiply-adds — no [F, T, M] frame materialization
        # (~4 GB of HBM traffic at the config-4 shape; see
        # pfb.polyphase_filter_apply).
        return pfb.polyphase_filter_apply(cols, h, num_frames)

    fre, fim = filter_part(re), filter_part(im)
    cre, cim = fft_ops.fft_re_im(fre, fim)  # branch FFT over M
    cre = jnp.moveaxis(cre, -1, -2)
    cim = jnp.moveaxis(cim, -1, -2)
    if shift:
        # fftshift is a pure rotation
        cre = jnp.roll(cre, m // 2, axis=-2)
        cim = jnp.roll(cim, m // 2, axis=-2)
    return cre, cim
