"""Batched, static-shape spectral peak detection.

Reproduces the reference detector semantics (`buoy_node.py:401-433`):
power spectrum in dB, median noise floor, −70 dBm height threshold, minimum
peak spacing of 10 bins, DC notch of ±10 kHz around the tuned center,
confidence = SNR/20 clipped to [0, 1] with a 0.3 floor — but re-designed for
XLA: instead of scipy's dynamic-length `find_peaks` lists, detection returns
a **fixed top-K peak set with a validity mask**, so the whole
detect-across-256-channels step is one jit-compiled program with static
shapes.

Peak candidacy uses a sliding-window maximum (a bin is a candidate iff it is
the maximum of its ±min_distance neighborhood), which enforces the same
minimum spacing as `find_peaks(distance=...)` for separated peaks while
mapping to a single `lax.reduce_window`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from radio_mapper_tpu import constants
from radio_mapper_tpu.ops import safe
from radio_mapper_tpu.ops.spectral import power_spectrum_db, fft_frequencies_hz


class PeakSet(NamedTuple):
    """Fixed-size set of detected peaks; all arrays are ``[..., K]``.

    ``bin_index`` is relative to the length of the spectrum that was
    detected on (the block_len grid in the pipeline). Consumers comparing
    detections across spectrum lengths must use ``freq_offset_hz``, which
    is computed with the matching bin spacing and is portable.
    """

    bin_index: jnp.ndarray  # int32 FFT bin (un-shifted order, DC at 0)
    freq_offset_hz: jnp.ndarray  # float32 offset from tuned center
    power_db: jnp.ndarray  # float32 peak power
    snr_db: jnp.ndarray  # float32 power above median noise floor
    confidence: jnp.ndarray  # float32 in [0, 1]
    valid: jnp.ndarray  # bool — False entries are padding
    noise_floor_db: jnp.ndarray  # float32, [...] (no K axis)


def sliding_local_max(x: jnp.ndarray, radius: int) -> jnp.ndarray:
    """True where ``x`` equals the max of its ±radius window (last axis).

    Safe mode uses an exact circular sliding max (one reduce_window over
    a circularly extended axis — semantically right for spectra, whose
    bin index wraps; see safe.sliding_max); stock mode uses reduce_window
    with −inf pads.
    """
    if safe.enabled():
        return x >= safe.sliding_max(x, radius)
    w = 2 * radius + 1
    ndim = x.ndim
    window_dims = (1,) * (ndim - 1) + (w,)
    strides = (1,) * ndim
    m = jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, window_dims, strides, padding="SAME"
    )
    return x >= m


def detect_peaks(
    power_db: jnp.ndarray,
    *,
    sample_rate_hz: float,
    max_peaks: int = 8,
    threshold_db: float = constants.DEFAULT_DETECTION_THRESHOLD_DBM,
    min_distance_bins: int = constants.DEFAULT_PEAK_MIN_DISTANCE_BINS,
    dc_notch_hz: Optional[float] = constants.DEFAULT_DC_NOTCH_HZ,
    confidence_floor: float = constants.DEFAULT_CONFIDENCE_FLOOR,
    snr_fullscale_db: float = constants.DEFAULT_SNR_FULLSCALE_DB,
    noise_floor_stride: int = 1,
) -> PeakSet:
    """Find the top-K spectral peaks per batch element.

    Everything after the top-K selection is gather-free by construction:
    SNR and confidence at a peak are arithmetic in (top value − floor),
    and the FFT bin→frequency map is arithmetic in the bin index
    (``fftfreq``), so no per-peak ``take_along_axis``/one-hot pass over
    the F-length arrays is ever needed — the selection itself is the only
    op that touches the full spectrum.

    Args:
      power_db: ``[..., F]`` power spectra in dB, un-shifted bin order.
      noise_floor_stride: estimate the median noise floor from every
        S-th bin instead of all F. Noise bins are exchangeable, so a
        stride-S subsample (still thousands of bins at flagship sizes)
        moves the estimate by ≲0.1 dB while cutting the bisection's HBM
        traffic S×. 1 = exact reference semantics.
    Returns:
      :class:`PeakSet` with ``[..., max_peaks]`` fields sorted by power
      (descending); invalid slots are masked out and zero-filled.
    """
    f = power_db.shape[-1]
    freqs = fft_frequencies_hz(f, sample_rate_hz)  # static numpy

    nf_src = (
        power_db[..., ::noise_floor_stride] if noise_floor_stride > 1 else power_db
    )
    noise_floor = (
        safe.median_bisect(nf_src) if safe.enabled() else jnp.median(nf_src, axis=-1)
    )

    candidate = sliding_local_max(power_db, min_distance_bins)
    candidate = jnp.logical_and(candidate, power_db > threshold_db)
    if dc_notch_hz is not None:
        notch = np.abs(freqs) >= dc_notch_hz  # static mask (buoy_node.py:423)
        candidate = jnp.logical_and(candidate, jnp.asarray(notch))

    # Confidence gate without materializing per-bin SNR/confidence arrays:
    # clip(snr/S, 0, 1) ≥ floor ⇔ snr ≥ floor·S for floor in (0, 1].
    # floor ≤ 0 previously always passed (clip's lower bound is 0), so it
    # disables the gate; floor > 1 previously always failed.
    if confidence_floor > 1.0:
        candidate = jnp.zeros_like(candidate)
    elif confidence_floor > 0.0:
        candidate = jnp.logical_and(
            candidate,
            power_db - noise_floor[..., None]
            >= confidence_floor * snr_fullscale_db,
        )

    score = jnp.where(candidate, power_db, -jnp.inf)
    if safe.enabled():
        # Candidates are > min_distance apart (sliding-local-max), so the
        # segmented two-stage top-k is exact and ~7× cheaper in HBM
        # traffic than the flat masked-argmax iteration. EXACTLY-equal
        # candidates closer than min_distance (e.g. the mirrored pair of
        # a real-valued input's conjugate-symmetric spectrum) collapse to
        # one — which matches the reference's find_peaks(distance=10)
        # minimum-spacing contract; the flat/stock top_k would return
        # both, violating it.
        seg = 8
        if f % seg == 0 and min_distance_bins + 1 >= seg:
            top_vals, top_idx = safe.top_k_segmented(score, max_peaks, seg)
        else:
            top_vals, top_idx = safe.top_k(score, max_peaks)
    else:
        top_vals, top_idx = jax.lax.top_k(score, max_peaks)
    valid = jnp.isfinite(top_vals)
    peak_snr = top_vals - noise_floor[..., None]
    peak_conf = jnp.clip(peak_snr / snr_fullscale_db, 0.0, 1.0)
    # fftfreq arithmetically: bins ≤ (F−1)//2 are positive, the rest wrap.
    kf = top_idx.astype(jnp.float32)
    peak_freq = jnp.where(top_idx <= (f - 1) // 2, kf, kf - f) * jnp.float32(
        sample_rate_hz / f
    )

    zero = jnp.zeros_like(peak_snr)
    return PeakSet(
        bin_index=jnp.where(valid, top_idx, 0).astype(jnp.int32),
        freq_offset_hz=jnp.where(valid, peak_freq, zero),
        power_db=jnp.where(valid, top_vals, zero),
        snr_db=jnp.where(valid, peak_snr, zero),
        confidence=jnp.where(valid, peak_conf, zero),
        valid=valid,
        noise_floor_db=noise_floor,
    )


def detect_signals(
    iq: jnp.ndarray,
    *,
    sample_rate_hz: float,
    max_peaks: int = 8,
    power_offset_db: float = 0.0,
    **peak_kwargs,
) -> PeakSet:
    """Full detector: FFT power spectrum + top-K peaks, batched.

    ``power_offset_db`` calibrates the uncalibrated FFT magnitude to the
    reference's raw-count "dBm" scale: with uint8 decode at ``scale=1.0``
    and offset 0 this matches `buoy_node.py:401-433` exactly; when running on
    unit-scaled floats pass ``power_offset_db = 20*log10(127.5)`` to keep
    threshold parity.
    """
    p = power_spectrum_db(iq) + power_offset_db
    return detect_peaks(p, sample_rate_hz=sample_rate_hz, max_peaks=max_peaks, **peak_kwargs)
