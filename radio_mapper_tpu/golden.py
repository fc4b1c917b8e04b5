"""Float64 NumPy references for the pipeline's measurements.

Plain, JAX-free implementations of the same semantics as the device code,
for the parity tests and for ``chip_smoke.py``'s checks on the card:

- :func:`delayed_pair` — band-limited noise seen by two receivers with a
  known fractional lag (exact frequency-domain delay);
- :func:`gcc_phat_numpy` / :func:`gcc_phat_all_pairs_numpy` — GCC with
  the PHAT/SCOT/ROTH/CC weightings, parabolic sub-sample refinement and
  the peak-to-sidelobe ratio, as :mod:`radio_mapper_tpu.ops.gcc_phat`;
- :func:`detect_peaks_numpy` — the spectral peak detector of
  :func:`radio_mapper_tpu.ops.detect.detect_peaks`.

The τ parity bound the device must meet against these is 0.1 sample
(BASELINE.md).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from radio_mapper_tpu.ops.fft import friendly_fft_len

TAU_BOUND_SAMPLES = 0.1


def delayed_pair(
    delay_samples: float,
    *,
    n: int = 16_384,
    sample_rate_hz: float = 2_400_000.0,
    snr_db: float = 20.0,
    bw: float = 200e3,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Band-limited noise observed by two receivers with a known lag.

    Returns complex128 ``(x, y)`` where ``x`` is ``y``'s source delayed by
    ``delay_samples``, each with its own white noise at ``snr_db``.
    """
    fs = sample_rate_hz
    rng = np.random.default_rng(seed)
    f = np.fft.fftfreq(n, 1 / fs)
    spec = (rng.normal(size=n) + 1j * rng.normal(size=n)) * (np.abs(f) <= bw / 2)
    s = np.fft.ifft(spec)
    s /= np.sqrt(np.mean(np.abs(s) ** 2))
    x = np.fft.ifft(np.fft.fft(s) * np.exp(-2j * np.pi * f * delay_samples / fs))
    noise_amp = 10 ** (-snr_db / 20)

    def add_noise(sig, sd):
        r = np.random.default_rng(sd)
        return sig + noise_amp * (r.normal(size=n) + 1j * r.normal(size=n)) / np.sqrt(2)

    return add_noise(x, seed + 100), add_noise(s, seed + 200)


def _weight(r, x_f, y_f, weighting: str, eps: float):
    if weighting == "cc":
        return r
    if weighting == "phat":
        d = np.abs(r)
    elif weighting == "scot":
        d = np.sqrt(np.abs(x_f) ** 2 * np.abs(y_f) ** 2)
    elif weighting == "roth":
        d = np.abs(x_f) ** 2
    else:
        raise ValueError(f"unknown weighting {weighting!r}")
    return r / (d + eps * d.max(axis=-1, keepdims=True) + 1e-30)


def _peak(m: np.ndarray, max_lag: int, psr_exclude: int = 8):
    """Argmax + parabolic refine + PSR over the last axis of ``m``."""
    length = m.shape[-1]
    k = np.argmax(m, axis=-1)
    kc = np.clip(k, 1, length - 2)
    take = lambda i: np.take_along_axis(m, i[..., None], axis=-1)[..., 0]
    ym1, y0, yp1 = take(kc - 1), take(kc), take(kc + 1)
    den = ym1 - 2.0 * y0 + yp1
    ok = np.abs(den) > 1e-12
    delta = np.where(ok, 0.5 * (ym1 - yp1) / np.where(ok, den, 1.0), 0.0)
    delta = np.clip(delta, -0.999, 0.999)
    delta = np.where((k >= 1) & (k <= length - 2), delta, 0.0)
    peak = take(k)
    far = np.abs(np.arange(length) - k[..., None]) > psr_exclude
    side = np.max(np.where(far, m, -np.inf), axis=-1)
    psr = peak / (np.maximum(side, 0.0) + 1e-12)
    return k - max_lag + delta, peak, psr


def gcc_phat_numpy(
    x: np.ndarray,
    y: np.ndarray,
    *,
    sample_rate_hz: float,
    max_lag: int,
    weighting: str = "phat",
    eps: float = 0.05,
) -> Tuple[float, float, float]:
    """Float64 reference of :func:`ops.gcc_phat.gcc_phat` (one pair, 1-D).

    Returns ``(lag_samples, tau_s, peak_value)``.
    """
    n = x.shape[-1]
    nfft = friendly_fft_len(n + max_lag)
    x_f = np.fft.fft(x, n=nfft)
    y_f = np.fft.fft(y, n=nfft)
    r = _weight(x_f * np.conj(y_f), x_f, y_f, weighting, eps)
    corr = np.fft.ifft(r)
    m = np.abs(np.concatenate([corr[nfft - max_lag:], corr[: max_lag + 1]]))
    lag, peak, _ = _peak(m, max_lag)
    return float(lag), float(lag) / sample_rate_hz, float(peak)


def gcc_phat_all_pairs_numpy(
    signals: np.ndarray,
    *,
    max_lag: int,
    weighting: str = "phat",
    eps: float = 0.05,
) -> Dict[str, np.ndarray]:
    """Float64 all-pairs GCC over the receiver axis of ``[..., B, N]``.

    Pairs are ordered as :func:`ops.gcc_phat.pair_indices` (i < j, row
    major). Returns ``{"lag_samples", "peak_value", "psr"}``, each
    ``[..., P]``.
    """
    signals = np.asarray(signals, np.complex128)
    b, n = signals.shape[-2:]
    nfft = friendly_fft_len(n + max_lag)
    spec = np.fft.fft(signals, n=nfft, axis=-1)
    i_idx, j_idx = np.triu_indices(b, k=1)
    x_f, y_f = spec[..., i_idx, :], spec[..., j_idx, :]
    r = _weight(x_f * np.conj(y_f), x_f, y_f, weighting, eps)
    corr = np.fft.ifft(r, axis=-1)
    m = np.abs(np.concatenate([corr[..., nfft - max_lag:], corr[..., : max_lag + 1]], -1))
    lag, peak, psr = _peak(m, max_lag)
    return {"lag_samples": lag, "peak_value": peak, "psr": psr}


def detect_peaks_numpy(
    power_db: np.ndarray,
    *,
    sample_rate_hz: float,
    max_peaks: int = 8,
    threshold_db: float = -70.0,
    min_distance_bins: int = 10,
    dc_notch_hz: Optional[float] = 10_000.0,
    confidence_floor: float = 0.3,
    snr_fullscale_db: float = 20.0,
    noise_floor_stride: int = 1,
) -> Dict[str, np.ndarray]:
    """Reference of :func:`ops.detect.detect_peaks`, one row at a time.

    A bin is a candidate when it is the maximum of its ±min_distance
    window (edges padded with −inf), above ``threshold_db``, outside the
    DC notch, and at least ``confidence_floor · snr_fullscale_db`` above
    the median noise floor (of every ``noise_floor_stride``-th bin). The
    ``max_peaks`` strongest candidates are returned, strongest first,
    ties to the lowest bin; empty slots have ``valid`` False and zeros.
    """
    p = np.asarray(power_db, np.float64)
    f = p.shape[-1]
    rows = p.reshape(-1, f)
    freqs = np.fft.fftfreq(f, 1.0 / sample_rate_hz)
    r = min_distance_bins
    k_max = max_peaks
    out = {
        "bin_index": np.zeros((rows.shape[0], k_max), np.int64),
        "freq_offset_hz": np.zeros((rows.shape[0], k_max)),
        "power_db": np.zeros((rows.shape[0], k_max)),
        "snr_db": np.zeros((rows.shape[0], k_max)),
        "confidence": np.zeros((rows.shape[0], k_max)),
        "valid": np.zeros((rows.shape[0], k_max), bool),
        "noise_floor_db": np.zeros(rows.shape[0]),
    }
    for q, row in enumerate(rows):
        floor = np.median(row[::noise_floor_stride])
        padded = np.concatenate([np.full(r, -np.inf), row, np.full(r, -np.inf)])
        window = np.lib.stride_tricks.sliding_window_view(padded, 2 * r + 1).max(-1)
        cand = (row >= window) & (row > threshold_db)
        if dc_notch_hz is not None:
            cand &= np.abs(freqs) >= dc_notch_hz
        if confidence_floor > 1.0:
            cand[:] = False
        elif confidence_floor > 0.0:
            cand &= row - floor >= confidence_floor * snr_fullscale_db
        idx = np.flatnonzero(cand)
        idx = idx[np.argsort(-row[idx], kind="stable")][:k_max]
        m = len(idx)
        snr = row[idx] - floor
        out["bin_index"][q, :m] = idx
        out["freq_offset_hz"][q, :m] = freqs[idx]
        out["power_db"][q, :m] = row[idx]
        out["snr_db"][q, :m] = snr
        out["confidence"][q, :m] = np.clip(snr / snr_fullscale_db, 0.0, 1.0)
        out["valid"][q, :m] = True
        out["noise_floor_db"][q] = floor
    batch = p.shape[:-1]
    return {
        k: v.reshape(*batch, *v.shape[1:]) if k != "noise_floor_db" else v.reshape(batch)
        for k, v in out.items()
    }


def lag_deviation(lags, golden, valid=None) -> Tuple[float, float]:
    """(worst, median) |lags − golden| over ``valid`` entries."""
    d = np.abs(np.asarray(lags, np.float64) - np.asarray(golden, np.float64))
    if valid is not None:
        d = d[np.asarray(valid, bool)]
    if d.size == 0:
        raise ValueError("no valid pairs to compare")
    return float(d.max()), float(np.median(d))
