"""Independent PHAT cross-check (VERDICT r1 §weak-6).

The framework's magnitude-gated PHAT whitening (`ops/gcc_phat.py:53-82`)
was only ever validated against the same formula in float64. This module
validates it against a STRUCTURALLY INDEPENDENT estimator — the textbook
scipy chain (bandpass-filter to the occupied band with a Butterworth
filter, `scipy.signal.correlate` GCC with exact 1/|R| whitening, no eps
gate) — on signals with known fractional delays, showing the gating does
not bias τ̂.
"""

import numpy as np
import pytest
import jax.numpy as jnp
from scipy import signal as sp_signal

from radio_mapper_tpu import golden
from radio_mapper_tpu.ops import gcc_phat as gcc


def _delayed_pair(n, fs, bw_hz, delay_samples, snr_db, seed):
    """Band-limited noise + exact frequency-domain fractional delay."""
    rng = np.random.default_rng(seed)
    spec = rng.normal(size=n) + 1j * rng.normal(size=n)
    f = np.fft.fftfreq(n, 1.0 / fs)
    spec *= np.abs(f) <= bw_hz / 2.0
    x = np.fft.ifft(spec)
    x /= np.sqrt(np.mean(np.abs(x) ** 2))
    y = np.fft.ifft(np.fft.fft(x) * np.exp(2j * np.pi * f * delay_samples / fs))
    # x delayed BY delay_samples relative to y ⇒ gcc_phat(x, y) > 0 lag.
    noise = lambda: (rng.normal(size=n) + 1j * rng.normal(size=n)) * np.sqrt(
        10 ** (-snr_db / 10) / 2
    )
    return x + noise(), y + noise()


def _textbook_phat_scipy(x, y, fs, bw_hz, max_lag):
    """Fully independent estimator: Butterworth bandpass → band-limited
    textbook PHAT (exact 1/|R| over the known in-band bins, zero outside
    — the classic band-limited-PHAT formulation; whitening the full
    spectrum would re-amplify out-of-band noise to unit weight no matter
    how hard the signal was filtered) → parabolic interpolation."""
    # Complex baseband lowpass of the occupied band (sos on re/im parts).
    sos = sp_signal.butter(6, bw_hz / 2 * 1.2, fs=fs, output="sos")
    filt = lambda s: (
        sp_signal.sosfiltfilt(sos, s.real) + 1j * sp_signal.sosfiltfilt(sos, s.imag)
    )
    xf, yf = filt(x), filt(y)
    n = len(xf)
    nfft = 2 * n
    r = np.fft.fft(xf, nfft) * np.conj(np.fft.fft(yf, nfft))
    band = np.abs(np.fft.fftfreq(nfft, 1.0 / fs)) <= bw_hz / 2 * 1.2
    corr = np.fft.ifft(np.where(band, r / (np.abs(r) + 1e-300), 0.0))
    lags = np.concatenate([corr[nfft - max_lag :], corr[: max_lag + 1]])
    m = np.abs(lags)
    k = int(np.argmax(m))
    delta = 0.0
    if 1 <= k <= len(m) - 2:
        denom = m[k - 1] - 2 * m[k] + m[k + 1]
        if abs(denom) > 1e-12:
            delta = float(0.5 * (m[k - 1] - m[k + 1]) / denom)
    return k - max_lag + delta


@pytest.mark.parametrize(
    "bw_hz,snr_db,delay",
    [
        (500e3, 20.0, 17.31),
        (500e3, 10.0, -33.73),
        (200e3, 20.0, 5.27),
        (100e3, 15.0, -11.5),
    ],
)
def test_gated_phat_agrees_with_independent_textbook(bw_hz, snr_db, delay):
    fs, n, max_lag = 2_048_000.0, 16_384, 256
    x, y = _delayed_pair(n, fs, bw_hz, delay, snr_db, seed=int(abs(delay * 100)))

    ours = gcc.gcc_phat(
        jnp.asarray(x.astype(np.complex64)),
        jnp.asarray(y.astype(np.complex64)),
        sample_rate_hz=fs, max_lag=max_lag,
    )
    ours_lag = float(np.asarray(ours.lag_samples))
    ref_lag = _textbook_phat_scipy(x, y, fs, bw_hz, max_lag)

    # Both estimators hit the truth; more importantly they agree with each
    # other — the eps gate does not bias τ̂ relative to textbook PHAT on
    # in-band-filtered signals. Accuracy scales with the correlation lobe
    # width (≈ fs/bw samples): sub-0.1-sample only at wide bandwidths.
    tol = max(0.1, 80_000.0 / bw_hz)
    assert abs(ours_lag - delay) < tol, (ours_lag, delay, tol)
    assert abs(ref_lag - delay) < tol, (ref_lag, delay, tol)
    assert abs(ours_lag - ref_lag) < tol


def test_gated_phat_superior_in_wideband_capture():
    """The reason the gate exists: a 12.5 kHz voice channel inside a
    2.048 MHz capture. Ungated textbook PHAT on the RAW capture whitens
    2000+ noise bins up to unit weight and collapses; the gated version
    holds. (The textbook chain needs the band-filter crutch; the gate IS
    that filter, learned from |R|.)"""
    fs, n, max_lag, delay = 2_048_000.0, 16_384, 256, 17.31
    x, y = _delayed_pair(n, fs, 12_500.0, delay, snr_db=3.0, seed=7)

    ours = gcc.gcc_phat(
        jnp.asarray(x.astype(np.complex64)), jnp.asarray(y.astype(np.complex64)),
        sample_rate_hz=fs, max_lag=max_lag,
    )
    ours_err = abs(float(np.asarray(ours.lag_samples)) - delay)

    # Ungated textbook PHAT on the unfiltered capture (eps → 0).
    raw = golden.gcc_phat_numpy(x, y, sample_rate_hz=fs, max_lag=max_lag, eps=1e-12)
    raw_err = abs(raw[0] - delay)

    # Narrowband ⇒ wide correlation lobe: the gated estimate stays within
    # a couple of samples; the ungated one is noise-dominated.
    assert ours_err < 3.0, ours_err
    assert raw_err > ours_err, (raw_err, ours_err)
