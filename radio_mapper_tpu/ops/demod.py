"""Batched demodulators: FM / AM / USB / LSB, deemphasis, squelch, resampling.

Capability parity with the reference's `rtl_fm` DSP core
(`Code/src/rtl_fm.c`): the polar-discriminant FM demod (`rtl_fm.c:427-515`),
AM magnitude / USB / LSB demods (546-594), deemphasis IIR filter and DC
block (596-627), squelch power gate (868-878), and integer decimation
(362-420) — re-designed batched: every function maps ``[..., N]`` blocks so
hundreds of channels demodulate in one jit-compiled call, and IIR-style
recursions are expressed as `lax.scan`/cumulative forms rather than Python
sample loops.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from radio_mapper_tpu.ops import fft as fft_ops


def fm_demod(iq: jnp.ndarray, *, gain: float = 1.0, prev: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """Polar-discriminant FM: angle(x[n] · conj(x[n−1])).

    The reference computes this per-sample with a fast atan2 LUT
    (`rtl_fm.c:427-515`); here it is one shifted multiply + arctan2,
    fused by XLA. ``prev``: last sample of the previous block per batch element
    (carried state for streaming continuity), defaults to the first sample
    (zero first output).
    """
    if prev is None:
        prev = iq[..., :1]
    shifted = jnp.concatenate([prev, iq[..., :-1]], axis=-1)
    return jnp.angle(iq * jnp.conj(shifted)) * gain


def am_demod(iq: jnp.ndarray) -> jnp.ndarray:
    """Magnitude AM demod (`rtl_fm.c:546-560`), DC-removed."""
    mag = jnp.abs(iq)
    return mag - jnp.mean(mag, axis=-1, keepdims=True)


def _analytic_shift(iq: jnp.ndarray, sign: float, sample_rate_hz: float, bfo_hz: float) -> jnp.ndarray:
    n = iq.shape[-1]
    t = np.arange(n) / sample_rate_hz
    osc = np.exp(2j * np.pi * (sign * bfo_hz) * t).astype(np.complex64)
    return iq * jnp.asarray(osc)


def usb_demod(iq: jnp.ndarray, *, sample_rate_hz: float, bfo_hz: float = 1500.0) -> jnp.ndarray:
    """Upper sideband: shift the (already channel-filtered) signal down by
    the BFO and take the real part (`rtl_fm.c:562-594` capability)."""
    return jnp.real(_analytic_shift(iq, -1.0, sample_rate_hz, bfo_hz))


def lsb_demod(iq: jnp.ndarray, *, sample_rate_hz: float, bfo_hz: float = 1500.0) -> jnp.ndarray:
    return jnp.real(_analytic_shift(iq, +1.0, sample_rate_hz, bfo_hz))


def deemphasis(audio: jnp.ndarray, *, sample_rate_hz: float, tau_s: float = 75e-6, init: Optional[jnp.ndarray] = None) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One-pole deemphasis IIR y[n] = y[n−1] + a·(x[n] − y[n−1])
    (`rtl_fm.c:596-616`), via an exact exponential-recursion scan.

    Returns (audio, final_state) so streaming callers can carry state.
    """
    a = 1.0 - float(np.exp(-1.0 / (sample_rate_hz * tau_s)))
    y0 = audio[..., :1] if init is None else init

    def step(carry, x):
        y = carry + a * (x - carry)
        return y, y

    # scan over the last axis: move it to the front.
    xs = jnp.moveaxis(audio, -1, 0)
    final, ys = jax.lax.scan(step, y0[..., 0], xs)
    return jnp.moveaxis(ys, 0, -1), final[..., None]


def dc_block(audio: jnp.ndarray) -> jnp.ndarray:
    """Block-mean DC removal (`rtl_fm.c:618-627`)."""
    return audio - jnp.mean(audio, axis=-1, keepdims=True)


def squelch(iq: jnp.ndarray, threshold_power: float) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Power gate: zero blocks whose mean power is below threshold
    (`rtl_fm.c:868-878`). Returns (gated_iq, open_mask[...])."""
    power = jnp.mean(jnp.abs(iq) ** 2, axis=-1)
    open_ = power >= threshold_power
    return iq * open_[..., None].astype(iq.dtype), open_


def decimate(x: jnp.ndarray, factor: int) -> jnp.ndarray:
    """Boxcar-average decimation (`rtl_fm.c:362-420`'s downsampler class).

    Trailing remainder is dropped; use lengths divisible by ``factor``.
    """
    n = x.shape[-1] - x.shape[-1] % factor
    return jnp.mean(x[..., :n].reshape(*x.shape[:-1], n // factor, factor), axis=-1)


def resample_pow2(audio: jnp.ndarray, out_len: int) -> jnp.ndarray:
    """Rational resampling in the frequency domain (band-limited).

    The reference uses a linear-interpolation arbitrary resampler
    (`rtl_fm.c:665-729`); the batched equivalent here is FFT-domain
    truncation/zero-padding, which is exact for band-limited audio and
    maps to the framework's FFT (ops/fft.py).
    """
    n = audio.shape[-1]
    spec = fft_ops.fft(audio.astype(jnp.complex64))
    half = min(n, out_len) // 2
    out_spec = jnp.zeros((*audio.shape[:-1], out_len), jnp.complex64)
    out_spec = out_spec.at[..., :half].set(spec[..., :half])
    out_spec = out_spec.at[..., -half:].set(spec[..., -half:])
    return jnp.real(fft_ops.ifft(out_spec)) * (out_len / n)


def nbfm_pipeline(
    iq: jnp.ndarray,
    *,
    sample_rate_hz: float,
    audio_rate_hz: float = 16_000.0,
    deemph_tau_s: Optional[float] = None,
) -> jnp.ndarray:
    """Narrowband-FM chain (`rtl_fm -M fm`): demod → decimate → DC block.

    Deemphasis is off by default, matching rtl_fm's fm mode where `-E deemp`
    is opt-in (`rtl_fm.c:596-616` applied only when enabled).
    """
    audio = fm_demod(iq)
    factor = max(1, int(round(sample_rate_hz / audio_rate_hz)))
    audio = decimate(audio, factor)
    if deemph_tau_s:
        audio, _ = deemphasis(
            audio, sample_rate_hz=sample_rate_hz / factor, tau_s=deemph_tau_s
        )
    return dc_block(audio)


def fir_decimate(
    x: jnp.ndarray, factor: int, *, taps_per_phase: int = 8, cutoff: float = 0.45
) -> jnp.ndarray:
    """Anti-alias FIR + ↓factor (windowed-sinc polyphase decimator).

    The proper version of rtl_fm's droop-compensated downsampler cascade
    (`rtl_fm.c:362-420`): ~50 dB stopband instead of the boxcar's sinc
    sidelobes, expressed as one static frames-einsum.
    ``cutoff`` is the passband edge as a fraction of the OUTPUT Nyquist.
    """
    if factor <= 1:
        return x
    t = taps_per_phase * factor
    k = np.arange(t) - (t - 1) / 2.0
    h = np.sinc(k * cutoff / factor) * np.hamming(t)
    h = (h / h.sum()).astype(np.float32)
    n = x.shape[-1]
    m = n // factor
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(t - 1, 0)])
    idx = np.arange(m)[:, None] * factor + np.arange(t)[None, :]  # static
    frames = xp[..., idx]
    return jnp.einsum(
        "...mt,t->...m", frames, jnp.asarray(h, frames.dtype),
        precision=jax.lax.Precision.HIGHEST,
    )


def channelize_watch(
    iq: jnp.ndarray,
    *,
    sample_rate_hz: float,
    offsets_hz: Tuple[float, ...],
    channel_rate_hz: float,
) -> jnp.ndarray:
    """Extract W watch channels from one wideband capture, batched.

    Mixes the block down by each static frequency offset and boxcar-
    decimates to the channel rate (the decimator IS the anti-alias filter,
    like rtl_fm's downsampler, `rtl_fm.c:362-420`). Returns ``[..., W, M]``
    complex channels. This is the batched replacement for rtl_fm's
    retune-and-hop scanning controller (`rtl_fm.c:939-974`): instead of
    hopping the tuner between frequencies and listening to one at a time,
    every watch frequency demodulates simultaneously from the same
    capture — zero revisit latency, no settle/flush dead time.
    """
    n = iq.shape[-1]
    factor = max(1, int(round(sample_rate_hz / channel_rate_hz)))
    t = np.arange(n) / sample_rate_hz
    osc = np.exp(-2j * np.pi * np.outer(np.asarray(offsets_hz), t)).astype(np.complex64)
    mixed = iq[..., None, :] * jnp.asarray(osc)  # [..., W, N]
    return fir_decimate(mixed, factor)


def watch_demod_block(
    iq: jnp.ndarray,
    *,
    sample_rate_hz: float,
    offsets_hz: Tuple[float, ...],
    mode: str = "nbfm",
    channel_rate_hz: float = 256_000.0,
    audio_rate_hz: float = 16_000.0,
    squelch_threshold: float = 0.0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One block → per-watch-frequency audio with per-channel squelch.

    Returns ``(audio [..., W, A], open [..., W] bool)``; squelched
    channels' audio is zeroed. One jit of this function replaces rtl_fm's
    whole 4-thread scan pipeline for W frequencies at once.
    """
    ch = channelize_watch(
        iq, sample_rate_hz=sample_rate_hz, offsets_hz=offsets_hz,
        channel_rate_hz=channel_rate_hz,
    )
    gated, open_ = squelch(ch, squelch_threshold) if squelch_threshold > 0 else (
        ch, jnp.ones(ch.shape[:-1], bool)
    )
    if mode == "nbfm":
        audio = nbfm_pipeline(gated, sample_rate_hz=channel_rate_hz, audio_rate_hz=audio_rate_hz)
    elif mode == "wbfm":
        audio = wbfm_pipeline(gated, sample_rate_hz=channel_rate_hz, audio_rate_hz=audio_rate_hz)
    elif mode == "am":
        audio = decimate(am_demod(gated), max(1, int(round(channel_rate_hz / audio_rate_hz))))
    elif mode == "usb":
        audio = decimate(
            usb_demod(gated, sample_rate_hz=channel_rate_hz),
            max(1, int(round(channel_rate_hz / audio_rate_hz))),
        )
    elif mode == "lsb":
        audio = decimate(
            lsb_demod(gated, sample_rate_hz=channel_rate_hz),
            max(1, int(round(channel_rate_hz / audio_rate_hz))),
        )
    else:
        raise ValueError(f"unknown demod mode {mode!r}")
    return audio * open_[..., None].astype(audio.dtype), open_


def wbfm_pipeline(
    iq: jnp.ndarray,
    *,
    sample_rate_hz: float,
    audio_rate_hz: float = 32_000.0,
    deemph_tau_s: float = 75e-6,
) -> jnp.ndarray:
    """Wideband-FM receive chain: FM demod → decimate → deemphasis → DC block.

    The batched analog of `rtl_fm.c`'s `full_demod` (`rtl_fm.c:730-768`).
    """
    audio = fm_demod(iq)
    factor = max(1, int(round(sample_rate_hz / audio_rate_hz)))
    audio = decimate(audio, factor)
    audio, _ = deemphasis(audio, sample_rate_hz=sample_rate_hz / factor, tau_s=deemph_tau_s)
    return dc_block(audio)
