"""Synthetic scenario generator: emitter at a known position → per-buoy IQ.

Generalizes the reference's test harness, which fabricates detection
*timestamps* from geometric travel times (`tests/test_tdoa_validation.py:
262-302`, free-space path loss at :286-287). This generator goes further and
synthesizes the *waveforms*: for a buoy network and an emitter at a known
lat/lng it produces per-buoy complex baseband blocks with exact fractional-
sample propagation delays, 1/d path-loss amplitudes, carrier phase rotation,
per-buoy clock error and AWGN — the ground truth for validating GCC-PHAT
TDOA to sub-0.1-sample accuracy (BASELINE config 1).

Delays are applied in the frequency domain (phase ramp on the block DFT),
which is *exact* for the periodic block — no interpolation error can leak
into the 0.1-sample parity budget. Signals are generated in float64 NumPy
(golden model); :func:`batch_blocks` ships them to the device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from radio_mapper_tpu import geo
from radio_mapper_tpu.constants import SPEED_OF_LIGHT_M_S
from radio_mapper_tpu.ops import iq as iq_ops

# Default network: the reference's simulated 4-buoy Oklahoma City square
# (`tests/test_tdoa_validation.py:35-40`, `config.yaml:8-10`).
OKC_BUOYS = (
    ("buoy-okc-north", 35.5513, -97.5322, 365.8),
    ("buoy-okc-east", 35.4676, -97.4085, 365.8),
    ("buoy-okc-south", 35.3842, -97.5322, 365.8),
    ("buoy-okc-west", 35.4676, -97.6559, 365.8),
)


@dataclasses.dataclass(frozen=True)
class Buoy:
    buoy_id: str
    lat: float
    lng: float
    alt_m: float = 0.0
    clock_error_s: float = 0.0  # fixed clock offset of this receiver
    snr_db: Optional[float] = None  # overrides scenario SNR if set


@dataclasses.dataclass(frozen=True)
class Emitter:
    lat: float
    lng: float
    alt_m: float = 0.0
    freq_offset_hz: float = 0.0  # offset from channel center
    bandwidth_hz: float = 12_500.0
    signal: str = "noise"  # noise | tone | bpsk | chirp | fm
    power_db: float = 0.0  # relative transmit power


@dataclasses.dataclass(frozen=True)
class Scenario:
    buoys: Tuple[Buoy, ...]
    emitters: Tuple[Emitter, ...]
    sample_rate_hz: float = 2_048_000.0
    center_frequency_mhz: float = 121.5
    block_len: int = 16_384
    snr_db: float = 20.0
    timing_jitter_s: float = 0.0  # std of random per-buoy clock error
    seed: int = 0

    @property
    def ref_origin(self) -> Tuple[float, float, float]:
        lat = float(np.mean([b.lat for b in self.buoys]))
        lng = float(np.mean([b.lng for b in self.buoys]))
        return lat, lng, 0.0

    def buoy_enu(self) -> np.ndarray:
        """[B, 3] float64 buoy positions in the scenario ENU frame."""
        lat0, lng0, alt0 = self.ref_origin
        return np.stack(
            [geo.lat_lng_to_enu_np(b.lat, b.lng, b.alt_m, lat0, lng0, alt0) for b in self.buoys]
        )

    def emitter_enu(self, e: Emitter) -> np.ndarray:
        lat0, lng0, alt0 = self.ref_origin
        return geo.lat_lng_to_enu_np(e.lat, e.lng, e.alt_m, lat0, lng0, alt0)


@dataclasses.dataclass
class Capture:
    """Synthesized per-buoy IQ and its ground truth."""

    iq: np.ndarray  # [B, N] complex128
    delays_s: np.ndarray  # [B, E] true propagation delay incl. clock error
    geometric_delays_s: np.ndarray  # [B, E] pure propagation delay
    amplitudes: np.ndarray  # [B, E] received amplitude
    buoy_enu: np.ndarray  # [B, 3]
    emitter_enu: np.ndarray  # [E, 3]
    scenario: Scenario

    def true_pair_lag_samples(self, i: int, j: int, emitter: int = 0) -> float:
        """Expected GCC lag (samples) of buoy i relative to buoy j."""
        d = self.delays_s[i, emitter] - self.delays_s[j, emitter]
        return float(d * self.scenario.sample_rate_hz)


def _baseband_source(e: Emitter, n: int, fs: float, rng: np.random.Generator) -> np.ndarray:
    """Unit-power complex baseband source waveform of length n (float64).

    Noise-like signals are built directly in the frequency domain so the
    subsequent phase-ramp delays are exact for the periodic block.
    """
    t = np.arange(n) / fs
    if e.signal == "tone":
        s = np.exp(2j * np.pi * e.freq_offset_hz * t)
    elif e.signal == "chirp":
        f0 = e.freq_offset_hz - e.bandwidth_hz / 2
        rate = e.bandwidth_hz / (n / fs)
        s = np.exp(2j * np.pi * (f0 * t + 0.5 * rate * t * t))
    elif e.signal == "bpsk":
        sym_rate = max(e.bandwidth_hz, fs / n)
        samples_per_sym = max(1, int(round(fs / sym_rate)))
        num_sym = n // samples_per_sym + 1
        bits = rng.integers(0, 2, num_sym) * 2.0 - 1.0
        s = np.repeat(bits, samples_per_sym)[:n].astype(np.complex128)
        s *= np.exp(2j * np.pi * e.freq_offset_hz * t)
    elif e.signal == "fm":
        # FM with a two-tone message, 75 kHz deviation scaled to bandwidth.
        msg = 0.6 * np.sin(2 * np.pi * 1100.0 * t) + 0.4 * np.sin(2 * np.pi * 2700.0 * t)
        dev = e.bandwidth_hz / 2.0
        phase = 2 * np.pi * np.cumsum(msg) * dev / fs
        s = np.exp(1j * (2 * np.pi * e.freq_offset_hz * t + phase))
    elif e.signal == "noise":
        spec = rng.normal(size=n) + 1j * rng.normal(size=n)
        f = np.fft.fftfreq(n, 1.0 / fs)
        mask = np.abs(f - e.freq_offset_hz) <= e.bandwidth_hz / 2.0
        if not mask.any():
            mask[np.argmin(np.abs(f - e.freq_offset_hz))] = True
        s = np.fft.ifft(spec * mask)
    else:
        raise ValueError(f"unknown signal model {e.signal!r}")
    p = np.mean(np.abs(s) ** 2)
    return s / np.sqrt(p + 1e-300)


def _apply_delay(s: np.ndarray, delay_s: float, fs: float) -> np.ndarray:
    """Exact (circular) fractional delay via frequency-domain phase ramp."""
    n = s.shape[-1]
    f = np.fft.fftfreq(n, 1.0 / fs)
    return np.fft.ifft(np.fft.fft(s) * np.exp(-2j * np.pi * f * delay_s))


def synthesize(scenario: Scenario) -> Capture:
    """Generate one aligned block of per-buoy IQ for the scenario."""
    rng = np.random.default_rng(scenario.seed)
    fs = scenario.sample_rate_hz
    n = scenario.block_len
    num_b = len(scenario.buoys)
    num_e = len(scenario.emitters)
    fc_hz = scenario.center_frequency_mhz * 1e6

    buoy_enu = scenario.buoy_enu()
    emitter_enu = np.stack([scenario.emitter_enu(e) for e in scenario.emitters])

    # Per-buoy clock error: fixed offset + random jitter.
    clock = np.array(
        [
            b.clock_error_s + (rng.normal() * scenario.timing_jitter_s)
            for b in scenario.buoys
        ]
    )

    geo_delays = np.zeros((num_b, num_e))
    delays = np.zeros((num_b, num_e))
    amps = np.zeros((num_b, num_e))
    iq = np.zeros((num_b, n), dtype=np.complex128)

    for ei, emitter in enumerate(scenario.emitters):
        src = _baseband_source(emitter, n, fs, rng)
        dists = np.linalg.norm(buoy_enu - emitter_enu[ei], axis=1)
        d_ref = float(np.min(dists))
        for bi in range(num_b):
            tau_geo = dists[bi] / SPEED_OF_LIGHT_M_S
            tau = tau_geo + clock[bi]
            geo_delays[bi, ei] = tau_geo
            delays[bi, ei] = tau
            # Free-space 1/d amplitude, normalized to the closest buoy,
            # scaled by transmit power.
            amp = (d_ref / max(dists[bi], 1.0)) * 10.0 ** (emitter.power_db / 20.0)
            amps[bi, ei] = amp
            # Carrier phase rotation from the true RF delay.
            carrier = np.exp(-2j * np.pi * fc_hz * tau_geo)
            iq[bi] += amp * carrier * _apply_delay(src, tau, fs)

    # AWGN at the requested per-buoy SNR (relative to that buoy's signal).
    for bi, b in enumerate(scenario.buoys):
        snr = b.snr_db if b.snr_db is not None else scenario.snr_db
        sig_p = np.mean(np.abs(iq[bi]) ** 2)
        noise_p = sig_p / (10.0 ** (snr / 10.0)) if sig_p > 0 else 1.0
        noise = (rng.normal(size=n) + 1j * rng.normal(size=n)) * np.sqrt(noise_p / 2.0)
        iq[bi] += noise

    return Capture(
        iq=iq,
        delays_s=delays,
        geometric_delays_s=geo_delays,
        amplitudes=amps,
        buoy_enu=buoy_enu,
        emitter_enu=emitter_enu,
        scenario=scenario,
    )


def to_uint8(capture: Capture, *, target_rms_counts: float = 32.0) -> np.ndarray:
    """Simulate the RTL-SDR 8-bit frontend: scale, round, clip.

    Returns the ``[B, 2N]`` interleaved I/Q bytes a dongle would deliver,
    scaled so the capture's RMS is ``target_rms_counts``.
    """
    rms = np.sqrt(np.mean(np.abs(capture.iq) ** 2)) + 1e-30
    scaled = capture.iq * (target_rms_counts / rms)
    b, n = scaled.shape
    raw = np.empty((b, 2 * n), dtype=np.uint8)
    raw[:, 0::2] = np.clip(np.round(scaled.real + 127.5), 0, 255).astype(np.uint8)
    raw[:, 1::2] = np.clip(np.round(scaled.imag + 127.5), 0, 255).astype(np.uint8)
    return raw


def quantize_uint8(capture: Capture, *, target_rms_counts: float = 32.0) -> np.ndarray:
    """:func:`to_uint8`, decoded back: ``[B, N]`` complex128 exactly as the
    reference decodes dongle bytes (`buoy_node.py:392-398`)."""
    return iq_ops.decode_uint8_iq_numpy(
        to_uint8(capture, target_rms_counts=target_rms_counts)
    )


def default_scenario(
    *,
    emitter_lat: float = 35.47,
    emitter_lng: float = -97.51,
    signal: str = "noise",
    bandwidth_hz: float = 25_000.0,
    freq_offset_hz: float = 0.0,
    snr_db: float = 20.0,
    block_len: int = 16_384,
    sample_rate_hz: float = 2_048_000.0,
    timing_jitter_s: float = 0.0,
    seed: int = 0,
    buoys: Optional[Sequence[Tuple[str, float, float, float]]] = None,
) -> Scenario:
    """A ready-to-use OKC scenario mirroring the reference's test network.

    Note: the detector notches ±10 kHz around the tuned center
    (`buoy_node.py:423` parity), so a narrowband emitter meant to be
    *detected* (not just correlated) needs ``freq_offset_hz`` outside it.
    """
    buoys = buoys if buoys is not None else OKC_BUOYS
    return Scenario(
        buoys=tuple(Buoy(bid, lat, lng, alt) for bid, lat, lng, alt in buoys),
        emitters=(
            Emitter(
                lat=emitter_lat,
                lng=emitter_lng,
                signal=signal,
                bandwidth_hz=bandwidth_hz,
                freq_offset_hz=freq_offset_hz,
            ),
        ),
        sample_rate_hz=sample_rate_hz,
        block_len=block_len,
        snr_db=snr_db,
        timing_jitter_s=timing_jitter_s,
        seed=seed,
    )


def batch_blocks(captures: List[Capture]) -> np.ndarray:
    """Stack captures into a ``[num_blocks, B, N]`` complex64 device-ready batch."""
    return np.stack([c.iq for c in captures]).astype(np.complex64)


def synthesize_wideband(
    cfg,
    *,
    active_subchannel: int,
    anchors_enu: np.ndarray,
    emitter_enu: np.ndarray,
    snr_db: float = 25.0,
    seed: int = 0,
    signal_fraction: float = 0.5,
):
    """One wideband block for a :class:`models.wideband.WidebandConfig`.

    Band-limited noise centered on ``active_subchannel`` (unshifted FFT
    channel order), received by each buoy with the EXACT fractional
    geometric delay (frequency-domain phase ramp — same technique as
    :func:`_apply_delay`), plus unit-variance complex noise. Returns
    ``(re, im)`` float32 of shape ``[B, cfg.wide_block]``. Shared by the
    CLI `wideband` demo, the config-4 tests and ``chip_smoke.py``.
    """
    rng = np.random.default_rng(seed)
    b, n, fs = cfg.num_buoys, cfg.wide_block, cfg.wide_rate_hz
    f0 = np.fft.fftfreq(cfg.num_subchannels, d=1.0 / fs)[
        active_subchannel % cfg.num_subchannels
    ]
    base = rng.normal(size=2 * n).view(np.complex128)[:n]
    spec = np.fft.fft(base)
    f = np.fft.fftfreq(n, 1.0 / fs)
    spec[np.abs(f) > signal_fraction * cfg.sub_rate_hz / 2] = 0.0
    s = np.fft.ifft(spec)
    s *= np.exp(2j * np.pi * f0 * np.arange(n) / fs)
    s /= np.std(s)
    amp = 10 ** (snr_db / 20.0)
    sfft = np.fft.fft(amp * s)
    iq = np.empty((b, n), np.complex128)
    for k in range(b):
        d = np.linalg.norm(emitter_enu - anchors_enu[k])
        iq[k] = np.fft.ifft(sfft * np.exp(-2j * np.pi * f * d / SPEED_OF_LIGHT_M_S))
    iq += (rng.normal(size=(b, n)) + 1j * rng.normal(size=(b, n))) / np.sqrt(2)
    return iq.real.astype(np.float32), iq.imag.astype(np.float32)
