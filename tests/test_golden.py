"""Device GCC and detector vs the float64 NumPy references (golden.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from radio_mapper_tpu import golden, sim
from radio_mapper_tpu.ops import detect as detect_ops
from radio_mapper_tpu.ops import gcc_phat as gcc
from radio_mapper_tpu.ops import spectral
from radio_mapper_tpu.ops import split_complex as sc

FS = 2_400_000.0


def _scenes(channels, *, block_len=4096, bw=500e3, seed=7):
    """[C, 4, N] complex128 OKC scenes with a wideband emitter."""
    caps = [
        sim.synthesize(sim.default_scenario(
            block_len=block_len, snr_db=25.0, seed=seed + c, bandwidth_hz=bw,
            sample_rate_hz=FS,
        ))
        for c in range(channels)
    ]
    return np.stack([c.iq for c in caps]), caps


# ------------------------------------------------------------------ GCC


@pytest.mark.parametrize("weighting", ["phat", "scot", "roth", "cc"])
@pytest.mark.parametrize("batch", [(), (3,)])
def test_split_all_pairs_matches_golden(weighting, batch):
    iq, _ = _scenes(int(np.prod(batch)) if batch else 1)
    iq = iq.reshape(*batch, *iq.shape[-2:])
    got = sc.gcc_phat_all_pairs_split(
        jnp.asarray(iq.real, jnp.float32), jnp.asarray(iq.imag, jnp.float32),
        sample_rate_hz=FS, max_lag=256, weighting=weighting,
    )
    ref = golden.gcc_phat_all_pairs_numpy(iq, max_lag=256, weighting=weighting)
    assert got.lag_samples.shape == (*batch, 6)
    np.testing.assert_allclose(np.asarray(got.lag_samples), ref["lag_samples"], atol=0.01)
    np.testing.assert_allclose(np.asarray(got.psr), ref["psr"], rtol=0.02)


@pytest.mark.parametrize("weighting", ["phat", "scot", "roth", "cc"])
def test_complex_all_pairs_matches_golden(weighting):
    iq, _ = _scenes(2, seed=21)
    got = gcc.gcc_phat_all_pairs(
        jnp.asarray(iq, jnp.complex64), sample_rate_hz=FS, max_lag=256,
        weighting=weighting,
    )
    ref = golden.gcc_phat_all_pairs_numpy(iq, max_lag=256, weighting=weighting)
    np.testing.assert_allclose(np.asarray(got.lag_samples), ref["lag_samples"], atol=0.01)


def test_golden_all_pairs_matches_single_pair_golden():
    iq, _ = _scenes(1, seed=3)
    ref = golden.gcc_phat_all_pairs_numpy(iq[0], max_lag=200)
    i_idx, j_idx = gcc.pair_indices(4)
    for p, (i, j) in enumerate(zip(i_idx, j_idx)):
        lag, tau, peak = golden.gcc_phat_numpy(iq[0, i], iq[0, j], sample_rate_hz=FS, max_lag=200)
        assert abs(lag - ref["lag_samples"][p]) < 1e-9
        assert abs(peak - ref["peak_value"][p]) < 1e-9 * max(1.0, peak)
        assert abs(tau - lag / FS) < 1e-15


@pytest.mark.parametrize("true_lag", [4.25, -19.6, 77.0])
def test_golden_recovers_known_lag(true_lag):
    x, y = golden.delayed_pair(true_lag, n=8192, sample_rate_hz=FS, seed=5)
    lag, _, _ = golden.gcc_phat_numpy(x, y, sample_rate_hz=FS, max_lag=128)
    assert abs(lag - true_lag) < 0.1


def test_lag_deviation_masks_and_rejects_empty():
    worst, med = golden.lag_deviation([0.0, 0.5, 0.02], [0.0, 0.0, 0.0], [True, False, True])
    assert worst == pytest.approx(0.02) and med == pytest.approx(0.01)
    with pytest.raises(ValueError):
        golden.lag_deviation([1.0], [0.0], [False])


# -------------------------------------------------------------- detector

N = 4096


def _tone_power(batch, *, tones=(), seed=0, noise=0.1, offset=0.0):
    """dB power spectra of noise + natural-bin tones, as the pipeline's
    detector sees them."""
    rng = np.random.default_rng(seed)
    t = np.arange(N)
    x = noise * (rng.normal(size=(*batch, N)) + 1j * rng.normal(size=(*batch, N)))
    for bin_idx, amp in tones:
        x = x + amp * np.exp(2j * np.pi * bin_idx * t / N)
    p = spectral.power_spectrum_db(jnp.asarray(x, jnp.complex64)) + offset
    return np.asarray(p, np.float32)


def _assert_matches_reference(power_db, **kw):
    got = detect_ops.detect_peaks(jnp.asarray(power_db), **kw)
    want = golden.detect_peaks_numpy(power_db, **kw)
    np.testing.assert_array_equal(np.asarray(got.valid), want["valid"])
    v = want["valid"]
    np.testing.assert_array_equal(np.asarray(got.bin_index)[v], want["bin_index"][v])
    for field in ("power_db", "snr_db", "confidence", "freq_offset_hz"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, field))[v], want[field][v],
            rtol=1e-6, atol=1e-4, err_msg=field,
        )
    np.testing.assert_allclose(
        np.asarray(got.noise_floor_db), want["noise_floor_db"], atol=1e-4
    )
    return got


@pytest.mark.parametrize("seed", [0, 7])
def test_detect_tones_match_numpy_detector(seed):
    tones = [(200, 3.0), (213, 2.0), (700, 1.0), (N - 300, 1.5)]
    p = _tone_power((2,), tones=tones, seed=seed)
    got = _assert_matches_reference(p, sample_rate_hz=FS, max_peaks=8, threshold_db=-20.0)
    found = set(np.asarray(got.bin_index)[0][np.asarray(got.valid)[0]])
    assert {200, 213, 700, N - 300} <= found


def test_detect_noise_only_threshold_matches_numpy_detector():
    p = _tone_power((4,), seed=3)
    thr = float(np.percentile(p, 99.9))
    _assert_matches_reference(
        p, sample_rate_hz=FS, max_peaks=8, threshold_db=thr, confidence_floor=0.0
    )


@pytest.mark.parametrize("offset", [0.0, 42.1])
@pytest.mark.parametrize("floor", [0.0, 0.3, 0.9])
def test_detect_power_offset_and_confidence_floor(offset, floor):
    p = _tone_power((1,), tones=[(150, 2.0), (400, 0.45)], seed=4, offset=offset)
    _assert_matches_reference(
        p, sample_rate_hz=FS, max_peaks=4, threshold_db=-10.0 + offset,
        confidence_floor=floor,
    )


def test_detect_confidence_floor_above_one_is_empty():
    p = _tone_power((2,), tones=[(300, 5.0)], seed=5)
    got = _assert_matches_reference(
        p, sample_rate_hz=FS, threshold_db=-50.0, confidence_floor=1.5
    )
    assert not np.asarray(got.valid).any()


def test_detect_dc_notch_excludes_center():
    notch_bins = int(10_000.0 / (FS / N))
    p = _tone_power((1,), tones=[(2, 5.0), (notch_bins + 40, 3.0), (N - 3, 4.0)], seed=6)
    got = _assert_matches_reference(p, sample_rate_hz=FS, max_peaks=8, threshold_db=-10.0)
    found = set(np.asarray(got.bin_index)[0][np.asarray(got.valid)[0]])
    assert 2 not in found and N - 3 not in found
    assert notch_bins + 40 in found


def test_detect_batched_and_strided_floor_match_numpy_detector():
    p = _tone_power((2, 3), tones=[(500, 2.0), (1500, 1.0)], seed=8)
    got = _assert_matches_reference(
        p, sample_rate_hz=FS, max_peaks=4, threshold_db=-10.0, noise_floor_stride=8
    )
    assert got.power_db.shape == (2, 3, 4)
    assert got.noise_floor_db.shape == (2, 3)


def test_pipeline_peaks_match_numpy_detector():
    """step_split's detections equal the reference detector run on the
    same block_len power spectrum."""
    from radio_mapper_tpu.models.pipeline import PipelineConfig, TDOAPipeline

    iq, caps = _scenes(2, block_len=16_384, bw=150e3, seed=11)
    cfg = PipelineConfig(num_buoys=4, block_len=16_384, sample_rate_hz=FS,
                         max_lag=512, power_offset_db=40.0)
    out = jax.jit(TDOAPipeline(cfg).step_split)(
        jnp.asarray(iq.real, jnp.float32), jnp.asarray(iq.imag, jnp.float32),
        jnp.asarray(np.stack([c.buoy_enu for c in caps]), jnp.float32),
    )
    p = np.asarray(
        sc.power_spectrum_db_split(
            jnp.asarray(iq.real, jnp.float32), jnp.asarray(iq.imag, jnp.float32)
        )
    ) + 40.0
    want = golden.detect_peaks_numpy(
        p, sample_rate_hz=FS, max_peaks=cfg.max_peaks,
        threshold_db=cfg.detection_threshold_db,
        noise_floor_stride=cfg.noise_floor_stride,
    )
    np.testing.assert_array_equal(np.asarray(out.peaks.valid), want["valid"])
    v = want["valid"]
    assert v.any()
    np.testing.assert_array_equal(np.asarray(out.peaks.bin_index)[v], want["bin_index"][v])
