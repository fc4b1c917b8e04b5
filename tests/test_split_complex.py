"""Split-complex path must match the complex path (no complex dtype used)."""

import numpy as np
import jax.numpy as jnp

from radio_mapper_tpu import sim
from radio_mapper_tpu.models.pipeline import PipelineConfig, TDOAPipeline
from radio_mapper_tpu.ops import gcc_phat as gcc
from radio_mapper_tpu.ops import spectral, split_complex as sc


def test_power_spectrum_matches_complex_path():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 4096)) + 1j * rng.normal(size=(3, 4096))).astype(np.complex64)
    want = np.asarray(spectral.power_spectrum_db(jnp.asarray(x)))
    got = np.asarray(
        sc.power_spectrum_db_split(jnp.asarray(x.real), jnp.asarray(x.imag))
    )
    # same FFT op on the same values: equal up to f32 rounding
    assert np.abs(got - want).max() < 1e-3
    want64 = 20 * np.log10(np.abs(np.fft.fft(x.astype(np.complex128))) + 1e-12)
    assert np.abs(got - want64).max() < 0.05  # vs float64 (fp32 noise)


def test_gcc_split_matches_complex():
    fs = 2_400_000.0
    n = 16_384
    rng = np.random.default_rng(1)
    f = np.fft.fftfreq(n, 1 / fs)
    spec = (rng.normal(size=n) + 1j * rng.normal(size=n)) * (np.abs(f) <= 120e3)
    s = np.fft.ifft(spec)
    s /= np.sqrt(np.mean(np.abs(s) ** 2))
    true_lag = 33.41
    x = np.fft.ifft(np.fft.fft(s) * np.exp(-2j * np.pi * f * true_lag / fs))

    ref = gcc.gcc_phat(
        jnp.asarray(x, jnp.complex64), jnp.asarray(s, jnp.complex64),
        sample_rate_hz=fs, max_lag=256,
    )
    got = sc.gcc_phat_split(
        jnp.asarray(x.real, jnp.float32), jnp.asarray(x.imag, jnp.float32),
        jnp.asarray(s.real, jnp.float32), jnp.asarray(s.imag, jnp.float32),
        sample_rate_hz=fs, max_lag=256,
    )
    assert abs(float(got.lag_samples) - true_lag) < 0.1
    assert abs(float(got.lag_samples) - float(ref.lag_samples)) < 0.02
    assert abs(float(got.psr) - float(ref.psr)) / float(ref.psr) < 0.05


def test_decode_split_matches_complex_decode():
    from radio_mapper_tpu.ops import iq as iq_ops

    rng = np.random.default_rng(2)
    raw = rng.integers(0, 256, 2048, dtype=np.uint8)
    re, im = sc.decode_uint8_split(jnp.asarray(raw))
    z = np.asarray(iq_ops.decode_uint8_iq(jnp.asarray(raw)))
    np.testing.assert_allclose(np.asarray(re), z.real, atol=1e-5)
    np.testing.assert_allclose(np.asarray(im), z.imag, atol=1e-5)


def test_full_split_pipeline_recovers_emitter():
    scen = sim.default_scenario(signal="noise", bandwidth_hz=150e3, snr_db=25.0, seed=8)
    cap = sim.synthesize(scen)
    pipe = TDOAPipeline(
        PipelineConfig(
            num_buoys=4, block_len=scen.block_len,
            sample_rate_hz=scen.sample_rate_hz, max_lag=600,
            power_offset_db=40.0,
        )
    )
    out = pipe.jit_step_split()(
        jnp.asarray(cap.iq.real, jnp.float32),
        jnp.asarray(cap.iq.imag, jnp.float32),
        jnp.asarray(cap.buoy_enu, jnp.float32),
    )
    est = np.asarray(out.fix.position_enu)
    err = np.linalg.norm(est[:2] - cap.emitter_enu[0][:2])
    assert err < 50.0, err

    # And it matches the complex path's result.
    out_c = pipe.jit_step()(
        jnp.asarray(cap.iq, jnp.complex64), jnp.asarray(cap.buoy_enu, jnp.float32)
    )
    np.testing.assert_allclose(
        np.asarray(out.correlation.lag_samples),
        np.asarray(out_c.correlation.lag_samples),
        atol=0.05,
    )


def test_split_uint8_entry():
    pipe = TDOAPipeline(PipelineConfig(num_buoys=3, block_len=2048, max_lag=64,
                                       solver_iterations=8))
    raw, anchors = pipe.example_inputs(uint8=True)
    out = pipe.jit_step_split_uint8()(raw, anchors)
    assert np.all(np.isfinite(np.asarray(out.fix.position_enu)))
