"""End-to-end flagship pipeline tests (detect → correlate → solve)."""

import dataclasses

import numpy as np
import jax.numpy as jnp

from radio_mapper_tpu import sim
from radio_mapper_tpu.models.pipeline import PipelineConfig, TDOAPipeline


def _scene(seed=8, **kw):
    scen = sim.default_scenario(
        signal="noise", bandwidth_hz=150e3, snr_db=25.0, seed=seed, **kw
    )
    return scen, sim.synthesize(scen)


def test_single_window_fix():
    scen, cap = _scene()
    pipe = TDOAPipeline(
        PipelineConfig(
            num_buoys=4,
            block_len=scen.block_len,
            sample_rate_hz=scen.sample_rate_hz,
            max_lag=600,
            power_offset_db=40.0,  # unit-scale floats vs raw-count threshold
        )
    )
    out = pipe.jit_step()(
        jnp.asarray(cap.iq, jnp.complex64),
        jnp.asarray(cap.buoy_enu, jnp.float32),
    )
    est = np.asarray(out.fix.position_enu)
    err = np.linalg.norm(est[:2] - cap.emitter_enu[0][:2])
    assert err < 50.0, err
    assert np.asarray(out.pair_weights).min() > 0.0
    assert out.correlation.lag_samples.shape == (6,)


def test_batched_channels():
    """[C, B, N] batch: the pipeline solves every channel in one call."""
    scens, caps = zip(*[_scene(seed=s) for s in (1, 2, 3)])
    iq = np.stack([c.iq for c in caps]).astype(np.complex64)
    anchors = np.stack([c.buoy_enu for c in caps]).astype(np.float32)
    pipe = TDOAPipeline(
        PipelineConfig(
            num_buoys=4,
            block_len=scens[0].block_len,
            sample_rate_hz=scens[0].sample_rate_hz,
            max_lag=600,
            power_offset_db=40.0,
        )
    )
    out = pipe.jit_step()(jnp.asarray(iq), jnp.asarray(anchors))
    assert out.fix.position_enu.shape == (3, 3)
    for k, cap in enumerate(caps):
        est = np.asarray(out.fix.position_enu)[k]
        err = np.linalg.norm(est[:2] - cap.emitter_enu[0][:2])
        assert err < 60.0, (k, err)


def test_uint8_path():
    scen, cap = _scene(seed=12)
    raw_iq = sim.quantize_uint8(cap)  # decoded back to complex by the sim
    pipe = TDOAPipeline(
        PipelineConfig(
            num_buoys=4,
            block_len=scen.block_len,
            sample_rate_hz=scen.sample_rate_hz,
            max_lag=600,
        )
    )
    out = pipe.jit_step()(
        jnp.asarray(raw_iq, jnp.complex64), jnp.asarray(cap.buoy_enu, jnp.float32)
    )
    est = np.asarray(out.fix.position_enu)
    err = np.linalg.norm(est[:2] - cap.emitter_enu[0][:2])
    # 8-bit quantization adds noise but sub-sample TDOA must survive.
    assert err < 100.0, err


def test_no_signal_gives_low_weights():
    rng = np.random.default_rng(0)
    iq = (rng.normal(size=(4, 16384)) + 1j * rng.normal(size=(4, 16384))).astype(
        np.complex64
    ) * 1e-8  # spectrum ≈ −117 dB, far below the −70 dB threshold
    anchors = rng.normal(scale=5e3, size=(4, 3)).astype(np.float32)
    anchors[:, 2] = 0
    pipe = TDOAPipeline(PipelineConfig(num_buoys=4, block_len=16384, max_lag=256))
    out = pipe.jit_step()(jnp.asarray(iq), jnp.asarray(anchors))
    # Nothing detectable: no valid peaks → zero pair weights.
    assert not np.any(np.asarray(out.peaks.valid))
    assert np.allclose(np.asarray(out.pair_weights), 0.0)


def test_example_inputs_compile():
    pipe = TDOAPipeline(PipelineConfig(num_buoys=4, block_len=4096, max_lag=128))
    iq, anchors = pipe.example_inputs(batch=(2,))
    out = pipe.jit_step()(iq, anchors)
    assert out.fix.position_enu.shape == (2, 3)
    raw, anchors2 = pipe.example_inputs(batch=(), uint8=True)
    out2 = pipe.jit_step_uint8()(raw, anchors2)
    assert out2.fix.position_enu.shape == (3,)


def test_freq_offset_portable_across_fused_and_unfused_paths():
    """PeakSet.freq_offset_hz is the portable frequency field: the split
    (re, im) step and the complex step must report the same tone
    frequency, within one bin spacing."""
    scen = sim.default_scenario(
        signal="tone", bandwidth_hz=1.0, snr_db=30.0, seed=4,
        emitter_lat=35.46, emitter_lng=-97.50,
    )
    # put the tone well away from DC so the notch doesn't eat it
    scen = dataclasses.replace(
        scen, emitters=(dataclasses.replace(scen.emitters[0], freq_offset_hz=250_000.0),)
    )
    cap = sim.synthesize(scen)
    iq = np.asarray(cap.iq, np.complex64)
    pipe = TDOAPipeline(
        PipelineConfig(
            num_buoys=4, block_len=scen.block_len,
            sample_rate_hz=scen.sample_rate_hz, max_lag=256,
            power_offset_db=40.0,
        )
    )
    anchors = jnp.asarray(cap.buoy_enu, jnp.float32)
    outs = {
        "split": pipe.jit_step_split()(
            jnp.asarray(iq.real), jnp.asarray(iq.imag), anchors
        ),
        "complex": pipe.jit_step()(jnp.asarray(iq), anchors),
    }
    bin_hz = scen.sample_rate_hz / scen.block_len
    for b in range(4):
        f_s = float(np.asarray(outs["split"].peaks.freq_offset_hz)[b, 0])
        f_c = float(np.asarray(outs["complex"].peaks.freq_offset_hz)[b, 0])
        assert abs(f_s - 250_000.0) < 2 * bin_hz, f_s
        assert abs(f_s - f_c) < 2 * bin_hz, (f_s, f_c)


def test_multidwell_validates_capture_length():
    import pytest

    pipe = TDOAPipeline(
        PipelineConfig(num_buoys=4, block_len=4096, correlation_dwells=4,
                       max_lag=128)
    )
    bad = jnp.zeros((4, 4096), jnp.complex64)  # one dwell, not four
    anchors = jnp.zeros((4, 3), jnp.float32)
    with pytest.raises(ValueError, match="correlation_dwells"):
        pipe.step(bad, anchors)
    with pytest.raises(ValueError, match="correlation_dwells"):
        pipe.step_split(bad.real, bad.imag, anchors)


def test_multiblock_scan_matches_per_block():
    """K-block lax.scan step (one dispatch) == K single-block steps.

    The scan folds the per-dispatch floor across K blocks (VERDICT r3
    item 4); semantics must be exactly the per-block pipeline's, with
    outputs stacked oldest-first on a leading K axis.
    """
    pipe = TDOAPipeline(
        PipelineConfig(num_buoys=4, block_len=4096, max_lag=256,
                       solver_iterations=10)
    )
    rng = np.random.default_rng(3)
    k, ch = 3, 2
    raw = rng.integers(0, 256, size=(k, ch, 4, 2 * 4096), dtype=np.uint8)
    anchors = rng.normal(scale=8_000.0, size=(ch, 4, 3)).astype(np.float32)
    anchors[..., 2] = 0.0
    scan_out = pipe.jit_step_split_uint8_scan()(
        jnp.asarray(raw), jnp.asarray(anchors)
    )
    assert scan_out.fix.position_enu.shape == (k, ch, 3)
    single = pipe.jit_step_split_uint8()
    for i in range(k):
        ref = single(jnp.asarray(raw[i]), jnp.asarray(anchors))
        np.testing.assert_allclose(
            np.asarray(scan_out.fix.position_enu)[i],
            np.asarray(ref.fix.position_enu), rtol=0, atol=1e-4,
        )
        np.testing.assert_array_equal(
            np.asarray(scan_out.peaks.bin_index)[i],
            np.asarray(ref.peaks.bin_index),
        )
        np.testing.assert_allclose(
            np.asarray(scan_out.correlation.lag_samples)[i],
            np.asarray(ref.correlation.lag_samples), rtol=0, atol=1e-3,
        )
