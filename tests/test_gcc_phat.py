"""GCC-PHAT sub-sample TDOA accuracy and golden-model parity.

The headline requirement (BASELINE config 1): the device GCC-PHAT with parabolic
peak interpolation matches the float64 CPU reference within 0.1 sample.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from radio_mapper_tpu.ops import gcc_phat
from radio_mapper_tpu import golden, sim

FS = 2_400_000.0


def _delayed_pair(delay_samples, n=16_384, snr_db=20.0, bw=200e3, seed=0):
    """Band-limited noise observed by two receivers with a known lag."""
    return golden.delayed_pair(
        delay_samples, n=n, sample_rate_hz=FS, snr_db=snr_db, bw=bw, seed=seed
    )


@pytest.mark.parametrize("true_lag", [0.0, 3.0, -7.0, 12.37, -41.62, 201.5])
def test_subsample_accuracy_vs_truth(true_lag):
    x, y = _delayed_pair(true_lag, seed=int(abs(true_lag) * 10))
    peak = gcc_phat.gcc_phat(
        jnp.asarray(x, jnp.complex64),
        jnp.asarray(y, jnp.complex64),
        sample_rate_hz=FS,
        max_lag=512,
    )
    assert abs(float(peak.lag_samples) - true_lag) < 0.1, float(peak.lag_samples)


@pytest.mark.parametrize("true_lag", [5.25, -33.75, 127.1])
def test_jax_path_matches_float64_golden_within_tenth_sample(true_lag):
    x, y = _delayed_pair(true_lag, seed=int(abs(true_lag)))
    lag64, tau64, _ = golden.gcc_phat_numpy(x, y, sample_rate_hz=FS, max_lag=512)
    peak = gcc_phat.gcc_phat(
        jnp.asarray(x, jnp.complex64),
        jnp.asarray(y, jnp.complex64),
        sample_rate_hz=FS,
        max_lag=512,
    )
    assert abs(float(peak.lag_samples) - lag64) < 0.1
    assert abs(float(peak.tau_s) - tau64) < 0.1 / FS


@pytest.mark.parametrize("weighting", ["cc", "phat", "scot", "roth"])
def test_weightings_recover_integer_lag(weighting):
    x, y = _delayed_pair(25.0, snr_db=30.0, seed=9)
    peak = gcc_phat.gcc_phat(
        jnp.asarray(x, jnp.complex64),
        jnp.asarray(y, jnp.complex64),
        sample_rate_hz=FS,
        max_lag=256,
        weighting=weighting,
    )
    assert abs(float(peak.lag_samples) - 25.0) < 0.5


def test_batched_shapes_and_independence():
    lags = [4.5, -10.25, 60.0]
    xs, ys = [], []
    for i, lag in enumerate(lags):
        x, y = _delayed_pair(lag, n=8192, seed=40 + i)
        xs.append(x)
        ys.append(y)
    peak = gcc_phat.gcc_phat(
        jnp.asarray(np.stack(xs), jnp.complex64),
        jnp.asarray(np.stack(ys), jnp.complex64),
        sample_rate_hz=FS,
        max_lag=128,
    )
    assert peak.lag_samples.shape == (3,)
    np.testing.assert_allclose(np.asarray(peak.lag_samples), lags, atol=0.1)


def test_all_pairs_consistency():
    """Pairwise lags from a 4-buoy synthetic scene close the triangle."""
    scen = sim.default_scenario(signal="noise", bandwidth_hz=100e3, snr_db=25.0, seed=5)
    cap = sim.synthesize(scen)
    sigs = jnp.asarray(cap.iq, jnp.complex64)
    max_lag = 512
    peaks = gcc_phat.gcc_phat_all_pairs(sigs, sample_rate_hz=scen.sample_rate_hz, max_lag=max_lag)
    i_idx, j_idx = gcc_phat.pair_indices(4)
    assert peaks.lag_samples.shape == (len(i_idx),)
    got = np.asarray(peaks.lag_samples)
    want = np.array(
        [cap.true_pair_lag_samples(i, j) for i, j in zip(i_idx, j_idx)]
    )
    np.testing.assert_allclose(got, want, atol=0.1)
    # Triangle closure: lag(0,1) + lag(1,2) == lag(0,2) (within interp noise)
    lag = {(i, j): g for i, j, g in zip(i_idx, j_idx, got)}
    assert abs(lag[(0, 1)] + lag[(1, 2)] - lag[(0, 2)]) < 0.2


def test_psr_quality_metric():
    # Full-band signal: correlation main lobe is ~1 sample wide, so the
    # default PSR exclusion window cleanly separates peak from sidelobes.
    x, y = _delayed_pair(15.0, snr_db=30.0, bw=2.4e6, seed=3)
    strong = gcc_phat.gcc_phat(
        jnp.asarray(x, jnp.complex64), jnp.asarray(y, jnp.complex64),
        sample_rate_hz=FS, max_lag=256,
    )
    rng = np.random.default_rng(0)
    n1 = rng.normal(size=x.shape[0]) + 1j * rng.normal(size=x.shape[0])
    n2 = rng.normal(size=x.shape[0]) + 1j * rng.normal(size=x.shape[0])
    weak = gcc_phat.gcc_phat(
        jnp.asarray(n1, jnp.complex64), jnp.asarray(n2, jnp.complex64),
        sample_rate_hz=FS, max_lag=256,
    )
    assert float(strong.psr) > float(weak.psr) * 2.0


def test_max_lag_window_excludes_far_peaks():
    x, y = _delayed_pair(100.0, seed=11)
    peak = gcc_phat.gcc_phat(
        jnp.asarray(x, jnp.complex64), jnp.asarray(y, jnp.complex64),
        sample_rate_hz=FS, max_lag=50,
    )
    # True lag outside the window: result must stay inside ±max_lag.
    assert abs(float(peak.lag_samples)) <= 50.0


def test_coherent_blocks_match_single_for_stationary():
    """Cross-spectrum dwell averaging (memory-light path) recovers the same
    lag as one long correlation for a stationary band-limited signal."""
    n_total, true_lag = 65_536, 17.4
    # wideband (sharp correlation lobe): the op's documented scope —
    # narrowband swept signals belong to the long-correlation path
    x, y = _delayed_pair(true_lag, n=n_total, snr_db=10.0, bw=500e3, seed=5)
    sig = jnp.asarray(np.stack([x, y]), jnp.complex64)[None]  # [1, 2, N]
    one = gcc_phat.gcc_phat_all_pairs(sig, sample_rate_hz=FS, max_lag=256)
    coh = gcc_phat.gcc_phat_all_pairs_coherent(
        sig, sample_rate_hz=FS, max_lag=256, num_blocks=8
    )
    assert abs(float(one.lag_samples[0, 0]) - true_lag) < 0.2
    assert abs(float(coh.lag_samples[0, 0]) - true_lag) < 0.2


def test_coherent_blocks_validates_divisibility():
    sig = jnp.zeros((2, 1000), jnp.complex64)
    with pytest.raises(ValueError):
        gcc_phat.gcc_phat_all_pairs_coherent(
            sig, sample_rate_hz=FS, max_lag=16, num_blocks=3
        )


def test_coherent_blocks_scot_weighting_runs():
    """The dwell-averaged auto-power denominators (scot path) produce
    finite windows and a sane peak for a strong stationary signal."""
    x, y = _delayed_pair(9.0, n=32_768, snr_db=20.0, bw=500e3, seed=9)
    sig = jnp.asarray(np.stack([x, y]), jnp.complex64)[None]
    pk = gcc_phat.gcc_phat_all_pairs_coherent(
        sig, sample_rate_hz=FS, max_lag=128, num_blocks=4, weighting="scot"
    )
    assert np.isfinite(np.asarray(pk.peak_value)).all()
    assert abs(float(pk.lag_samples[0, 0]) - 9.0) < 0.5
