"""Safe-mode primitives vs stock XLA ops (exactness / tolerance)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from radio_mapper_tpu.ops import safe


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_argmax_and_take(rng):
    x = jnp.asarray(rng.normal(size=(5, 257)).astype(np.float32))
    np.testing.assert_array_equal(
        np.asarray(safe.argmax_last(x)), np.argmax(np.asarray(x), axis=-1)
    )
    k = jnp.asarray(rng.integers(0, 257, size=(5,)).astype(np.int32))
    want = np.take_along_axis(np.asarray(x), np.asarray(k)[:, None], axis=-1)[:, 0]
    np.testing.assert_allclose(np.asarray(safe.take1_last(x, k)), want, atol=1e-6)


def test_take_many(rng):
    x = jnp.asarray(rng.normal(size=(3, 64)).astype(np.float32))
    k = jnp.asarray(rng.integers(0, 64, size=(3, 4)).astype(np.int32))
    want = np.take_along_axis(np.asarray(x), np.asarray(k), axis=-1)
    np.testing.assert_allclose(np.asarray(safe.take_many_last(x, k)), want, atol=1e-6)


@pytest.mark.parametrize("radius", [1, 3, 10, 17])
def test_sliding_max_matches_circular_reference(rng, radius):
    x = rng.normal(size=(2, 128)).astype(np.float32)
    got = np.asarray(safe.sliding_max(jnp.asarray(x), radius))
    n = x.shape[-1]
    want = np.empty_like(x)
    for i in range(n):
        idx = [(i + d) % n for d in range(-radius, radius + 1)]
        want[:, i] = x[:, idx].max(axis=-1)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_median_bisect_accuracy(rng):
    x = rng.normal(size=(4, 16384)).astype(np.float32) * 40 - 60
    got = np.asarray(safe.median_bisect(jnp.asarray(x)))
    want = np.median(x, axis=-1)
    # Bisection converges to a point between the two middle order statistics.
    for g, w, row in zip(got, want, x):
        s = np.sort(row)
        lo, hi = s[len(s) // 2 - 1], s[len(s) // 2]
        assert lo - 1e-3 <= g <= hi + 1e-3, (g, lo, hi, w)


def test_top_k_matches_lax(rng):
    x = jnp.asarray(rng.normal(size=(6, 300)).astype(np.float32))
    sv, si = safe.top_k(x, 5)
    lv, li = jax.lax.top_k(x, 5)
    np.testing.assert_allclose(np.asarray(sv), np.asarray(lv), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(si), np.asarray(li))


def test_top_k_with_neg_inf_padding(rng):
    x = np.full((1, 32), -np.inf, np.float32)
    x[0, 5] = 3.0
    x[0, 20] = 1.0
    vals, idxs = safe.top_k(jnp.asarray(x), 4)
    v = np.asarray(vals)[0]
    assert v[0] == 3.0 and v[1] == 1.0
    assert not np.isfinite(v[2:]).any()


def test_detector_identical_under_safe_mode():
    from radio_mapper_tpu.ops import detect

    rng = np.random.default_rng(3)
    t = np.arange(16384) / 2.048e6
    iq = (
        150 * np.exp(2j * np.pi * 300e3 * t)
        + 90 * np.exp(2j * np.pi * -500e3 * t)
        + rng.normal(size=16384)
    ).astype(np.complex64)

    safe.set_safe_mode(False)
    try:
        stock = detect.detect_signals(jnp.asarray(iq), sample_rate_hz=2.048e6)
    finally:
        safe.set_safe_mode(None)
    safe.set_safe_mode(True)
    try:
        safed = detect.detect_signals(jnp.asarray(iq), sample_rate_hz=2.048e6)
    finally:
        safe.set_safe_mode(None)

    np.testing.assert_array_equal(np.asarray(stock.valid), np.asarray(safed.valid))
    np.testing.assert_array_equal(
        np.asarray(stock.bin_index), np.asarray(safed.bin_index)
    )
    np.testing.assert_allclose(
        np.asarray(stock.confidence), np.asarray(safed.confidence), atol=2e-3
    )


def test_gcc_identical_under_safe_mode():
    from radio_mapper_tpu.ops import gcc_phat as gp

    fs = 2.4e6
    n = 8192
    rng = np.random.default_rng(4)
    f = np.fft.fftfreq(n, 1 / fs)
    spec = (rng.normal(size=n) + 1j * rng.normal(size=n)) * (np.abs(f) <= 150e3)
    s = np.fft.ifft(spec)
    x = np.fft.ifft(np.fft.fft(s) * np.exp(-2j * np.pi * f * 12.5 / fs))

    def run():
        return gp.gcc_phat(
            jnp.asarray(x, jnp.complex64), jnp.asarray(s, jnp.complex64),
            sample_rate_hz=fs, max_lag=128,
        )

    safe.set_safe_mode(False)
    try:
        a = run()
    finally:
        safe.set_safe_mode(None)
    safe.set_safe_mode(True)
    try:
        b = run()
    finally:
        safe.set_safe_mode(None)
    assert abs(float(a.lag_samples) - float(b.lag_samples)) < 1e-4
    assert abs(float(a.psr) - float(b.psr)) < 1e-3


def test_top_k_segmented_matches_flat_on_separated_candidates():
    """With candidates ≥ segment apart (the sliding-local-max guarantee),
    segmented and flat top-k agree exactly, including tie-breaks and
    all-(-inf) rows."""
    import numpy as np
    import jax.numpy as jnp
    from radio_mapper_tpu.ops import safe

    rng = np.random.default_rng(11)
    n, seg, k = 1024, 8, 8
    score = np.full((5, n), -np.inf, dtype=np.float32)
    for r in range(5):
        # 12 candidates at ≥ 9-bin spacing with distinct values.
        pos = np.sort(rng.choice(np.arange(0, n // 9), size=12, replace=False)) * 9
        score[r, pos] = rng.permutation(12).astype(np.float32) - 60.0
    score[4, :] = -np.inf  # a row with no candidates at all
    fv, fi = safe.top_k(jnp.asarray(score), k)
    sv, si = safe.top_k_segmented(jnp.asarray(score), k, seg)
    np.testing.assert_array_equal(np.asarray(fv), np.asarray(sv))
    finite = np.isfinite(np.asarray(fv))
    np.testing.assert_array_equal(
        np.asarray(fi)[finite], np.asarray(si)[finite]
    )


def test_sliding_max_impls_identical_and_edge_cases():
    """The reduce_window form must equal roll-doubling for every radius,
    including the radius=0 and radius>=length edge cases (regression:
    x[..., -0:] slices the whole array, not zero elements)."""
    import numpy as np

    from radio_mapper_tpu.ops import safe

    x = jnp.asarray(np.random.default_rng(3).normal(size=(2, 3, 64)).astype(np.float32))
    for r in (0, 1, 5, 31, 63, 64, 100):
        safe.set_sliding_impl("window")
        a = np.asarray(safe.sliding_max(x, r))
        safe.set_sliding_impl("roll")
        b = np.asarray(safe.sliding_max(x, r))
        safe.set_sliding_impl("window")
        assert a.shape == x.shape, (r, a.shape)
        if r < x.shape[-1]:
            np.testing.assert_array_equal(a, b, err_msg=f"radius {r}")
        else:
            # circular window covers everything: global max everywhere
            np.testing.assert_array_equal(
                a, np.broadcast_to(np.asarray(x).max(-1, keepdims=True), a.shape)
            )
