"""FFT entry points (XLA's native FFT) vs. NumPy float64 reference."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from radio_mapper_tpu.ops import fft as fft_ops


def _rand_c(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def _rel_err(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("n", [8, 128, 1024, 2048, 4096, 16384, 32768])
def test_fft_matches_numpy(n):
    x = _rand_c((n,), seed=n)
    got = np.asarray(fft_ops.fft(jnp.asarray(x)))
    want = np.fft.fft(x.astype(np.complex128))
    # Relative error scaled by the spectrum magnitude (f32 accumulate).
    err = _rel_err(got, want)
    assert err < 2e-5, (n, err)


# The pipeline's split-form lengths: the flagship's padded 17280 among them.
@pytest.mark.parametrize("n", [1024, 4096, 16384, 17280, 32768])
def test_fft_re_im_matches_numpy(n):
    x = _rand_c((3, n), seed=n)
    re, im = fft_ops.fft_re_im(jnp.asarray(x.real), jnp.asarray(x.imag))
    want = np.fft.fft(x.astype(np.complex128), axis=-1)
    err = _rel_err(np.asarray(re) + 1j * np.asarray(im), want)
    assert err < 2e-5, (n, err)


@pytest.mark.parametrize("n", [1024, 16384])
def test_ifft_roundtrip(n):
    x = _rand_c((4, n), seed=n + 1)
    y = fft_ops.ifft(fft_ops.fft(jnp.asarray(x)))
    err = np.abs(np.asarray(y) - x).max()
    assert err < 1e-4, err


@pytest.mark.parametrize("n", [4096, 17280])
def test_ifft_re_im_roundtrip_and_scale(n):
    x = _rand_c((2, n), seed=n + 2)
    fr, fi = fft_ops.fft_re_im(jnp.asarray(x.real), jnp.asarray(x.imag))
    yr, yi = fft_ops.ifft_re_im(fr, fi)
    assert np.abs(np.asarray(yr) + 1j * np.asarray(yi) - x).max() < 1e-4
    # 1/N normalisation, as numpy's ifft
    want = np.fft.ifft(x.astype(np.complex128), axis=-1)
    got_r, got_i = fft_ops.ifft_re_im(jnp.asarray(x.real), jnp.asarray(x.imag))
    assert _rel_err(np.asarray(got_r) + 1j * np.asarray(got_i), want) < 2e-5


def test_batched_matches_numpy():
    x = _rand_c((3, 5, 2048), seed=2)
    got = np.asarray(fft_ops.fft(jnp.asarray(x)))
    want = np.fft.fft(x.astype(np.complex128), axis=-1)
    err = _rel_err(got, want)
    assert err < 2e-5, err


def test_split_multi_dim_batch():
    x = _rand_c((2, 3, 1024), seed=3)
    re, im = fft_ops.fft_re_im(jnp.asarray(x.real), jnp.asarray(x.imag))
    assert re.shape == im.shape == (2, 3, 1024)
    want = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert _rel_err(np.asarray(re) + 1j * np.asarray(im), want) < 2e-5


def test_padding():
    x = _rand_c((100,), seed=3)
    got = np.asarray(fft_ops.fft(jnp.asarray(x), n=256))
    want = np.fft.fft(x.astype(np.complex128), n=256)
    assert _rel_err(got, want) < 2e-5


def test_split_padding_and_truncation():
    x = _rand_c((2, 300), seed=8)
    for n in (512, 128):
        re, im = fft_ops.fft_re_im(jnp.asarray(x.real), jnp.asarray(x.imag), n=n)
        want = np.fft.fft(x.astype(np.complex128), n=n, axis=-1)
        assert re.shape == (2, n)
        assert _rel_err(np.asarray(re) + 1j * np.asarray(im), want) < 2e-5


def test_truncation():
    x = _rand_c((300,), seed=4)
    got = np.asarray(fft_ops.fft(jnp.asarray(x), n=128))
    want = np.fft.fft(x.astype(np.complex128)[:128])
    assert _rel_err(got, want) < 2e-5


def test_axis_argument():
    x = _rand_c((64, 7), seed=5)
    got = np.asarray(fft_ops.fft(jnp.asarray(x), axis=0))
    want = np.fft.fft(x.astype(np.complex128), axis=0)
    assert _rel_err(got, want) < 2e-5


def test_non_pow2_composite():
    # 1536 = 512 * 3: a mixed-radix length.
    x = _rand_c((1536,), seed=6)
    got = np.asarray(fft_ops.fft(jnp.asarray(x)))
    want = np.fft.fft(x.astype(np.complex128))
    assert _rel_err(got, want) < 2e-5


@pytest.mark.parametrize("n", [2053, 17281])  # primes
def test_prime_lengths_supported(n):
    x = _rand_c((n,), seed=n)
    got = np.asarray(fft_ops.fft(jnp.asarray(x)))
    want = np.fft.fft(x.astype(np.complex128))
    assert _rel_err(got, want) < 1e-4


def test_split_representation():
    x = _rand_c((2048,), seed=7)
    re, im = fft_ops.fft_re_im(jnp.real(jnp.asarray(x)), jnp.imag(jnp.asarray(x)))
    want = np.fft.fft(x.astype(np.complex128))
    got = np.asarray(re) + 1j * np.asarray(im)
    assert _rel_err(got, want) < 2e-5


def primitives(jaxpr):
    """Every primitive name in ``jaxpr``, nested jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        out.append(eqn.primitive.name)
        for p in eqn.params.values():
            for sub in p if isinstance(p, (list, tuple)) else (p,):
                if hasattr(sub, "eqns"):
                    out += primitives(sub)
                elif hasattr(getattr(sub, "jaxpr", None), "eqns"):
                    out += primitives(sub.jaxpr)
    return out


def test_split_form_lowers_to_one_fft_op():
    """fft_re_im is XLA's FFT and nothing else heavy: no dot_general."""
    jaxpr = jax.make_jaxpr(fft_ops.fft_re_im)(
        jnp.zeros((2, 17280), jnp.float32), jnp.zeros((2, 17280), jnp.float32)
    )
    prims = primitives(jaxpr.jaxpr)
    assert prims.count("fft") == 1, prims
    assert "dot_general" not in prims


def test_friendly_fft_len_is_5_smooth_and_tight():
    assert fft_ops.friendly_fft_len(16384 + 512) == 17280
    assert fft_ops.friendly_fft_len(4096) == 4096
    for m in (1000, 4223, 16896, 33000):
        n = fft_ops.friendly_fft_len(m)
        assert n >= m and n < 1.25 * m
        k = n
        for p in (2, 3, 5):
            while k % p == 0:
                k //= p
        assert k == 1, n


def test_gcc_phat_still_accurate_with_matmul_fft():
    """Integration: sub-sample TDOA holds on the pipeline's FFT path."""
    from radio_mapper_tpu.ops import gcc_phat as gp

    fs = 2_400_000.0
    n = 16_384
    rng = np.random.default_rng(11)
    f = np.fft.fftfreq(n, 1 / fs)
    spec = (rng.normal(size=n) + 1j * rng.normal(size=n)) * (np.abs(f) <= 100e3)
    s = np.fft.ifft(spec)
    s /= np.sqrt(np.mean(np.abs(s) ** 2))
    true_lag = 17.31
    x = np.fft.ifft(np.fft.fft(s) * np.exp(-2j * np.pi * f * true_lag / fs))
    peak = gp.gcc_phat(
        jnp.asarray(x, jnp.complex64),
        jnp.asarray(s, jnp.complex64),
        sample_rate_hz=fs,
        max_lag=256,
    )
    assert abs(float(peak.lag_samples) - true_lag) < 0.1
