"""Sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec as P

from radio_mapper_tpu.models.streaming import StreamingChannelizer, sharded_channelize
from radio_mapper_tpu.ops.channelizer import channelize
from radio_mapper_tpu.parallel import halo, mesh as mesh_lib
from radio_mapper_tpu.parallel.sharded import (
    ShardedStepConfig,
    build_sharded_step,
    example_inputs,
)


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_balanced_mesh_shape():
    assert mesh_lib.balanced_mesh_shape(8) == (2, 4)
    assert mesh_lib.balanced_mesh_shape(16) == (4, 4)
    assert mesh_lib.balanced_mesh_shape(7) == (1, 7)


def test_left_halo_exchange():
    m = mesh_lib.make_mesh((4,), ("blk",), devices=jax.devices()[:4])
    x = jnp.arange(4 * 8, dtype=jnp.float32).reshape(4, 8).reshape(-1)  # 0..31

    def f(x_l):
        return halo.with_left_halo(x_l, "blk", 3)

    out = jax.jit(
        jax.shard_map(f, mesh=m, in_specs=P("blk"), out_specs=P("blk"))
    )(x)
    out = np.asarray(out).reshape(4, 11)
    # Shard 0: zero halo; shard k: last 3 of shard k-1.
    np.testing.assert_array_equal(out[0][:3], [0, 0, 0])
    np.testing.assert_array_equal(out[1][:3], [5, 6, 7])
    np.testing.assert_array_equal(out[3][:3], [21, 22, 23])
    np.testing.assert_array_equal(out[2][3:], np.arange(16, 24))


def test_streaming_channelizer_matches_batch():
    """Two sequential blocks == one big block (gap-free overlap-save)."""
    m = 8
    fs = 2_048_000.0
    rng = np.random.default_rng(0)
    x = (rng.normal(size=4096) + 1j * rng.normal(size=4096)).astype(np.complex64)

    sc = StreamingChannelizer(m, sample_rate_hz=fs, taps_per_channel=4)
    st = sc.init_state()
    st, out1 = sc.step(st, jnp.asarray(x[:2048]))
    st, out2 = sc.step(st, jnp.asarray(x[2048:]))
    stream = np.concatenate([np.asarray(out1.channels), np.asarray(out2.channels)], axis=-1)

    # Sequential-with-state must equal one call on the zero-history-prefixed
    # full signal.
    hist = sc.history
    full = channelize(
        jnp.concatenate([jnp.zeros(hist, jnp.complex64), jnp.asarray(x)]),
        m,
        sample_rate_hz=fs,
        taps_per_channel=4,
    )
    np.testing.assert_allclose(stream, np.asarray(full.channels), atol=1e-4)
    assert stream.shape == (m, 4096 // m)


def test_sharded_channelizer_matches_sequential():
    """ppermute halo version == carry-state version, exactly."""
    m_sub = 8
    fs = 2_048_000.0
    n_dev = 4
    per_shard = 512
    rng = np.random.default_rng(1)
    x = (rng.normal(size=n_dev * per_shard) + 1j * rng.normal(size=n_dev * per_shard)).astype(
        np.complex64
    )

    msh = mesh_lib.make_mesh((n_dev,), ("blk",), devices=jax.devices()[:n_dev])

    def f(x_l):
        return sharded_channelize(x_l, m_sub, sample_rate_hz=fs, taps_per_channel=4).channels

    sharded = jax.jit(
        jax.shard_map(f, mesh=msh, in_specs=P("blk"), out_specs=P(None, "blk"))
    )(jnp.asarray(x))

    sc = StreamingChannelizer(m_sub, sample_rate_hz=fs, taps_per_channel=4)
    st = sc.init_state()
    outs = []
    for k in range(n_dev):
        st, o = sc.step(st, jnp.asarray(x[k * per_shard : (k + 1) * per_shard]))
        outs.append(np.asarray(o.channels))
    seq = np.concatenate(outs, axis=-1)
    np.testing.assert_allclose(np.asarray(sharded), seq, atol=1e-4)


def test_full_sharded_step_runs_and_is_finite():
    msh = mesh_lib.make_mesh()  # (2, 4) over 8 CPU devices
    cfg = ShardedStepConfig()
    step, _ = build_sharded_step(msh, cfg)
    x, anchors = example_inputs(msh, cfg, samples_per_shard=512)
    out = step(x, anchors)
    s = msh.shape["blk"]
    assert out.fixes_enu.shape == (s, cfg.num_channels, cfg.num_subchannels, 3)
    assert out.lags.shape == (s, cfg.num_channels, cfg.num_subchannels, cfg.num_pairs)
    assert bool(jnp.all(jnp.isfinite(out.fixes_enu)))
    assert bool(jnp.all(jnp.abs(out.lags) <= cfg.max_lag))


def test_sharded_step_equals_single_device():
    """SPMD result == the same math on one device (bitwise-ish)."""
    cfg = ShardedStepConfig(num_channels=2, num_buoys=3, num_subchannels=4, max_lag=8)
    msh8 = mesh_lib.make_mesh((2, 4), ("ch", "blk"))
    msh1 = mesh_lib.make_mesh((1, 1), ("ch", "blk"), devices=jax.devices()[:1])
    step8, _ = build_sharded_step(msh8, cfg)
    step1, _ = build_sharded_step(msh1, cfg)

    x, anchors = example_inputs(msh8, cfg, samples_per_shard=256, seed=3)
    x_np, a_np = np.asarray(x), np.asarray(anchors)
    out8 = step8(x, anchors)
    # Single "shard" sees the whole stream; compare only shard 0 of the
    # 4-shard run against the first quarter... instead compare via the
    # sequential streaming equivalence already proven; here check the
    # multi-shard lags for shard 0 equal the single-device run restricted
    # to the same samples (zero history in both).
    x0 = x_np[..., :256]
    out1 = step1(jnp.asarray(x0), jnp.asarray(a_np))
    np.testing.assert_allclose(
        np.asarray(out8.lags)[0], np.asarray(out1.lags)[0], atol=1e-3
    )


@pytest.mark.parametrize("shape", [(2, 4), (1, 8), (8, 1)])
def test_split_sharded_step_equals_one_device_reference(shape):
    """Every time shard, halo included, == the sliced one-device step."""
    from radio_mapper_tpu.parallel.sharded import (
        build_sharded_step_split,
        example_inputs_split,
        reference_step_split,
    )

    cfg = ShardedStepConfig(num_channels=8, num_buoys=3, num_subchannels=4, max_lag=8)
    msh = mesh_lib.make_mesh(shape, ("ch", "blk"))
    step, _ = build_sharded_step_split(msh, cfg)
    re, im, anchors = example_inputs_split(msh, cfg, samples_per_shard=256, seed=7)
    out = step(re, im, anchors)
    ref = reference_step_split(cfg, re, im, anchors, time_shards=shape[1])
    assert ref.lags.shape == out.lags.shape == (shape[1], 8, 4, cfg.num_pairs)
    np.testing.assert_allclose(np.asarray(out.lags), np.asarray(ref.lags), atol=1e-4)
    np.testing.assert_allclose(np.asarray(out.weights), np.asarray(ref.weights), atol=1e-4)


def test_split_sharded_step_matches_complex():
    """The complex-free pod program equals the complex mesh program."""
    from radio_mapper_tpu.parallel.sharded import (
        build_sharded_step_split,
        example_inputs_split,
    )

    msh = mesh_lib.make_mesh((2, 4), ("ch", "blk"))
    cfg = ShardedStepConfig(num_channels=2, num_buoys=3, num_subchannels=4, max_lag=8)

    step_c, _ = build_sharded_step(msh, cfg)
    step_s, _ = build_sharded_step_split(msh, cfg)

    re, im, anchors = example_inputs_split(msh, cfg, samples_per_shard=256, seed=5)
    x = jnp.asarray(np.asarray(re) + 1j * np.asarray(im), jnp.complex64)
    out_c = step_c(jax.device_put(x, re.sharding), anchors)
    out_s = step_s(re, im, anchors)
    np.testing.assert_allclose(
        np.asarray(out_s.lags), np.asarray(out_c.lags), atol=5e-3
    )
    np.testing.assert_allclose(
        np.asarray(out_s.weights), np.asarray(out_c.weights), atol=1e-2
    )
