"""The full SPMD pipeline step over a ("ch", "blk") device mesh.

Mapping onto classic parallelism dimensions:

  DP ("ch")    — wideband channels batch-shard across the "ch" axis (the
                 reference's one-process-per-buoy/dwell, batched);
  SP ("blk")   — the capture's time axis shards across "blk"; overlap-save
                 filter history crosses shard edges via `ppermute`
                 (:mod:`radio_mapper_tpu.parallel.halo`) — sequence
                 parallelism with halo exchange;
  EP (pairs)   — the O(B²) GCC pair axis is a batch axis inside each shard
                 and its products are combined across the mesh by
                 `all_gather` (the reference's sequential pair loop,
                 `tdoa_processor.py:156-193`);
  PP           — the detect→correlate→solve stages remain one fused XLA
                 program per shard by design: staging through device
                 memory between "pipeline stages" would only add
                 bandwidth cost.

The step is a single jitted `shard_map` program: channelize (with halo) →
per-subchannel all-pairs GCC-PHAT → confidence-weighted LM solve →
all_gather of per-shard fixes. Used by `__graft_entry__.dryrun_multichip`
and the scaling bench.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from radio_mapper_tpu import solver
from radio_mapper_tpu.models.streaming import sharded_channelize
from radio_mapper_tpu.ops import gcc_phat as gcc_ops
from radio_mapper_tpu.ops import split_complex as sc_ops
from radio_mapper_tpu.parallel.halo import with_left_halo


@dataclasses.dataclass(frozen=True)
class ShardedStepConfig:
    num_channels: int = 4  # wideband channels (sharded over "ch")
    num_buoys: int = 4
    num_subchannels: int = 8  # PFB branches per wideband channel
    taps_per_channel: int = 4
    sample_rate_hz: float = 2_048_000.0
    max_lag: int = 16  # at the sub-channel rate
    solver_iterations: int = 15
    psr_floor: float = 1.1
    psr_scale: float = 2.0

    @property
    def num_pairs(self) -> int:
        return self.num_buoys * (self.num_buoys - 1) // 2


class ShardedStepOutput(NamedTuple):
    fixes_enu: jnp.ndarray  # [S, C, M, 3] per time-shard, channel, subchannel
    lags: jnp.ndarray  # [S, C, M, P] pair lags (samples @ subchannel rate)
    weights: jnp.ndarray  # [S, C, M, P]
    cost: jnp.ndarray  # [S, C, M]


def build_sharded_step(mesh: Mesh, config: ShardedStepConfig):
    """Compile the full sharded streaming step for ``mesh``.

    Returns ``(step_fn, in_shardings)`` where
    ``step_fn(wideband, anchors_enu) -> ShardedStepOutput``:

      wideband:    [C, B, N] complex64, C sharded over "ch", N over "blk";
      anchors_enu: [B, 3] float32, replicated.
    """
    cfg = config
    i_idx, j_idx = gcc_ops.pair_indices(cfg.num_buoys)
    pair_i = jnp.asarray(i_idx)
    pair_j = jnp.asarray(j_idx)
    sub_rate = cfg.sample_rate_hz / cfg.num_subchannels

    def local_step(x_local: jnp.ndarray, anchors: jnp.ndarray) -> ShardedStepOutput:
        # x_local: [C_l, B, N_l] — this shard's channels × buoys × samples.
        chs = sharded_channelize(
            x_local,
            cfg.num_subchannels,
            sample_rate_hz=cfg.sample_rate_hz,
            taps_per_channel=cfg.taps_per_channel,
            block_axis_name="blk",
        ).channels  # [C_l, B, M, F]
        # Correlate buoys against each other per (channel, subchannel).
        sub = jnp.moveaxis(chs, 1, 2)  # [C_l, M, B, F]
        corr = gcc_ops.gcc_phat_all_pairs(
            sub, sample_rate_hz=sub_rate, max_lag=cfg.max_lag
        )  # fields [C_l, M, P]
        weights = jnp.clip((corr.psr - cfg.psr_floor) / cfg.psr_scale, 0.0, 1.0) + 1e-3
        dd = solver.tau_to_distance_difference(corr.tau_s)
        res = solver.solve_tdoa(
            anchors,
            pair_i,
            pair_j,
            dd,
            weights,
            iterations=cfg.solver_iterations,
        )
        # Each shard contributes its time segment's results; the leading
        # axis concatenates across "blk" in the global view (no collective
        # needed — the output stays sharded exactly where it was computed).
        return ShardedStepOutput(
            fixes_enu=res.position_enu[None],
            lags=corr.lag_samples[None],
            weights=weights[None],
            cost=res.cost[None],
        )

    in_specs = (P("ch", None, "blk"), P())
    out_specs = ShardedStepOutput(
        fixes_enu=P("blk", "ch"),
        lags=P("blk", "ch"),
        weights=P("blk", "ch"),
        cost=P("blk", "ch"),
    )
    step = jax.jit(
        jax.shard_map(local_step, mesh=mesh, in_specs=in_specs, out_specs=out_specs)
    )
    in_shardings = (
        NamedSharding(mesh, in_specs[0]),
        NamedSharding(mesh, in_specs[1]),
    )
    return step, in_shardings


def _halo_len(cfg: ShardedStepConfig) -> int:
    """Channelizer history a time segment needs from its left neighbour."""
    return (cfg.taps_per_channel - 1) * cfg.num_subchannels


def _segment_step_split(cfg: ShardedStepConfig):
    """One time segment of the split step: ``(re_ext, im_ext, anchors)``
    whose first :func:`_halo_len` samples are the previous segment's tail
    → :class:`ShardedStepOutput` with a leading segment axis of 1."""
    i_idx, j_idx = gcc_ops.pair_indices(cfg.num_buoys)
    pair_i = jnp.asarray(i_idx)
    pair_j = jnp.asarray(j_idx)
    sub_rate = cfg.sample_rate_hz / cfg.num_subchannels

    def segment(re_ext, im_ext, anchors):
        ch_re, ch_im = sc_ops.channelize_split(
            re_ext, im_ext, cfg.num_subchannels,
            sample_rate_hz=cfg.sample_rate_hz,
            taps_per_channel=cfg.taps_per_channel,
        )  # [C_l, B, M, F]
        sub_re = jnp.moveaxis(ch_re, 1, 2)  # [C_l, M, B, F]
        sub_im = jnp.moveaxis(ch_im, 1, 2)
        corr = sc_ops.gcc_phat_all_pairs_split(
            sub_re, sub_im, sample_rate_hz=sub_rate, max_lag=cfg.max_lag
        )
        weights = jnp.clip((corr.psr - cfg.psr_floor) / cfg.psr_scale, 0.0, 1.0) + 1e-3
        dd = solver.tau_to_distance_difference(corr.tau_s)
        res = solver.solve_tdoa(
            anchors, pair_i, pair_j, dd, weights, iterations=cfg.solver_iterations
        )
        return ShardedStepOutput(
            fixes_enu=res.position_enu[None],
            lags=corr.lag_samples[None],
            weights=weights[None],
            cost=res.cost[None],
        )

    return segment


def build_sharded_step_split(mesh: Mesh, config: ShardedStepConfig):
    """Split-complex variant of :func:`build_sharded_step`, on the (re, im)
    float32 planes the uint8 ingest produces. Inputs are ``[C, B, N]``
    pairs sharded identically to the complex path."""
    cfg = config
    history = _halo_len(cfg)
    segment = _segment_step_split(cfg)

    def local_step(re_l, im_l, anchors):
        return segment(
            with_left_halo(re_l, "blk", history),
            with_left_halo(im_l, "blk", history),
            anchors,
        )

    in_specs = (P("ch", None, "blk"), P("ch", None, "blk"), P())
    out_specs = ShardedStepOutput(
        fixes_enu=P("blk", "ch"),
        lags=P("blk", "ch"),
        weights=P("blk", "ch"),
        cost=P("blk", "ch"),
    )
    step = jax.jit(
        jax.shard_map(local_step, mesh=mesh, in_specs=in_specs, out_specs=out_specs)
    )
    in_shardings = tuple(NamedSharding(mesh, sp) for sp in in_specs)
    return step, in_shardings


def reference_step_split(config: ShardedStepConfig, re, im, anchors, *,
                         time_shards: int, device=None) -> ShardedStepOutput:
    """What :func:`build_sharded_step_split` computes over a mesh with
    ``time_shards`` on "blk", on one device: the time axis is cut into
    segments and each is given its left neighbour's tail (zeros for the
    first) by slicing instead of the halo ``ppermute``."""
    cfg = config
    history = _halo_len(cfg)
    re, im = np.asarray(re), np.asarray(im)
    seg_len = re.shape[-1] // time_shards
    zeros = np.zeros((*re.shape[:-1], history), re.dtype)
    device = device or jax.devices()[0]
    segment = jax.jit(_segment_step_split(cfg))
    anchors = jax.device_put(np.asarray(anchors), device)
    outs = []
    for s in range(time_shards):
        lo, hi = s * seg_len, (s + 1) * seg_len
        ext = [
            np.concatenate([x[..., lo - history:lo] if s else zeros, x[..., lo:hi]], axis=-1)
            for x in (re, im)
        ]
        outs.append(segment(*jax.device_put(ext, device), anchors))
    return jax.tree.map(lambda *xs: jnp.concatenate(xs), *outs)


def example_inputs(mesh: Mesh, config: ShardedStepConfig, *, samples_per_shard: int = 512, seed: int = 0):
    """Device-placed random inputs sized for the mesh."""
    cfg = config
    s = mesh.shape["blk"]
    rng = np.random.default_rng(seed)
    n = s * samples_per_shard
    x = (
        rng.normal(size=(cfg.num_channels, cfg.num_buoys, n))
        + 1j * rng.normal(size=(cfg.num_channels, cfg.num_buoys, n))
    ).astype(np.complex64)
    anchors = rng.normal(scale=5_000.0, size=(cfg.num_buoys, 3)).astype(np.float32)
    anchors[:, 2] = 0.0
    x_sharding = NamedSharding(mesh, P("ch", None, "blk"))
    a_sharding = NamedSharding(mesh, P())
    return (
        jax.device_put(x, x_sharding),
        jax.device_put(anchors, a_sharding),
    )


def example_inputs_split(mesh: Mesh, config: ShardedStepConfig, *, samples_per_shard: int = 512, seed: int = 0):
    """(re, im, anchors) float32, device-placed — no complex dtype."""
    cfg = config
    s = mesh.shape["blk"]
    rng = np.random.default_rng(seed)
    n = s * samples_per_shard
    re = rng.normal(size=(cfg.num_channels, cfg.num_buoys, n)).astype(np.float32)
    im = rng.normal(size=(cfg.num_channels, cfg.num_buoys, n)).astype(np.float32)
    anchors = rng.normal(scale=5_000.0, size=(cfg.num_buoys, 3)).astype(np.float32)
    anchors[:, 2] = 0.0
    x_sharding = NamedSharding(mesh, P("ch", None, "blk"))
    a_sharding = NamedSharding(mesh, P())
    return (
        jax.device_put(re, x_sharding),
        jax.device_put(im, x_sharding),
        jax.device_put(anchors, a_sharding),
    )
