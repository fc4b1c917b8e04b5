"""Wideband channelized TDOA: BASELINE config 4 end-to-end.

"64 buoys wideband (10 MS/s) with polyphase channelizer + all-pairs
GCC-PHAT, 1 host" (BASELINE.json configs[3]). The reference covers wide
spectrum by HOPPING one narrow tuner through a 35 s schedule
(the reference's `buoy_node.py:146-153`); this design watches the
whole band at once: each buoy's 10 MS/s stream splits into M uniform
subchannels (ops/channelizer PFB), and every subchannel runs the full
all-pairs GCC-PHAT + LM solve — 64 receivers ⇒ 2016 pairs per
subchannel, M·2016 pair correlations per block.

Structure per step (one jit-compiled program):

  re/im [B, N_wide] ── PFB channelize (split-complex) ──► [M, B, n_sub]
    └─ lax.scan over M subchannels:
         forward FFT (B rows) ─► pair gather (2·P rows)
         ─► whiten ─► inverse FFT ─► lag window
  then, batched over all M subchannels:
         peak pick ─► PSR weights ─► LM solve
       ⇒ per-subchannel fixes [M, 3] + lags/weights [M, P]

`lax.scan` (not a batch axis) keeps the peak working set at ONE
subchannel's pair spectra (~140 MB of f32 planes at P=2016, nfft 4320)
instead of M× that, and compiles the subchannel body once — the same
argument as the flagship multi-block scan (models/pipeline.py).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from radio_mapper_tpu import solver
from radio_mapper_tpu.ops import fft as fft_ops
from radio_mapper_tpu.ops import gcc_phat as gcc_ops
from radio_mapper_tpu.ops import split_complex as sc_ops


@dataclasses.dataclass(frozen=True)
class WidebandConfig:
    num_buoys: int = 64
    wide_rate_hz: float = 10_000_000.0
    num_subchannels: int = 16
    taps_per_channel: int = 8
    sub_block: int = 4096  # per-subchannel samples per step
    max_lag: int = 128  # at the subchannel rate (50 km ⇒ ~104 @ 625 kS/s)
    weighting: str = "phat"
    gcc_eps: float = 0.05
    solver_iterations: int = 15
    psr_floor: float = 1.1
    psr_scale: float = 2.0

    @property
    def num_pairs(self) -> int:
        return self.num_buoys * (self.num_buoys - 1) // 2

    @property
    def wide_block(self) -> int:
        """Wideband samples per buoy per step: the PFB eats T−1 frames of
        filter history, so M·(n_sub + T − 1) input samples yield exactly
        n_sub output frames per subchannel."""
        return self.num_subchannels * (self.sub_block + self.taps_per_channel - 1)

    @property
    def sub_rate_hz(self) -> float:
        return self.wide_rate_hz / self.num_subchannels

    def validate(self) -> "WidebandConfig":
        if self.max_lag >= self.sub_block:
            raise ValueError("max_lag must be < sub_block")
        if self.num_buoys < 2:
            raise ValueError("need at least 2 receivers")
        return self


class WidebandOutput(NamedTuple):
    fixes_enu: jnp.ndarray  # [M, 3] per-subchannel position
    cost: jnp.ndarray  # [M]
    lags: jnp.ndarray  # [M, P] pair lags (subchannel samples)
    weights: jnp.ndarray  # [M, P]
    channel_offset_hz: np.ndarray  # [M] static subchannel centers


class WidebandTDOAPipeline:
    """Config-4 pipeline for a fixed static configuration."""

    def __init__(self, config: WidebandConfig):
        self.config = config.validate()
        i_idx, j_idx = gcc_ops.pair_indices(config.num_buoys)
        self.pair_i = np.asarray(i_idx)
        self.pair_j = np.asarray(j_idx)

    def _pair_stage(self, cre, cim):
        """One subchannel: [B, n_sub] split spectra → [P, 2L+1] |r|."""
        c = self.config
        L = c.max_lag
        nfft = fft_ops.friendly_fft_len(c.sub_block + L)
        fr, fi = fft_ops.fft_re_im(cre, cim, n=nfft)
        return sc_ops.pair_lag_mags(
            fr, fi, self.pair_i, self.pair_j,
            max_lag=L, weighting=c.weighting, eps=c.gcc_eps,
        )

    def _batched_tail(self, mags, anchors_enu):
        """Peak pick + PSR weights + LM solve, BATCHED over the leading
        subchannel axis: ``mags [M, P, 2L+1]`` → (fixes [M, 3], cost [M],
        lags [M, P], weights [M, P]).

        Only the memory-heavy pair stage needs the scan; inside it this
        tail would serialise M rounds of tiny argmax/refine/LM ops. Its
        inputs are ~33 MB at config 4, so it runs once, batched."""
        c = self.config
        pk = gcc_ops.peaks_from_lag_mags(
            mags, sample_rate_hz=c.sub_rate_hz, max_lag=c.max_lag
        )
        weights = jnp.clip(
            (pk.psr - c.psr_floor) / c.psr_scale, 0.0, 1.0
        ) + 1e-3
        dd = solver.tau_to_distance_difference(pk.tau_s)
        anchors_b = jnp.broadcast_to(
            anchors_enu, (*mags.shape[:-2], *anchors_enu.shape)
        )
        res = solver.solve_tdoa_impl(
            anchors_b, self.pair_i, self.pair_j, dd, weights,
            iterations=c.solver_iterations,
        )
        return res.position_enu, res.cost, pk.lag_samples, weights

    def step_split(
        self, re: jnp.ndarray, im: jnp.ndarray, anchors_enu: jnp.ndarray
    ) -> WidebandOutput:
        """Full config-4 step.

        Args:
          re/im: ``[B, wide_block]`` float32 wideband IQ per buoy.
          anchors_enu: ``[B, 3]`` receiver positions.
        """
        c = self.config
        if re.shape != (c.num_buoys, c.wide_block):
            raise ValueError(
                f"expected wideband block {(c.num_buoys, c.wide_block)}, "
                f"got {re.shape}"
            )
        cre, cim = sc_ops.channelize_split(
            re, im, c.num_subchannels,
            sample_rate_hz=c.wide_rate_hz,
            taps_per_channel=c.taps_per_channel,
            shift=False,  # scan order = FFT bin order; offsets map below
        )  # [B, M, n_sub]
        cre = jnp.moveaxis(cre, -2, 0)  # [M, B, n_sub]
        cim = jnp.moveaxis(cim, -2, 0)

        # scan ONLY the memory-heavy pair stage (one subchannel's pair
        # spectra at a time); the tail runs batched over all M at once.
        def body(carry, xs):
            return carry, self._pair_stage(xs[0], xs[1])

        _, mags = jax.lax.scan(body, 0, (cre, cim))  # [M, P, 2L+1]
        fixes, cost, lags, weights = self._batched_tail(mags, anchors_enu)
        return WidebandOutput(
            fixes_enu=fixes,
            cost=cost,
            lags=lags,
            weights=weights,
            channel_offset_hz=np.fft.fftfreq(
                c.num_subchannels, d=1.0 / c.wide_rate_hz
            ),
        )

    def jit_step_split(self):
        return jax.jit(self.step_split)

    def example_inputs(self, *, seed: int = 0) -> Tuple[jnp.ndarray, ...]:
        c = self.config
        rng = np.random.default_rng(seed)
        re = rng.normal(size=(c.num_buoys, c.wide_block)).astype(np.float32)
        im = rng.normal(size=(c.num_buoys, c.wide_block)).astype(np.float32)
        anchors = rng.normal(scale=8_000.0, size=(c.num_buoys, 3)).astype(np.float32)
        anchors[:, 2] = 0.0
        return jnp.asarray(re), jnp.asarray(im), jnp.asarray(anchors)


def build_wideband_sharded_step(mesh, config: WidebandConfig, *, axis: str = "sub"):
    """Config-4 across a mesh: SUBCHANNELS shard over ``axis``.

    The single-chip step scans subchannels sequentially to bound memory;
    on a mesh each device owns M/n subchannels and scans only those — the
    natural "1 host" decomposition (subchannels are embarrassingly
    parallel after the shared channelizer; no collectives in the hot
    loop). The per-buoy PFB channelization runs replicated (its cost is
    ~2% of one subchannel's pair stage), then the [M, B, n_sub] stack
    shards by M into a `shard_map` over the local scan.

    Returns ``(jitted_step, in_shardings)`` with
    ``step(re, im, anchors) -> WidebandOutput`` (outputs sharded by M on
    their leading axis, fixes replicated per shard slice).
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    cfg = config.validate()
    pipe = WidebandTDOAPipeline(cfg)
    n_shards = mesh.shape[axis]
    if cfg.num_subchannels % n_shards:
        raise ValueError(
            f"num_subchannels {cfg.num_subchannels} must divide over "
            f"{n_shards} shards"
        )

    repl = NamedSharding(mesh, P())

    def local_scan(cre_l, cim_l, anchors):
        # cre_l/cim_l: [M/n, B, n_sub] — this shard's subchannels
        def body(carry, xs):
            return carry, pipe._pair_stage(xs[0], xs[1])

        _, mags = jax.lax.scan(body, 0, (cre_l, cim_l))
        return pipe._batched_tail(mags, anchors)

    inner = jax.shard_map(
        local_scan, mesh=mesh,
        in_specs=(P(axis, None, None), P(axis, None, None), P()),
        out_specs=(P(axis), P(axis), P(axis), P(axis)),
    )

    def step(re, im, anchors):
        c = cfg
        cre, cim = sc_ops.channelize_split(
            re, im, c.num_subchannels,
            sample_rate_hz=c.wide_rate_hz,
            taps_per_channel=c.taps_per_channel,
            shift=False,
        )
        # Keep the PFB replicated: without the constraint XLA propagates
        # the subchannel sharding back onto the branch FFT's transform
        # axis, which its FFT partitioner cannot split. (On the CPU
        # backend a constraint by buoy compiled to this same replicated
        # PFB.)
        cre, cim = jax.lax.with_sharding_constraint((cre, cim), repl)
        cre = jnp.moveaxis(cre, -2, 0)
        cim = jnp.moveaxis(cim, -2, 0)
        fixes, cost, lags, weights = inner(cre, cim, anchors)
        return WidebandOutput(
            fixes_enu=fixes, cost=cost, lags=lags, weights=weights,
            channel_offset_hz=np.fft.fftfreq(
                c.num_subchannels, d=1.0 / c.wide_rate_hz
            ),
        )

    return jax.jit(step), (repl, repl, repl)
