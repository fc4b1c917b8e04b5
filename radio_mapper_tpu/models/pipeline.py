"""The flagship end-to-end TDOA pipeline: decode → detect → correlate → solve.

One jit-compiled program replaces the reference's entire multi-process hot
path (buoy FFT detection `buoy_node.py:357-469`, central correlation
`central_processor.py:363-397`, TDoA measurement + BFGS solve
`tdoa_processor.py:146-328`):

    uint8 IQ [..., B, 2N]                       (host ingest / HBM)
      → complex64 decode                         (ops.iq)
      → per-buoy PSD + top-K peak detection      (ops.detect)
      → all-pairs gated GCC-PHAT + sub-sample τ  (ops.gcc_phat)
      → confidence-weighted LM hyperbolic solve  (solver)
      → ENU fix + quality metrics

All leading dims are batch dims: ``[channels, B, N]`` runs every monitored
channel simultaneously (replacing the reference's 35 s serial scan), and the
same jitted function vmaps/shards over channels, time windows and hosts (see
:mod:`radio_mapper_tpu.parallel`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from radio_mapper_tpu import constants, solver
from radio_mapper_tpu.ops import detect as detect_ops
from radio_mapper_tpu.ops import gcc_phat as gcc_ops
from radio_mapper_tpu.ops import iq as iq_ops
from radio_mapper_tpu.ops import split_complex as sc_ops


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static (compile-time) pipeline configuration."""

    num_buoys: int = 4
    block_len: int = 16_384
    sample_rate_hz: float = constants.DEFAULT_SAMPLE_RATE_HZ
    max_lag: int = 512  # ≥ max baseline / c · fs (50 km ⇒ ~342 @ 2.048 MS/s)
    max_peaks: int = 8
    weighting: str = "phat"
    gcc_eps: float = 0.05
    detection_threshold_db: float = constants.DEFAULT_DETECTION_THRESHOLD_DBM
    power_offset_db: float = 0.0
    solve_2d: bool = True
    solver_iterations: int = 40
    solver_starts: int = 1  # >1 enables multi-start
    # Median noise floor from every S-th bin: statistically identical for
    # noise (≳2k bins remain at flagship sizes, ≲0.1 dB shift) and cuts
    # the bisection's HBM traffic S× — the detect stage is memory-bound.
    noise_floor_stride: int = 8
    # Pair weight = min(conf_i, conf_j) · clip((psr − psr_floor)/psr_scale)
    psr_floor: float = 1.2
    psr_scale: float = 2.0
    # Narrowband mode: correlate K consecutive dwells as ONE coherent
    # capture of K·block_len samples (inputs become [..., B, K·N]) while
    # detection uses the dwell-averaged PSD on the block_len grid. τ noise
    # shrinks ~√(K·N) with integration time — the only physics that
    # rescues 5 kHz-class ELT beacons, whose per-dwell CRLB is km-scale
    # (CRLB ∝ 1/BW; `Documents/TDOA_README.md:107-110` targets <500 m).
    # τ-domain per-dwell fusion was measured and rejected: a swept tone is
    # quasi-monochromatic within one dwell, so per-dwell lags are *biased*
    # (ambiguous), and averaging biased lags never converges (see
    # tests/test_validation_scenarios.py ELT case).
    correlation_dwells: int = 1

    def validate(self) -> "PipelineConfig":
        if self.max_lag >= self.block_len:
            raise ValueError("max_lag must be smaller than block_len")
        if self.num_buoys < 2:
            raise ValueError("need at least 2 receivers")
        if self.correlation_dwells < 1:
            raise ValueError("correlation_dwells must be >= 1")
        return self

    @property
    def num_pairs(self) -> int:
        return self.num_buoys * (self.num_buoys - 1) // 2


class PipelineOutput(NamedTuple):
    peaks: detect_ops.PeakSet  # per-buoy detections [..., B, K]
    correlation: gcc_ops.CorrelationPeak  # per-pair TDOA [..., P]
    pair_weights: jnp.ndarray  # [..., P]
    fix: solver.SolveResult  # [...]-batched position solution
    buoy_confidence: jnp.ndarray  # [..., B] strongest-peak confidence


class TDOAPipeline:
    """Builds jit-compiled step functions for a fixed static configuration."""

    def __init__(self, config: PipelineConfig):
        self.config = config.validate()
        i_idx, j_idx = gcc_ops.pair_indices(config.num_buoys)
        self.pair_i = jnp.asarray(i_idx)
        self.pair_j = jnp.asarray(j_idx)

    # -- stages ---------------------------------------------------------

    def detect(self, iq: jnp.ndarray) -> detect_ops.PeakSet:
        c = self.config
        return detect_ops.detect_signals(
            iq,
            sample_rate_hz=c.sample_rate_hz,
            max_peaks=c.max_peaks,
            power_offset_db=c.power_offset_db,
            threshold_db=c.detection_threshold_db,
            noise_floor_stride=c.noise_floor_stride,
        )

    def correlate(self, iq: jnp.ndarray) -> gcc_ops.CorrelationPeak:
        c = self.config
        return gcc_ops.gcc_phat_all_pairs(
            iq,
            sample_rate_hz=c.sample_rate_hz,
            max_lag=c.max_lag,
            weighting=c.weighting,
            eps=c.gcc_eps,
        )

    def pair_weights(
        self, peaks: detect_ops.PeakSet, corr: gcc_ops.CorrelationPeak
    ) -> jnp.ndarray:
        """Confidence-based pair weighting (generalizes `tdoa_processor.py:179-198`)."""
        c = self.config
        buoy_conf = jnp.max(
            jnp.where(peaks.valid, peaks.confidence, 0.0), axis=-1
        )  # [..., B]
        conf_i = jnp.take(buoy_conf, self.pair_i, axis=-1)
        conf_j = jnp.take(buoy_conf, self.pair_j, axis=-1)
        # PSR grades correlation quality, but a narrowband signal's wide
        # correlation envelope keeps PSR near 1 even for a clean peak —
        # so PSR modulates between 0.1 and 1 instead of hard-zeroing: any
        # pair whose *detections* fired still contributes.
        psr_q = 0.1 + 0.9 * jnp.clip((corr.psr - c.psr_floor) / c.psr_scale, 0.0, 1.0)
        return jnp.minimum(conf_i, conf_j) * psr_q

    def solve(
        self,
        anchors_enu: jnp.ndarray,
        corr: gcc_ops.CorrelationPeak,
        weights: jnp.ndarray,
    ) -> solver.SolveResult:
        c = self.config
        dd = solver.tau_to_distance_difference(corr.tau_s)
        fn = (
            functools.partial(solver.solve_tdoa_multistart, num_starts=c.solver_starts)
            if c.solver_starts > 1
            else solver.solve_tdoa
        )
        return fn(
            anchors_enu,
            self.pair_i,
            self.pair_j,
            dd,
            weights,
            solve_2d=c.solve_2d,
            iterations=c.solver_iterations,
        )

    def _finish(self, peaks, corr_fields, anchors_enu) -> PipelineOutput:
        """Shared tail of every routing: weights → solve → output."""
        corr = gcc_ops.CorrelationPeak(
            lag_samples=corr_fields.lag_samples,
            tau_s=corr_fields.tau_s,
            peak_value=corr_fields.peak_value,
            psr=corr_fields.psr,
        )
        weights = self.pair_weights(peaks, corr)
        fix = self.solve(anchors_enu, corr, weights)
        buoy_conf = jnp.max(
            jnp.where(peaks.valid, peaks.confidence, 0.0), axis=-1
        )
        return PipelineOutput(
            peaks=peaks,
            correlation=corr,
            pair_weights=weights,
            fix=fix,
            buoy_confidence=buoy_conf,
        )

    # -- full steps -----------------------------------------------------

    def step(self, iq: jnp.ndarray, anchors_enu: jnp.ndarray) -> PipelineOutput:
        """Full pipeline on complex IQ ``[..., B, N]`` (``[..., B, K·N]``
        when ``correlation_dwells=K``), anchors ``[..., B, 3]``."""
        c = self.config
        if c.correlation_dwells > 1:
            from radio_mapper_tpu.ops.spectral import power_spectrum_db

            k, n = c.correlation_dwells, c.block_len
            if iq.shape[-1] != k * n:
                raise ValueError(
                    f"correlation_dwells={k} expects capture length {k * n}, "
                    f"got {iq.shape[-1]}"
                )
            dwells = iq.reshape(*iq.shape[:-1], k, n)  # [..., B, K, N]
            # detection: dwell-averaged PSD (√K noise-floor variance cut)
            # on the per-dwell bin grid
            power_db = (
                10.0
                * jnp.log10(
                    jnp.mean(
                        10.0 ** (power_spectrum_db(dwells) / 10.0), axis=-2
                    )
                    + 1e-30
                )
                + c.power_offset_db
            )
            peaks = detect_ops.detect_peaks(
                power_db,
                sample_rate_hz=c.sample_rate_hz,
                max_peaks=c.max_peaks,
                threshold_db=c.detection_threshold_db,
                noise_floor_stride=c.noise_floor_stride,
            )
        else:
            peaks = self.detect(iq)
        corr = self.correlate(iq)  # full-capture coherent correlation
        weights = self.pair_weights(peaks, corr)
        fix = self.solve(anchors_enu, corr, weights)
        buoy_conf = jnp.max(jnp.where(peaks.valid, peaks.confidence, 0.0), axis=-1)
        return PipelineOutput(
            peaks=peaks,
            correlation=corr,
            pair_weights=weights,
            fix=fix,
            buoy_confidence=buoy_conf,
        )

    def step_uint8(self, raw: jnp.ndarray, anchors_enu: jnp.ndarray) -> PipelineOutput:
        """Pipeline from raw interleaved uint8 bytes ``[..., B, 2N]``."""
        return self.step(iq_ops.decode_uint8_iq(raw), anchors_enu)

    # -- split-complex (complex-dtype-free) path -------------------------

    def step_split(
        self, re: jnp.ndarray, im: jnp.ndarray, anchors_enu: jnp.ndarray
    ) -> PipelineOutput:
        """Full pipeline on (re, im) float32 planes ``[..., B, N]``.

        Identical math to :meth:`step`; this is the form the uint8 ingest
        feeds (:meth:`step_split_uint8`, see
        :mod:`radio_mapper_tpu.ops.split_complex`).
        """
        c = self.config
        n = re.shape[-1]
        if c.correlation_dwells > 1:
            return self._step_split_multidwell(re, im, anchors_enu)
        spectra = sc_ops.receiver_spectra_split(re, im, max_lag=c.max_lag)
        if spectra[2] == 2 * n:
            # Zero-padding to exactly 2N makes the padded transform's
            # even bins equal the plain N-point FFT bit-for-bit — the
            # detector's spectrum is a strided view of the correlation
            # FFTs, free.
            fr, fi, _ = spectra
            power_db = (
                10.0 * jnp.log10(fr[..., ::2] ** 2 + fi[..., ::2] ** 2 + 1e-24)
                + c.power_offset_db
            )
        else:
            power_db = sc_ops.power_spectrum_db_split(re, im) + c.power_offset_db
        peaks = detect_ops.detect_peaks(
            power_db,
            sample_rate_hz=c.sample_rate_hz,
            max_peaks=c.max_peaks,
            threshold_db=c.detection_threshold_db,
            noise_floor_stride=c.noise_floor_stride,
        )
        corr_sc = sc_ops.gcc_phat_all_pairs_split(
            re, im,
            sample_rate_hz=c.sample_rate_hz,
            max_lag=c.max_lag,
            weighting=c.weighting,
            eps=c.gcc_eps,
            spectra=spectra,
        )
        return self._finish(peaks, corr_sc, anchors_enu)

    def _step_split_multidwell(
        self, re: jnp.ndarray, im: jnp.ndarray, anchors_enu: jnp.ndarray
    ) -> PipelineOutput:
        """Narrowband split-complex path: dwell-averaged PSD detection +
        one coherent full-capture correlation (see ``correlation_dwells``)."""
        c = self.config
        k, n = c.correlation_dwells, c.block_len
        if re.shape[-1] != k * n:
            raise ValueError(
                f"correlation_dwells={k} expects capture length {k * n}, "
                f"got {re.shape[-1]}"
            )
        red = re.reshape(*re.shape[:-1], k, n)
        imd = im.reshape(*im.shape[:-1], k, n)
        power_db = (
            10.0
            * jnp.log10(
                jnp.mean(
                    10.0 ** (sc_ops.power_spectrum_db_split(red, imd) / 10.0),
                    axis=-2,
                )
                + 1e-30
            )
            + c.power_offset_db
        )
        peaks = detect_ops.detect_peaks(
            power_db,
            sample_rate_hz=c.sample_rate_hz,
            max_peaks=c.max_peaks,
            threshold_db=c.detection_threshold_db,
            noise_floor_stride=c.noise_floor_stride,
        )
        corr_sc = sc_ops.gcc_phat_all_pairs_split(
            re, im,
            sample_rate_hz=c.sample_rate_hz,
            max_lag=c.max_lag,
            weighting=c.weighting,
            eps=c.gcc_eps,
        )
        return self._finish(peaks, corr_sc, anchors_enu)

    def step_split_uint8(
        self, raw: jnp.ndarray, anchors_enu: jnp.ndarray
    ) -> PipelineOutput:
        re, im = sc_ops.decode_uint8_split(raw)
        return self.step_split(re, im, anchors_enu)

    # -- multi-block scan steps ------------------------------------------

    def step_split_uint8_scan(
        self, raw: jnp.ndarray, anchors_enu: jnp.ndarray
    ) -> PipelineOutput:
        """K consecutive blocks in ONE dispatch: ``raw [K, ..., B, 2N]``.

        `lax.scan` folds the per-dispatch cost across K blocks while
        compiling the block body ONCE — unlike a
        leading batch axis, the program size and peak HBM working set
        stay those of a single block, so K scales without recompiling a
        bigger graph or pressuring memory. Outputs stack on a leading K
        axis (block k's results at index k, oldest first).
        """
        def body(carry, blk):
            return carry, self.step_split_uint8(blk, anchors_enu)

        _, outs = jax.lax.scan(body, 0, raw)
        return outs

    def step_split_scan(
        self, re: jnp.ndarray, im: jnp.ndarray, anchors_enu: jnp.ndarray
    ) -> PipelineOutput:
        """Scan variant of :meth:`step_split`: ``re/im [K, ..., B, N]``."""
        def body(carry, blk):
            return carry, self.step_split(blk[0], blk[1], anchors_enu)

        _, outs = jax.lax.scan(body, 0, (re, im))
        return outs

    def jit_step_split_uint8_scan(self):
        return jax.jit(self.step_split_uint8_scan)

    def jit_step_split_scan(self):
        return jax.jit(self.step_split_scan)

    def jit_step_split(self):
        return jax.jit(self.step_split)

    def jit_step_split_uint8(self):
        return jax.jit(self.step_split_uint8)

    def jit_step(self):
        return jax.jit(self.step)

    def jit_step_uint8(self):
        return jax.jit(self.step_uint8)

    # -- example inputs (for AOT compile checks and benches) -------------

    def example_inputs(
        self, *, batch: tuple = (), seed: int = 0, uint8: bool = False,
        split: bool = False,
    ):
        """Random inputs: ``(iq, anchors)`` complex64 by default,
        ``(raw, anchors)`` with ``uint8=True``, ``(re, im, anchors)``
        float32 planes for :meth:`step_split` with ``split=True``.
        """
        c = self.config
        rng = np.random.default_rng(seed)
        anchors = rng.normal(scale=8_000.0, size=(c.num_buoys, 3)).astype(np.float32)
        anchors[:, 2] = 0.0
        anchors = np.ascontiguousarray(
            np.broadcast_to(anchors, (*batch, c.num_buoys, 3))
        )
        if uint8:
            raw = rng.integers(
                0, 256, size=(*batch, c.num_buoys, 2 * c.block_len), dtype=np.uint8
            )
            return jnp.asarray(raw), jnp.asarray(anchors)
        re = rng.normal(size=(*batch, c.num_buoys, c.block_len)).astype(np.float32)
        im = rng.normal(size=(*batch, c.num_buoys, c.block_len)).astype(np.float32)
        if split:
            return jnp.asarray(re), jnp.asarray(im), jnp.asarray(anchors)
        return jnp.asarray((re + 1j * im).astype(np.complex64)), jnp.asarray(anchors)
