"""TDoA orchestration: detections → measurements → position fixes.

Runtime-facing parity layer for the reference's `TDoAProcessor`
(`tdoa_processor.py:334-465`): frequency grouping with ±0.01 MHz tolerance,
10 s correlation window, ≥3-buoy gate, all-pairs measurements, emergency
tagging — but the solve itself is the batched JAX LM solver working in a
local ENU frame, and *all frequency groups solve in one batched call*
instead of a Python loop with per-group scipy BFGS.

Two measurement modes:
- timestamp mode (reference behavior): Δt from `gps_timestamp_ns`
  (`tdoa_processor.py:166-170`);
- waveform mode (:meth:`TDoAEngine.measurements_from_waveforms`): when
  detections carry IQ snippets, Δt comes from batched GCC-PHAT on the
  waveforms themselves — the capability the reference documents as the
  fix for its accuracy gap (`Documents/TDOA_README.md:66-67`), imports
  scipy for (`tdoa_processor.py:20`) and never built. Snippets from the
  same GPS-PPS-aligned dwell correlate to sub-sample τ regardless of the
  buoys' clock-*reading* error, because the PPS edge (ns-class) aligns
  the capture windows while the 100 µs-class error lives only in the
  reported timestamps; fixes solved this way carry
  ``method="gcc-phat+lm"``. Timestamp differencing remains the fallback
  when fewer than ``min_buoys`` snippets are present.

Reference bugs deliberately NOT reproduced (SURVEY §7): the central
processor calling a nonexistent `triangulate_signal` method, reading a
nonexistent `accuracy_estimate_meters` field, and never registering buoy
positions — this engine is the single, working entry point for both the
offline and real-time paths.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from radio_mapper_tpu import geo, solver
from radio_mapper_tpu.constants import (
    DEFAULT_CORRELATION_WINDOW_S,
    DEFAULT_FREQ_TOLERANCE_MHZ,
    DEFAULT_MIN_BUOYS,
    SPEED_OF_LIGHT_M_S,
)
from radio_mapper_tpu.runtime.datamodel import (
    BuoyPosition,
    SignalDetection,
    TDoAMeasurement,
    TriangulationResult,
    utc_now_iso,
)

logger = logging.getLogger(__name__)


def group_by_frequency(
    detections: Sequence[SignalDetection],
    tolerance_mhz: float = DEFAULT_FREQ_TOLERANCE_MHZ,
) -> Dict[float, List[SignalDetection]]:
    """±tolerance frequency grouping (`tdoa_processor.py:405-425`)."""
    groups: Dict[float, List[SignalDetection]] = {}
    for det in detections:
        for f in groups:
            if abs(det.frequency_mhz - f) <= tolerance_mhz:
                groups[f].append(det)
                break
        else:
            groups[det.frequency_mhz] = [det]
    return groups


def filter_time_window(
    detections: Sequence[SignalDetection], window_s: float
) -> List[SignalDetection]:
    """Keep detections within ``window_s`` of the newest
    (`tdoa_processor.py:427-445`)."""
    if not detections:
        return []
    ordered = sorted(detections, key=lambda d: d.gps_timestamp_ns)
    latest = ordered[-1].gps_timestamp_ns
    earliest = latest - int(window_s * 1e9)
    return [d for d in ordered if d.gps_timestamp_ns >= earliest]


def timing_confidence(b1: BuoyPosition, b2: BuoyPosition) -> float:
    """exp(−σ_combined/100 µs) (`tdoa_processor.py:200-210`)."""
    combined = float(np.hypot(b1.timing_accuracy_ns, b2.timing_accuracy_ns))
    return min(float(np.exp(-combined / 100_000.0)), 1.0)


class TDoAEngine:
    def __init__(
        self,
        *,
        min_buoys: int = DEFAULT_MIN_BUOYS,
        correlation_window_s: float = DEFAULT_CORRELATION_WINDOW_S,
        frequency_tolerance_mhz: float = DEFAULT_FREQ_TOLERANCE_MHZ,
        solver_iterations: int = 40,
        solver_starts: int = 4,
        waveform_mode: str = "auto",  # auto | always | never
        waveform_max_lag: Optional[int] = None,
        # Same-dwell anchor clustering tolerance. Must absorb the clock-
        # reading error (~100 µs class) while staying well below the dwell
        # spacing (≥ the buoys' scan interval), or adjacent dwells chain
        # into one cluster and mismatched windows get correlated.
        waveform_anchor_tolerance_s: float = 0.05,
        gcc_eps: float = 0.05,
        psr_floor: float = 1.2,
        psr_scale: float = 2.0,
    ):
        if waveform_mode not in ("auto", "always", "never"):
            raise ValueError(f"unknown waveform_mode {waveform_mode!r}")
        self.buoy_positions: Dict[str, BuoyPosition] = {}
        self.min_buoys = min_buoys
        self.correlation_window_s = correlation_window_s
        self.frequency_tolerance_mhz = frequency_tolerance_mhz
        self.solver_iterations = solver_iterations
        self.solver_starts = solver_starts
        self.waveform_mode = waveform_mode
        self.waveform_max_lag = waveform_max_lag
        self.waveform_anchor_tolerance_s = waveform_anchor_tolerance_s
        self.gcc_eps = gcc_eps
        self.psr_floor = psr_floor
        self.psr_scale = psr_scale
        # jitted GCC-PHAT programs keyed by static (B, N, max_lag) shape.
        self._gcc_cache: Dict[Tuple[int, int, int], object] = {}

    # -- registry ---------------------------------------------------------

    def register_buoy(self, pos: BuoyPosition) -> None:
        self.buoy_positions[pos.buoy_id] = pos
        logger.info(
            "Registered buoy %s at (%.6f, %.6f)", pos.buoy_id, pos.lat, pos.lng
        )

    def get_network_status(self) -> Dict:
        """Diagnostics payload (`tdoa_processor.py:447-465`)."""
        return {
            "registered_buoys": len(self.buoy_positions),
            "buoy_list": [
                {
                    "buoy_id": p.buoy_id,
                    "lat": p.lat,
                    "lng": p.lng,
                    "timing_accuracy_ns": p.timing_accuracy_ns,
                }
                for p in self.buoy_positions.values()
            ],
            "min_buoys_required": self.min_buoys,
            "correlation_window_s": self.correlation_window_s,
            "triangulation_ready": len(self.buoy_positions) >= self.min_buoys,
        }

    # -- measurements -----------------------------------------------------

    def measurements_from_timestamps(
        self, detections: Sequence[SignalDetection]
    ) -> List[TDoAMeasurement]:
        """All-pairs Δt from detection timestamps
        (`tdoa_processor.py:146-198`)."""
        out: List[TDoAMeasurement] = []
        for i in range(len(detections)):
            for j in range(i + 1, len(detections)):
                d1, d2 = detections[i], detections[j]
                if abs(d1.frequency_mhz - d2.frequency_mhz) > self.frequency_tolerance_mhz:
                    continue
                p1 = self.buoy_positions.get(d1.buoy_id)
                p2 = self.buoy_positions.get(d2.buoy_id)
                if p1 is None or p2 is None:
                    continue
                dt_ns = d2.gps_timestamp_ns - d1.gps_timestamp_ns
                out.append(
                    TDoAMeasurement(
                        buoy1_id=d1.buoy_id,
                        buoy2_id=d2.buoy_id,
                        time_difference_ns=dt_ns,
                        distance_difference_m=dt_ns / 1e9 * SPEED_OF_LIGHT_M_S,
                        confidence=min(d1.confidence, d2.confidence)
                        * timing_confidence(p1, p2),
                        frequency_mhz=d1.frequency_mhz,
                    )
                )
        return out

    # -- waveform (GCC-PHAT) measurements ---------------------------------

    def _gcc_all_pairs(self, num_buoys: int, n: int, max_lag: int):
        """Cached jitted all-pairs GCC-PHAT for a static shape signature."""
        key = (num_buoys, n, max_lag)
        fn = self._gcc_cache.get(key)
        if fn is None:
            import functools

            import jax

            from radio_mapper_tpu.ops import gcc_phat as gcc_ops

            # sample_rate is applied host-side (from lag_samples), so the
            # compiled program is reusable across capture rates.
            fn = jax.jit(
                functools.partial(
                    gcc_ops.gcc_phat_all_pairs,
                    sample_rate_hz=1.0,
                    max_lag=max_lag,
                    weighting="phat",
                    eps=self.gcc_eps,
                )
            )
            self._gcc_cache[key] = fn
        return fn

    def _waveform_max_lag(self, buoy_ids: Sequence[str], n: int, fs: float) -> int:
        """Lag window covering the largest baseline among ``buoy_ids``.

        GCC lag must span the true propagation-delay difference; with
        PPS-aligned windows no clock-error margin is needed. Quantized up
        to a multiple of 64 to bound jit-cache growth across geometries.
        """
        if self.waveform_max_lag is not None:
            return min(self.waveform_max_lag, n - 1)
        positions = [self.buoy_positions[b] for b in buoy_ids]
        lat0 = float(np.mean([p.lat for p in positions]))
        lng0 = float(np.mean([p.lng for p in positions]))
        enu = np.stack(
            [
                geo.lat_lng_to_enu_np(p.lat, p.lng, p.altitude, lat0, lng0, 0.0)
                for p in positions
            ]
        )
        baseline = 0.0
        for i in range(len(enu)):
            for j in range(i + 1, len(enu)):
                baseline = max(baseline, float(np.linalg.norm(enu[i] - enu[j])))
        lag = int(np.ceil(baseline / SPEED_OF_LIGHT_M_S * fs)) + 16
        lag = ((lag + 63) // 64) * 64
        return max(64, min(lag, n - 1))

    def measurements_from_waveforms(
        self, detections: Sequence[SignalDetection]
    ) -> List[TDoAMeasurement]:
        """All-pairs sub-sample Δt from the detections' IQ snippets.

        One batched GCC-PHAT program measures every pair at once (the
        reference's pair loop is `tdoa_processor.py:156-193`; here the pair
        axis is a batch axis). Requirements per detection: an ``iq_samples``
        snippet with a common ``iq_sample_rate_hz``, captured in the same
        PPS-aligned dwell (``iq_anchor_ns`` within
        ``waveform_anchor_tolerance_s`` of the group median). Returns []
        when fewer than ``min_buoys`` qualify — callers fall back to
        timestamp differencing.
        """
        cands = [
            d
            for d in detections
            if d.iq_samples is not None
            and len(d.iq_samples)
            and d.buoy_id in self.buoy_positions
        ]
        if len({d.buoy_id for d in cands}) < self.min_buoys:
            return []

        rates = {round(float(d.iq_sample_rate_hz), 3) for d in cands}
        rates.discard(0.0)
        if len(rates) != 1:
            if len(rates) > 1:
                logger.warning("mixed snippet sample rates %s; waveform mode off", rates)
            return []
        fs = rates.pop()
        # Remember the dwell's sample rate so the solve can floor its
        # error-ellipse σ at the GCC τ resolution (~0.2 sample).
        self._last_waveform_fs = fs

        # Same-dwell clustering: snippets only correlate if they come from
        # the SAME capture window. Greedily cluster by anchor (tolerance
        # absorbs clock-reading error; different dwells are seconds apart),
        # then use the cluster covering the most buoys, newest on ties.
        tol_ns = self.waveform_anchor_tolerance_s * 1e9
        clusters: List[List[SignalDetection]] = []
        for d in sorted(cands, key=lambda d: d.iq_anchor_ns):
            if clusters and d.iq_anchor_ns - clusters[-1][0].iq_anchor_ns <= tol_ns:
                clusters[-1].append(d)
            else:
                clusters.append([d])
        cluster = max(
            clusters,
            key=lambda c: (len({d.buoy_id for d in c}), c[0].iq_anchor_ns),
        )
        keep: Dict[str, SignalDetection] = {}
        for d in cluster:
            cur = keep.get(d.buoy_id)
            if cur is None or d.confidence > cur.confidence:
                keep[d.buoy_id] = d
        if len(keep) < self.min_buoys:
            return []

        buoy_ids = sorted(keep)
        n = min(len(keep[b].iq_samples) for b in buoy_ids)
        sig = np.stack(
            [np.asarray(keep[b].iq_samples, np.complex64)[:n] for b in buoy_ids]
        )
        max_lag = self._waveform_max_lag(buoy_ids, n, fs)
        # The service plane correlates small snippet groups host-side; the
        # device runs the bulk pipeline (models.pipeline). Pinning to CPU
        # also keeps the central service independent of device health.
        import jax

        with jax.default_device(jax.devices("cpu")[0]):
            peaks = self._gcc_all_pairs(len(buoy_ids), n, max_lag)(sig)
        lags = np.asarray(peaks.lag_samples, np.float64)
        psr = np.asarray(peaks.psr, np.float64)

        from radio_mapper_tpu.ops.gcc_phat import pair_indices

        i_idx, j_idx = pair_indices(len(buoy_ids))
        out: List[TDoAMeasurement] = []
        freq = float(np.median([keep[b].frequency_mhz for b in buoy_ids]))
        for p in range(len(i_idx)):
            bi, bj = buoy_ids[int(i_idx[p])], buoy_ids[int(j_idx[p])]
            tau_s = float(lags[p]) / fs  # lag>0 ⇒ bi heard later (gcc_phat sign)
            # PSR grades the correlation peak; detection confidences gate
            # the pair as in `tdoa_processor.py:179-198`.
            quality = 0.1 + 0.9 * float(
                np.clip((psr[p] - self.psr_floor) / self.psr_scale, 0.0, 1.0)
            )
            conf = min(keep[bi].confidence, keep[bj].confidence) * quality
            out.append(
                TDoAMeasurement(
                    buoy1_id=bj,
                    buoy2_id=bi,  # time_difference = t(buoy2) − t(buoy1) = τ
                    time_difference_ns=int(round(tau_s * 1e9)),
                    distance_difference_m=tau_s * SPEED_OF_LIGHT_M_S,
                    confidence=conf,
                    frequency_mhz=freq,
                )
            )
        return out

    # -- solving ----------------------------------------------------------

    def _solve_group(
        self, measurements: List[TDoAMeasurement], sigma_floor_m: float = 0.0
    ) -> Optional[Tuple[float, float, float, float, float, Tuple[float, float, float]]]:
        """LM solve of one measurement group in a local ENU frame.

        Returns (lat, lng, alt, accuracy_m, mean_confidence,
        (ellipse_major_m, ellipse_minor_m, ellipse_orientation_deg)) or
        None. The ellipse is the solver's 1σ CRLB ellipse — the honest
        geometric uncertainty the reference's residual-RMS scalar hides
        (`tdoa_processor.py:299`).
        """
        buoy_ids = sorted(
            {m.buoy1_id for m in measurements} | {m.buoy2_id for m in measurements}
        )
        if len(buoy_ids) < self.min_buoys:
            return None
        index = {b: k for k, b in enumerate(buoy_ids)}
        positions = [self.buoy_positions[b] for b in buoy_ids]
        lat0 = float(np.mean([p.lat for p in positions]))
        lng0 = float(np.mean([p.lng for p in positions]))
        anchors = np.stack(
            [
                geo.lat_lng_to_enu_np(p.lat, p.lng, p.altitude, lat0, lng0, 0.0)
                for p in positions
            ]
        ).astype(np.float32)

        pair_i = np.array([index[m.buoy2_id] for m in measurements], np.int32)
        pair_j = np.array([index[m.buoy1_id] for m in measurements], np.int32)
        # sign: time_difference_ns = t(buoy2) − t(buoy1) ⇒ receiver "i"=buoy2
        # heard later, matching solve_tdoa's dd = ‖x−p_i‖ − ‖x−p_j‖.
        dd = np.array([m.distance_difference_m for m in measurements], np.float32)
        w = np.array([max(m.confidence, 0.0) for m in measurements], np.float32)
        if not np.any(w > 0):
            w = np.ones_like(w)

        res = solver.solve_tdoa_multistart(
            anchors,
            pair_i,
            pair_j,
            dd,
            w,
            num_starts=self.solver_starts,
            iterations=self.solver_iterations,
            sigma_floor_m=np.float32(sigma_floor_m),
        )
        enu = np.asarray(res.position_enu, np.float64)
        if not np.all(np.isfinite(enu)):
            return None
        lat, lng, alt = geo.enu_to_lat_lng(enu, lat0, lng0, 0.0)
        accuracy = float(np.asarray(res.residual_rms_m))
        mean_conf = float(np.mean([m.confidence for m in measurements]))
        ellipse = (
            float(np.asarray(res.ellipse_major_m)),
            float(np.asarray(res.ellipse_minor_m)),
            float(np.asarray(res.ellipse_orientation_deg)),
        )
        return float(lat), float(lng), float(alt), accuracy, mean_conf, ellipse

    def process_signal_detections(
        self, detections: Sequence[SignalDetection]
    ) -> List[TriangulationResult]:
        """Group → window → measure → batch-solve
        (`tdoa_processor.py:351-403`)."""
        results: List[TriangulationResult] = []
        if not detections:
            return results
        for freq, group in group_by_frequency(
            detections, self.frequency_tolerance_mhz
        ).items():
            windowed = filter_time_window(group, self.correlation_window_s)
            if len({d.buoy_id for d in windowed}) < self.min_buoys:
                continue
            method = "hyperbolic-lm"
            measurements: List[TDoAMeasurement] = []
            if self.waveform_mode != "never":
                measurements = self.measurements_from_waveforms(windowed)
                if measurements:
                    method = "gcc-phat+lm"
            if not measurements and self.waveform_mode != "always":
                measurements = self.measurements_from_timestamps(windowed)
            if len(measurements) < 2:
                continue
            # The ellipse σ needs a floor: a 3-receiver group fits all-pairs
            # dd exactly, so the residual estimate alone can report zero
            # uncertainty (solver.py docstring). Waveform τ is good to
            # ~0.2 sample; timestamp differencing is only as good as the
            # clocks — floor at c·median(timing accuracy) of the
            # contributing buoys, so a 100 µs-sync network honestly reports
            # its tens-of-km ellipse instead of a deceptively tiny one.
            floor = 0.0
            if method == "gcc-phat+lm" and getattr(self, "_last_waveform_fs", 0.0):
                floor = 0.2 * SPEED_OF_LIGHT_M_S / self._last_waveform_fs
            elif method == "hyperbolic-lm":
                accs = [
                    self.buoy_positions[b].timing_accuracy_ns
                    for m in measurements
                    for b in (m.buoy1_id, m.buoy2_id)
                    if b in self.buoy_positions
                ]
                if accs:
                    floor = SPEED_OF_LIGHT_M_S * float(np.median(accs)) * 1e-9
            solved = self._solve_group(measurements, sigma_floor_m=floor)
            if solved is None:
                continue
            lat, lng, alt, accuracy, conf, ellipse = solved
            types = [d.signal_type for d in windowed]
            common_type = max(set(types), key=types.count)
            result = TriangulationResult(
                estimated_lat=lat,
                estimated_lng=lng,
                estimated_altitude=alt,
                accuracy_meters=accuracy,
                confidence=conf,
                frequency_mhz=freq,
                signal_type=common_type,
                timestamp_utc=utc_now_iso(),
                contributing_buoys=sorted({d.buoy_id for d in windowed}),
                tdoa_measurements=measurements,
                method=method,
                ellipse_major_m=ellipse[0],
                ellipse_minor_m=ellipse[1],
                ellipse_orientation_deg=ellipse[2],
            )
            results.append(result)
            if common_type == "emergency":
                logger.warning(
                    "EMERGENCY SIGNAL TRIANGULATED: %.3f MHz at (%.6f, %.6f) ±%.1fm",
                    freq, lat, lng, accuracy,
                )
        return results
