"""Buoy node runtime: GPS-synchronized scanning, detection, comms.

Async re-design of the reference's thread soup (`buoy_node.py:683-811`:
monitor thread + queue-drain thread + heartbeat thread + WS thread):
here one asyncio task group runs

  scan loop   — GPS-wall-clock synchronized frequency schedule
                (`buoy_node.py:146-153, 226-242`): tune → capture a block →
                jit-compiled batched detector → enqueue detections;
  send loop   — drains the detection queue over the WebSocket
                (`buoy_node.py:745-764`);
  heartbeat   — BuoyStatus every 30 s (`buoy_node.py:766-792`);
  comms       — auto-reconnect with 5→60 s exponential backoff
                (`buoy_node.py:565-602`).

Detection itself is the JAX detector from :mod:`radio_mapper_tpu.ops`
— the same jitted program the batch pipeline uses, so a buoy's on-node
numbers match the central pipeline bit-for-bit.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import time
from collections import deque
from typing import List, Optional, Tuple

import numpy as np

from radio_mapper_tpu import constants
from radio_mapper_tpu.ingest import IQSource, SimulatedSource
from radio_mapper_tpu.ops import detect as detect_ops
from radio_mapper_tpu.ops import spectral as spectral_ops
from radio_mapper_tpu.ops import split_complex as sc_ops
from radio_mapper_tpu.runtime.datamodel import (
    BuoyStatus,
    NumpyJSONEncoder,
    SignalDetection,
    detection_wire_dict,
    parse_iso,
    utc_now_iso,
)
from radio_mapper_tpu.runtime.gps import GPSTimeSource

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class BuoyNodeConfig:
    buoy_id: str = "buoy-001"
    central_ws_url: str = "ws://localhost:8081"
    lat: float = 35.5513
    lng: float = -97.5322
    sample_rate_hz: float = float(constants.DEFAULT_SAMPLE_RATE_HZ)
    block_len: int = constants.DEFAULT_BLOCK_SAMPLES
    scan_interval_s: float = 2.0  # `buoy_node.py:220`
    heartbeat_interval_s: float = 30.0
    development_mode: bool = False
    max_peaks: int = 8
    power_offset_db: float = 0.0
    detection_threshold_db: float = constants.DEFAULT_DETECTION_THRESHOLD_DBM
    reconnect_min_s: float = 5.0
    reconnect_max_s: float = 60.0
    history_size: int = 1000  # `iq_stream_client.py:179`
    snippet_samples: int = 256  # `iq_stream_client.py:306`
    # Waveform-TDOA snippets: attach this many IQ samples (block-centered)
    # to every detection sent to central, enabling live GCC-PHAT TDOA —
    # the reference stores 256-sample snippets "for pattern matching"
    # (`iq_stream_client.py:306-315`) but never ships or correlates them.
    # Must exceed 2× the largest expected lag (baseline/c·fs).
    attach_iq: bool = True
    iq_snippet_samples: int = 2048
    # Snippet wire encoding: "u8" (base64 uint8 + scale, rtl-native 8-bit,
    # ~15× smaller than the JSON float pairs — `rtl_tcp.c:144-188` moves
    # raw bytes for the same reason), "f16", or "json" (legacy fallback).
    # Compatibility contract: every message carries an explicit
    # ``iq_format`` key, and this framework's central decodes per-message
    # from it (runtime/datamodel.py decode path) — buoy and central may
    # mix wire formats freely. External consumers that predate the key
    # must be pointed at ``iq_wire_format="json"`` (ADVICE r3).
    iq_wire_format: str = "u8"
    gps_update_interval_s: float = 60.0  # `buoy_node.py:657-681`
    # On capture failure, emit simulated detections instead of a dead
    # dwell (reference dev behavior `buoy_node.py:459-467, 471-525`);
    # None = follow development_mode.
    fallback_simulation: Optional[bool] = None


class BuoyNode:
    def __init__(
        self,
        config: BuoyNodeConfig,
        *,
        source: Optional[IQSource] = None,
        gps: Optional[GPSTimeSource] = None,
    ):
        self.config = config
        self.source = source
        self.gps = gps or GPSTimeSource(
            config.lat, config.lng, development_mode=config.development_mode
        )
        self.schedule = constants.DEFAULT_SCAN_SCHEDULE
        self.queue: asyncio.Queue = asyncio.Queue(maxsize=1000)
        self.signals_detected = 0
        self.signal_history: deque = deque(maxlen=config.history_size)
        # (detection, IQ snippet) pairs for waveform pattern matching —
        # the snippets the reference stores but never matches against.
        self.snippet_history: deque = deque(maxlen=config.history_size)
        self.started_at = time.time()
        self.latest_detection_ts: Optional[str] = None
        self.running = False
        self._detect_jit = None
        self._ws = None

    # ---------------------------------------------------------- detection

    def _detector(self):
        if self._detect_jit is None:
            import jax

            cfg = self.config
            # Power calibration: an explicit config value wins; otherwise
            # the SOURCE declares its own scale (counts → 0, unit floats
            # → ~40), so nobody has to hand-thread the constant and a
            # forgotten offset can no longer silently detect nothing.
            offset_db = cfg.power_offset_db or getattr(
                self.source, "power_offset_db", 0.0
            )

            def fn(re, im):
                # Split-complex spectrum: the live buoy detector mirrors
                # the pipeline's step_split path.
                power_db = sc_ops.power_spectrum_db_split(re, im) + offset_db
                peaks = detect_ops.detect_peaks(
                    power_db,
                    sample_rate_hz=cfg.sample_rate_hz,
                    max_peaks=cfg.max_peaks,
                    threshold_db=cfg.detection_threshold_db,
                )
                # −3 dB occupied-bandwidth estimate per peak
                # (`iq_stream_client.py:254-278` capability).
                bw = spectral_ops.estimate_bandwidth_hz(
                    power_db[..., None, :],  # broadcasts against the K peaks
                    peaks.bin_index,
                    cfg.sample_rate_hz,
                    smooth_bins=9,
                )
                return peaks, bw

            self._detect_jit = jax.jit(fn)
        return self._detect_jit

    def extract_snippet(self, iq: np.ndarray, peak_bin: int, n: Optional[int] = None) -> np.ndarray:
        """IQ snippet for pattern matching (`iq_stream_client.py:306-315`).

        The reference indexes the time series with the FFT *frequency* bin —
        a category error that happens to return an arbitrary slice. Here we
        take the block-centered time slice (well-defined, and the snippet
        carries the detected signal since it spans the whole dwell).
        """
        n = self.config.snippet_samples if n is None else n
        start = max(0, (len(iq) - n) // 2)
        return np.asarray(iq[start : start + n])

    def detect_block(
        self,
        iq: np.ndarray,
        center_frequency_hz: float,
        anchor_ns: int = 0,
    ) -> List[SignalDetection]:
        """Run the jitted detector on one block and materialize detections.

        When ``attach_iq`` is set, every detection carries a block-centered
        ``iq_snippet_samples``-long waveform snippet plus its sample rate
        and window anchor — the payload central's waveform GCC-PHAT mode
        correlates across buoys. ``anchor_ns`` is the (buoy-clock) GPS time
        of the capture window start; 0 falls back to the detection stamp.
        """
        iq = np.asarray(iq)
        # Host-side split: the device never sees a complex dtype.
        peaks, bw = self._detector()(
            np.ascontiguousarray(iq.real, dtype=np.float32),
            np.ascontiguousarray(iq.imag, dtype=np.float32),
        )
        self.last_bandwidths_hz = np.asarray(bw)
        valid = np.asarray(peaks.valid)
        freqs = np.asarray(peaks.freq_offset_hz) + center_frequency_hz
        powers = np.asarray(peaks.power_db)
        confs = np.asarray(peaks.confidence)
        iso_ts, gps_ns = self.gps.get_precise_timestamp()
        lat, lng = self.gps.get_position()
        wf_snippet = None
        if self.config.attach_iq:
            wf_snippet = self.extract_snippet(
                iq, 0, n=self.config.iq_snippet_samples
            ).astype(np.complex64)
        out = []
        for k in range(valid.shape[-1]):
            if not valid[k]:
                continue
            f_mhz = float(freqs[k]) / 1e6
            out.append(
                SignalDetection(
                    buoy_id=self.config.buoy_id,
                    frequency_mhz=round(f_mhz, 3),
                    signal_strength_dbm=round(float(powers[k]), 1),
                    timestamp_utc=iso_ts,
                    gps_timestamp_ns=gps_ns,
                    lat=lat,
                    lng=lng,
                    confidence=round(float(confs[k]), 2),
                    signal_type=constants.classify_frequency_mhz(f_mhz),
                    iq_samples=wf_snippet,
                    iq_sample_rate_hz=self.config.sample_rate_hz if wf_snippet is not None else 0.0,
                    iq_anchor_ns=anchor_ns if anchor_ns else gps_ns,
                )
            )
        return out

    def current_dwell(self) -> constants.ScheduleEntry:
        return constants.frequency_at(time.time(), self.schedule)

    async def scan_once(self) -> List[SignalDetection]:
        entry = self.current_dwell()
        center_hz = entry.frequency_mhz * 1e6
        if self.source is None:
            return []
        try:
            self.source.tune(center_hz)
            iq = await asyncio.get_event_loop().run_in_executor(
                None, self.source.read, self.config.block_len
            )
        except Exception as e:
            fallback = self.config.fallback_simulation
            if fallback is None:
                fallback = self.config.development_mode
            if fallback:
                logger.warning("capture failed (%s); simulated fallback", e)
                return self._fallback_detections(entry)
            logger.error("capture failed (%s); skipping dwell", e)
            return []
        # Capture-window anchor: PPS-triggering sources report the true
        # window start; the buoy stamps it through its own (possibly
        # offset) clock, as real hardware would.
        anchor_ns = 0
        getter = getattr(self.source, "window_anchor_ns", None)
        if getter is not None:
            try:
                anchor_ns = int(getter())
            except Exception:
                anchor_ns = 0
            if anchor_ns:
                anchor_ns += getattr(self.gps, "clock_offset_ns", 0)
        detections = await asyncio.get_event_loop().run_in_executor(
            None, self.detect_block, iq, center_hz, anchor_ns
        )
        snippet = self.extract_snippet(iq, 0) if len(detections) else None
        for d in detections:
            self.signal_history.append(d)
            self.snippet_history.append((d, snippet))
            if d.signal_type == "emergency":
                logger.warning("EMERGENCY SIGNAL DETECTED: %.3f MHz", d.frequency_mhz)
        return detections

    def search_signal_history(
        self,
        frequency_mhz: Optional[float] = None,
        frequency_range_mhz: Optional[Tuple[float, float]] = None,
        max_age_minutes: float = 60.0,
    ) -> List[SignalDetection]:
        """Search the local detection ring (`iq_stream_client.py:317-344`):
        ±0.01 MHz point match or range match, age-gated."""
        now = time.time()
        matches = []
        for det in self.signal_history:
            try:
                age_min = (now - parse_iso(det.timestamp_utc).timestamp()) / 60.0
            except (ValueError, TypeError):
                continue
            if age_min > max_age_minutes:
                continue
            if frequency_mhz is not None:
                if abs(det.frequency_mhz - frequency_mhz) >= 0.01:
                    continue
            elif frequency_range_mhz is not None:
                lo, hi = frequency_range_mhz
                if not (lo <= det.frequency_mhz <= hi):
                    continue
            matches.append(det)
        return matches

    def match_signal_pattern(
        self,
        pattern,
        *,
        min_score: float = 0.5,
        frequency_mhz: Optional[float] = None,
        frequency_range_mhz: Optional[Tuple[float, float]] = None,
        max_age_minutes: float = 60.0,
    ):
        """Waveform search: rank history snippets by normalized circular
        cross-correlation against ``pattern`` (complex array).

        Returns ``[(detection, score, lag_samples)]`` sorted best-first,
        filtered to ``score >= min_score``. Metadata gates (frequency/age)
        apply first, mirroring `search_signal_history`.
        """
        import numpy as np

        from radio_mapper_tpu.ops import match as match_ops

        allowed = {
            id(d)
            for d in self.search_signal_history(
                frequency_mhz=frequency_mhz,
                frequency_range_mhz=frequency_range_mhz,
                max_age_minutes=max_age_minutes,
            )
        }
        cands = [
            (d, s)
            for d, s in self.snippet_history
            if id(d) in allowed and s is not None
        ]
        if not cands:
            return []
        n = self.config.snippet_samples
        q = np.zeros(n, np.complex64)
        pat = np.asarray(pattern, np.complex64)[:n]
        q[: pat.size] = pat
        hist = np.stack(
            [np.pad(np.asarray(s, np.complex64)[:n], (0, max(0, n - len(s)))) for _, s in cands]
        )
        scores, lags = match_ops.snippet_match_scores_np(hist, q)
        out = [
            (d, float(scores[k]), int(lags[k]))
            for k, (d, _) in enumerate(cands)
            if scores[k] >= min_score
        ]
        out.sort(key=lambda t: -t[1])
        return out

    def _fallback_detections(self, entry) -> List[SignalDetection]:
        """Simulated detections when the SDR is unavailable (reference
        `buoy_node.py:471-525`: plausible random signals near the current
        dwell frequency, low-ish confidence, so the downstream stack stays
        exercised in dev deployments)."""
        import random

        out = []
        iso_ts, gps_ns = self.gps.get_precise_timestamp()
        lat, lng = self.gps.get_position()
        for _ in range(random.randint(0, 2)):
            f_mhz = entry.frequency_mhz + random.uniform(-0.05, 0.05)
            out.append(
                SignalDetection(
                    buoy_id=self.config.buoy_id,
                    frequency_mhz=round(f_mhz, 3),
                    signal_strength_dbm=round(random.uniform(-75.0, -45.0), 1),
                    timestamp_utc=iso_ts,
                    gps_timestamp_ns=gps_ns,
                    lat=lat,
                    lng=lng,
                    confidence=round(random.uniform(0.3, 0.7), 2),
                    signal_type=constants.classify_frequency_mhz(f_mhz),
                )
            )
        for d in out:
            self.signal_history.append(d)
            self.snippet_history.append((d, None))
        return out

    async def _scan_loop(self):
        while self.running:
            detections = await self.scan_once()
            for d in detections:
                self.signals_detected += 1
                self.latest_detection_ts = d.timestamp_utc
                try:
                    self.queue.put_nowait(d)
                except asyncio.QueueFull:
                    logger.warning("detection queue full; dropping")
            await asyncio.sleep(self.config.scan_interval_s)

    # ------------------------------------------------------------- comms

    async def _register(self, ws):
        lat, lng = self.gps.get_position()
        await ws.send(
            json.dumps(
                {
                    "type": "node_registration",
                    "node_id": self.config.buoy_id,
                    "lat": lat,
                    "lng": lng,
                    "timing_accuracy_ns": self.gps.timing_accuracy_ns,
                    "capabilities": ["detect", "gcc_phat"],
                    "timestamp": utc_now_iso(),
                }
            )
        )

    async def _send_loop(self, ws):
        while self.running:
            det = await self.queue.get()
            await ws.send(
                json.dumps(
                    {
                        "type": "signal_detection",
                        "data": detection_wire_dict(
                            det, self.config.iq_wire_format
                        ),
                    },
                    cls=NumpyJSONEncoder,
                )
            )

    async def _heartbeat_loop(self, ws):
        while self.running:
            lat, lng = self.gps.get_position()
            status = BuoyStatus(
                buoy_id=self.config.buoy_id,
                lat=lat,
                lng=lng,
                gps_locked=self.gps.gps_locked,
                timing_accuracy_ns=self.gps.timing_accuracy_ns,
                sdr_active=self.source is not None,
                last_detection=self.latest_detection_ts,
                uptime_seconds=time.time() - self.started_at,
                signals_detected=self.signals_detected,
            )
            await ws.send(
                json.dumps(
                    {
                        "type": "heartbeat",
                        "node_id": self.config.buoy_id,
                        "status": dataclasses.asdict(status),
                    }
                )
            )
            await asyncio.sleep(self.config.heartbeat_interval_s)

    async def _gps_update_loop(self, ws):
        """Periodic position report (`buoy_node.py:657-681`): keeps the
        central's registry and the TDoA engine's anchors fresh when the
        platform drifts (dev-mode GPS jitters, real buoys float)."""
        while self.running:
            await asyncio.sleep(self.config.gps_update_interval_s)
            lat, lng = self.gps.get_position()
            await ws.send(
                json.dumps(
                    {
                        "type": "gps_update",
                        "node_id": self.config.buoy_id,
                        "lat": lat,
                        "lng": lng,
                        "timing_accuracy_ns": self.gps.timing_accuracy_ns,
                        "gps_locked": self.gps.gps_locked,
                        "timestamp": utc_now_iso(),
                    }
                )
            )

    async def _recv_loop(self, ws):
        async for message in ws:
            try:
                data = json.loads(message)
            except json.JSONDecodeError:
                continue
            mtype = data.get("type")
            if mtype == "signal_search_request":
                req = data.get("data", {})
                filters = dict(
                    frequency_mhz=req.get("frequency_mhz"),
                    frequency_range_mhz=tuple(req["frequency_range_mhz"])
                    if req.get("frequency_range_mhz")
                    else None,
                    max_age_minutes=req.get("max_age_minutes", 60.0),
                )
                if req.get("iq_pattern"):
                    # Waveform search: [re, im] pairs on the wire
                    # (NumpyJSONEncoder's complex format).
                    pattern = [
                        complex(v[0], v[1]) if isinstance(v, (list, tuple)) else complex(v)
                        for v in req["iq_pattern"]
                    ]
                    ranked = self.match_signal_pattern(
                        pattern,
                        min_score=req.get("min_score", 0.5),
                        **filters,
                    )
                    matches = [
                        {**dataclasses.asdict(d), "match_score": s, "match_lag": lag}
                        for d, s, lag in ranked
                    ]
                else:
                    matches = [
                        dataclasses.asdict(m)
                        for m in self.search_signal_history(**filters)
                    ]
                await ws.send(
                    json.dumps(
                        {
                            "type": "signal_search_response",
                            "request_id": req.get("request_id"),
                            "node_id": self.config.buoy_id,
                            "matches": matches,
                        },
                        cls=NumpyJSONEncoder,
                    )
                )
            elif mtype == "triangulation_result":
                d = data.get("data", {})
                logger.info(
                    "Triangulation result: %.3f MHz at (%.6f, %.6f)",
                    d.get("frequency_mhz", 0.0),
                    d.get("estimated_lat", 0.0),
                    d.get("estimated_lng", 0.0),
                )

    async def run(self):
        """Run until cancelled; reconnects with exponential backoff."""
        import websockets

        self.running = True
        self.gps.initialize()
        backoff = self.config.reconnect_min_s
        scan_task = asyncio.create_task(self._scan_loop())
        try:
            while self.running:
                try:
                    async with websockets.connect(self.config.central_ws_url) as ws:
                        self._ws = ws
                        backoff = self.config.reconnect_min_s
                        await self._register(ws)
                        senders = [
                            asyncio.create_task(self._send_loop(ws)),
                            asyncio.create_task(self._heartbeat_loop(ws)),
                            asyncio.create_task(self._gps_update_loop(ws)),
                            asyncio.create_task(self._recv_loop(ws)),
                        ]
                        done, pending = await asyncio.wait(
                            senders, return_when=asyncio.FIRST_EXCEPTION
                        )
                        for t in pending:
                            t.cancel()
                        for t in done:
                            if t.exception():
                                raise t.exception()
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    logger.warning(
                        "central connection lost (%s); retrying in %.0fs", e, backoff
                    )
                    await asyncio.sleep(backoff)
                    backoff = min(backoff * 2, self.config.reconnect_max_s)
        finally:
            self.running = False
            scan_task.cancel()

    def stop(self):
        self.running = False


def simulated_buoy(
    scenario,
    buoy_index: int,
    config: Optional[BuoyNodeConfig] = None,
    *,
    clock_offset_ns: int = 0,
) -> BuoyNode:
    """A BuoyNode wired to a SimulatedSource for hardware-free operation.

    The source is PPS-aligned to the scan interval (all buoys of the
    scenario capture the same absolute windows — the GPS-triggered-capture
    model), and ``clock_offset_ns`` injects this node's clock-reading
    error into every reported timestamp.
    """
    b = scenario.buoys[buoy_index]
    cfg = config or BuoyNodeConfig()
    cfg = dataclasses.replace(
        cfg,
        buoy_id=b.buoy_id,
        lat=b.lat,
        lng=b.lng,
        sample_rate_hz=scenario.sample_rate_hz,
        development_mode=True,
        # power calibration comes from the source's declared scale now
    )
    gps = GPSTimeSource(
        cfg.lat, cfg.lng, development_mode=True, clock_offset_ns=clock_offset_ns
    )
    source = SimulatedSource(scenario, buoy_index, pps_align_s=cfg.scan_interval_s)
    return BuoyNode(cfg, source=source, gps=gps)
