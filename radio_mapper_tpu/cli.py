"""Command-line runner.

Parity with the reference's `run.py` commands (`run.py:363-432`:
server | client | web | setup | test) plus additions:

  server    — central processor (WS ingest + HTTP API + triangulation)
  buoy      — a buoy node (simulated / file / rtl_sdr / rtl_tcp source)
  web       — dashboard (Leaflet map + API proxy)
  simulate  — synthesize a scenario, run the pipeline, print the fix
  analyze   — offline .bin capture analysis (spectrum PNG + stats)
  capture   — one-shot IQ capture to .bin (`sdr_capture.py` parity)
  bench     — full-pipeline throughput benchmark
  test      — environment self-test (`run.py:246-320` parity)
  setup     — autodetect hardware + generate example config
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import logging
import sys


def _setup_logging(verbose: bool):
    logging.basicConfig(
        level=logging.DEBUG if verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )


# Host utility commands run on CPU unless --backend overrides: their
# workloads are a few small blocks, and a process on the card would
# reserve most of its memory for them. The served path (`server`) stays
# on the host too until its latency is measured on the card. Pipeline and
# bench commands keep JAX's default backend (the GPU where there is one).
_CPU_DEFAULT_COMMANDS = {
    "demod", "adsb", "scan", "analyze", "capture", "sdrtest",
    "eeprom", "test", "setup", "web", "server",
}


def _apply_backend(args):
    choice = getattr(args, "backend", None) or (
        "cpu" if args.command in _CPU_DEFAULT_COMMANDS else "auto"
    )
    import jax

    if choice == "cpu":
        jax.config.update("jax_platforms", "cpu")
        return
    if choice == "gpu":
        from radio_mapper_tpu.utils.device import require_gpu

        try:
            require_gpu()
        except RuntimeError as e:
            raise SystemExit(f"--backend gpu: {e}")
    # "auto" leaves JAX's platform selection untouched
    from radio_mapper_tpu.utils.device import enable_compile_cache

    enable_compile_cache()


def cmd_server(args):
    from radio_mapper_tpu.runtime.central import CentralProcessor

    central = CentralProcessor(
        host=args.host, ws_port=args.ws_port, http_port=args.http_port,
        min_nodes=args.min_nodes, waveform_mode=args.waveform_mode,
    )
    asyncio.run(central.run_forever())


def cmd_buoy(args):
    from radio_mapper_tpu import sim
    from radio_mapper_tpu.runtime.buoy import BuoyNode, BuoyNodeConfig, simulated_buoy

    # the detector's bin->Hz mapping and the iq_sample_rate_hz reported
    # to central must match the SOURCE's rate, not the config default
    # (sim sources set it from the scenario below)
    cfg = BuoyNodeConfig(
        buoy_id=args.id,
        central_ws_url=args.central,
        development_mode=args.dev,
        iq_wire_format=args.iq_wire_format,
        iq_snippet_samples=args.snippet_samples,
        sample_rate_hz=args.sample_rate,
    )
    if args.source == "sim":
        scen = sim.default_scenario(signal="noise", bandwidth_hz=50e3)
        idx = args.sim_index % len(scen.buoys)
        node = simulated_buoy(scen, idx, cfg)
        # An explicit --id wins over the scenario's buoy name (the
        # scenario still provides position/physics for this node).
        if args.id != "buoy-001":
            node.config = dataclasses.replace(node.config, buoy_id=args.id)
    elif args.source == "file":
        from radio_mapper_tpu.ingest import FileSource

        node = BuoyNode(cfg, source=FileSource(args.file, sample_rate_hz=args.sample_rate))
    elif args.source == "rtl_tcp":
        from radio_mapper_tpu.net.rtl_tcp import RtlTcpSource

        host, _, port = args.rtl_tcp.partition(":")
        node = BuoyNode(
            cfg,
            source=RtlTcpSource(host, int(port or 1234), sample_rate_hz=args.sample_rate),
        )
    elif args.source == "native-file":
        from radio_mapper_tpu.ingest.native import NativeIngest, NativeRingSource

        node = BuoyNode(cfg, source=NativeRingSource(
            NativeIngest.open_file(args.file), sample_rate_hz=args.sample_rate))
    elif args.source == "native-tcp":
        from radio_mapper_tpu.ingest.native import NativeIngest, NativeRingSource

        host, _, port = args.rtl_tcp.partition(":")
        node = BuoyNode(cfg, source=NativeRingSource(
            NativeIngest.open_tcp(host, int(port or 1234)),
            sample_rate_hz=args.sample_rate))
    elif args.source == "usbmodel":
        # live node on the in-process L0 driver stack (device model —
        # swap the transport for a libusb adapter on real hardware)
        from radio_mapper_tpu.ingest.sources import Rtl2832uSource
        from radio_mapper_tpu.net.rtl2832u_model import open_model_device

        src = Rtl2832uSource(open_model_device(),
                             sample_rate_hz=args.sample_rate)
        # the dongle resampler QUANTIZES the rate — the node must use
        # the achieved value, not the request
        cfg = dataclasses.replace(cfg, sample_rate_hz=src.sample_rate_hz)
        node = BuoyNode(cfg, source=src)
    else:  # rtl_sdr subprocess
        from radio_mapper_tpu.ingest import RtlSdrProcessSource

        node = BuoyNode(cfg, source=RtlSdrProcessSource(sample_rate_hz=args.sample_rate))
    asyncio.run(node.run())


def cmd_web(args):
    from radio_mapper_tpu.webapp.app import WebApp

    app = WebApp(
        central_http_url=args.central, host=args.host, port=args.port,
        dev_mock=args.mock,
    )
    asyncio.run(app.run_forever())


def cmd_simulate(args):
    import numpy as np
    import jax.numpy as jnp

    from radio_mapper_tpu import geo, sim
    from radio_mapper_tpu.models.pipeline import PipelineConfig, TDOAPipeline

    dwells = max(1, args.dwells)
    scen = sim.default_scenario(
        emitter_lat=args.lat, emitter_lng=args.lng, signal=args.signal,
        bandwidth_hz=args.bandwidth, snr_db=args.snr,
        timing_jitter_s=args.timing_jitter_us * 1e-6, seed=args.seed,
        block_len=16_384 * dwells,
    )
    cap = sim.synthesize(scen)
    pipe = TDOAPipeline(
        PipelineConfig(
            num_buoys=len(scen.buoys), block_len=scen.block_len // dwells,
            sample_rate_hz=scen.sample_rate_hz, max_lag=600,
            power_offset_db=40.0, correlation_dwells=dwells,
            solver_starts=4 if dwells > 1 else 1,
        )
    )
    # the (re, im) float32 path the uint8 ingest feeds
    iq = np.asarray(cap.iq, np.complex64)
    out = pipe.jit_step_split()(
        jnp.asarray(iq.real), jnp.asarray(iq.imag),
        jnp.asarray(cap.buoy_enu, jnp.float32),
    )
    est = np.asarray(out.fix.position_enu)
    lat, lng, _ = geo.enu_to_lat_lng(jnp.asarray(est), *scen.ref_origin)
    err = float(np.linalg.norm(est[:2] - cap.emitter_enu[0][:2]))
    print(f"emitter (true): {scen.emitters[0].lat:.6f}, {scen.emitters[0].lng:.6f}")
    print(f"emitter (fix):  {float(lat):.6f}, {float(lng):.6f}")
    print(f"error: {err:.1f} m   residual rms: {float(np.asarray(out.fix.residual_rms_m)):.2f} m")
    print(
        "1-sigma ellipse: "
        f"{float(np.asarray(out.fix.ellipse_major_m)):.1f} x "
        f"{float(np.asarray(out.fix.ellipse_minor_m)):.1f} m @ "
        f"{float(np.asarray(out.fix.ellipse_orientation_deg)):.0f} deg"
    )
    print(f"pair lags (samples): {np.round(np.asarray(out.correlation.lag_samples), 2).tolist()}")


def cmd_wideband(args):
    """Config-4 demo: synthesize a wideband scene with one active
    subchannel emitter, run the channelized pipeline, print the
    per-subchannel weights and the active subchannel's fix."""
    import numpy as np
    import jax.numpy as jnp

    from radio_mapper_tpu import constants
    from radio_mapper_tpu.models.wideband import WidebandConfig, WidebandTDOAPipeline

    C = constants.SPEED_OF_LIGHT_M_S
    cfg = WidebandConfig(
        num_buoys=args.buoys, wide_rate_hz=args.rate,
        num_subchannels=args.subchannels, sub_block=args.sub_block,
        max_lag=args.max_lag,
    )
    pipe = WidebandTDOAPipeline(cfg)
    b, fs = cfg.num_buoys, cfg.wide_rate_hz
    ang = 2 * np.pi * np.arange(b) / b
    anchors = np.stack(
        [12_000 * np.cos(ang), 12_000 * np.sin(ang), np.zeros(b)], -1
    ).astype(np.float32)
    emitter = np.array([2_000.0, -3_000.0, 0.0])
    sub = args.active_sub % cfg.num_subchannels
    from radio_mapper_tpu import sim

    re, im = sim.synthesize_wideband(
        cfg, active_subchannel=sub, anchors_enu=anchors,
        emitter_enu=emitter, snr_db=args.snr, seed=args.seed,
    )
    out = pipe.jit_step_split()(
        jnp.asarray(re), jnp.asarray(im), jnp.asarray(anchors)
    )
    w = np.asarray(out.weights).mean(axis=-1)
    fixes = np.asarray(out.fixes_enu)
    print(f"wideband: {b} buoys x {fs/1e6:.1f} MS/s -> "
          f"{cfg.num_subchannels} subchannels x {cfg.sub_rate_hz/1e3:.0f} kS/s, "
          f"{cfg.num_pairs} pairs/subchannel")
    for m in range(cfg.num_subchannels):
        off = out.channel_offset_hz[m]
        tag = " <- active" if m == sub else ""
        print(f"  sub {m:2d} ({off/1e3:+8.0f} kHz): mean weight {w[m]:.3f}{tag}")
    err = np.linalg.norm(fixes[sub, :2] - emitter[:2])
    print(f"active subchannel fix: ({fixes[sub,0]:.1f}, {fixes[sub,1]:.1f}) m "
          f"— error {err:.1f} m (true ({emitter[0]:.0f}, {emitter[1]:.0f}))")


def cmd_analyze(args):
    from radio_mapper_tpu.analyzer import analyze_directory, analyze_iq_file

    kwargs = dict(
        sample_rate_hz=args.sample_rate,
        center_frequency_hz=args.frequency * 1e6,
        plot_path=args.plot,
    )
    if args.path.endswith(".bin"):
        print(analyze_iq_file(args.path, **kwargs).summary())
    else:
        for a in analyze_directory(args.path, **kwargs):
            print(a.summary())
            print()


def cmd_capture(args):
    import subprocess

    out = args.output
    if args.source == "rtl_sdr":
        # `sdr_capture.py:13-81` parity: shell out to rtl_sdr.
        n_bytes = args.samples * 2
        cmd = [
            "rtl_sdr", "-f", str(int(args.frequency * 1e6)),
            "-s", str(int(args.sample_rate)), "-n", str(n_bytes), out,
        ]
        print("+", " ".join(cmd))
        try:
            subprocess.run(cmd, check=True, timeout=args.samples / args.sample_rate + 15)
        except FileNotFoundError:
            print("rtl_sdr binary not found — use --source sim for synthetic capture")
            sys.exit(1)
    elif args.source == "usbmodel":
        # capture through the full L0 driver stack against the modeled
        # dongle: open/probe/tune ride the real register/PLL path
        from radio_mapper_tpu.ingest.sources import Rtl2832uSource
        from radio_mapper_tpu.net.rtl2832u_model import open_model_device
        from radio_mapper_tpu.ops import iq as iq_ops

        src = Rtl2832uSource(
            open_model_device(), sample_rate_hz=args.sample_rate,
            center_frequency_hz=args.frequency * 1e6)
        data = src.read(args.samples)
        src.close()
        iq_ops.save_iq_bin(out, data)
        print(f"wrote {args.samples} samples via the L0 driver stack to "
              f"{out} (achieved LO {src.achieved_lo_hz:.1f} Hz, "
              f"rate {src.sample_rate_hz:.3f} Hz)")
    else:
        from radio_mapper_tpu import sim
        from radio_mapper_tpu.ingest import SimulatedSource
        from radio_mapper_tpu.ops import iq as iq_ops

        scen = sim.default_scenario()
        src = SimulatedSource(scen, 0)
        data = src.read(args.samples)
        iq_ops.save_iq_bin(out, data * 40.0)
        print(f"wrote {args.samples} synthetic samples to {out}")


def cmd_scan(args):
    """rtl_power-style wideband survey to CSV."""
    from radio_mapper_tpu.tools import power_scan

    if args.source == "sim":
        from radio_mapper_tpu import sim
        from radio_mapper_tpu.ingest import SimulatedSource

        source = SimulatedSource(sim.default_scenario(signal="tone"), 0)
    elif args.source == "rtl_tcp":
        from radio_mapper_tpu.net.rtl_tcp import RtlTcpSource

        host, _, port = args.rtl_tcp.partition(":")
        source = RtlTcpSource(host, int(port or 1234), sample_rate_hz=args.sample_rate)
    else:
        from radio_mapper_tpu.ingest import RtlSdrProcessSource

        source = RtlSdrProcessSource(sample_rate_hz=args.sample_rate)
    lines = power_scan.scan_to_csv(
        source,
        args.freq_lo * 1e6,
        args.freq_hi * 1e6,
        bin_hz=args.bin_hz,
        integration_s=args.integration,
        out_path=args.output,
        passes=args.passes,
        peak_hold=args.peak,
    )
    if not args.output:
        for line in lines:
            print(line)
    else:
        print(f"wrote {len(lines)} rows to {args.output}")


def cmd_stream(args):
    """Continuous streaming TDOA over a simulated scenario (config-3 demo)."""
    import numpy as np
    import jax.numpy as jnp

    from radio_mapper_tpu import sim
    from radio_mapper_tpu.models.streaming_tdoa import StreamingTDOA, StreamingTDOAConfig

    scen = sim.default_scenario(
        signal="noise", bandwidth_hz=args.bandwidth, snr_db=args.snr,
        block_len=args.block_len * args.blocks,
    )
    cap = sim.synthesize(scen)
    st = StreamingTDOA(
        StreamingTDOAConfig(
            num_buoys=len(scen.buoys),
            num_subchannels=args.subchannels,
            sample_rate_hz=scen.sample_rate_hz,
            block_len=args.block_len,
            max_lag=args.max_lag,
        )
    )
    anchors = jnp.asarray(cap.buoy_enu, jnp.float32)
    state = st.init_state()
    step = st.jit_step()
    for k in range(args.blocks):
        blk = jnp.asarray(
            cap.iq[:, k * args.block_len : (k + 1) * args.block_len], jnp.complex64
        )
        state, out = step(state, blk, anchors)
        w = np.asarray(out.weights)
        best = int(np.argmax(w.sum(axis=-1)))
        est = np.asarray(out.fixes_enu)[best]
        err = np.linalg.norm(est[:2] - cap.emitter_enu[0][:2])
        print(
            f"block {k}: best subchannel {best}  fix ENU=({est[0]:.0f},{est[1]:.0f})  "
            f"err={err:.0f} m  mean psr={np.asarray(out.psr)[best].mean():.2f}"
        )


def _parse_freq_specs(specs):
    """rtl_fm -f frequency list: each entry is a single MHz value or an
    inclusive ``lower:upper:step`` MHz range (`rtl_fm.c`'s frequency_range
    parsing). Returns the expanded scan list in MHz."""
    freqs = []
    for spec in specs:
        s = str(spec)
        if ":" in s:
            parts = s.split(":")
            if len(parts) != 3:
                raise ValueError(f"range must be lower:upper:step, got {s!r}")
            lo, hi, step = (float(p) for p in parts)
            if step <= 0 or hi < lo:
                raise ValueError(f"bad range {s!r}")
            f = lo
            while f <= hi + 1e-9:
                freqs.append(round(f, 9))
                f += step
        else:
            freqs.append(float(s))
    if not freqs:
        raise ValueError("no frequencies given")
    return freqs


def _demod_audio(iq, mode, sample_rate, audio_rate):
    """One block through the selected rtl_fm demod pipeline → float audio."""
    import jax.numpy as jnp

    from radio_mapper_tpu.ops import demod as demod_ops

    iq = jnp.asarray(iq)
    if mode == "nbfm":
        return demod_ops.nbfm_pipeline(
            iq, sample_rate_hz=sample_rate, audio_rate_hz=audio_rate)
    if mode == "wbfm":
        return demod_ops.wbfm_pipeline(
            iq, sample_rate_hz=sample_rate, audio_rate_hz=audio_rate)
    factor = max(1, int(sample_rate / audio_rate))
    if mode == "am":
        return demod_ops.decimate(demod_ops.am_demod(iq), factor)
    if mode == "usb":
        return demod_ops.decimate(
            demod_ops.usb_demod(iq, sample_rate_hz=sample_rate), factor)
    return demod_ops.decimate(
        demod_ops.lsb_demod(iq, sample_rate_hz=sample_rate), factor)


def _cmd_demod_watch(args, source, freqs_mhz):
    """Simultaneous multi-frequency watch: one wideband capture, all watch
    channels mixed/decimated/demodulated in a single batched jit per block,
    per-channel squelch gating, per-channel streaming WAV sinks.

    The batched replacement for rtl_fm's retune-and-hop scanner
    (`rtl_fm.c:939-974`): no tuner hops, no settle/flush dead time, no
    missed activity on unwatched frequencies.
    """
    import functools
    import wave

    import jax
    import jax.numpy as jnp
    import numpy as np

    from radio_mapper_tpu.ops import demod as demod_ops

    center_hz = float(np.mean(freqs_mhz)) * 1e6
    # The capture rate is whatever the source actually delivers (a sim
    # source runs at its scenario's rate regardless of --sample-rate).
    fs = float(getattr(source, "sample_rate_hz", args.sample_rate))
    span_hz = (max(freqs_mhz) - min(freqs_mhz)) * 1e6
    if span_hz > fs:
        source.close()
        raise SystemExit(
            f"demod --watch: {span_hz/1e6:.3f} MHz span exceeds the "
            f"{fs/1e6:.3f} MS/s capture"
        )
    source.tune(center_hz)
    offsets = tuple(f * 1e6 - center_hz for f in freqs_mhz)

    factor = max(1, int(round(fs / args.channel_rate)))
    audio_factor = max(1, int(round(args.channel_rate / args.audio_rate)))
    block = max(1, int(args.dwell * fs))
    quantum = factor * audio_factor
    block = max(quantum, block - block % quantum)
    step = jax.jit(
        functools.partial(
            demod_ops.watch_demod_block,
            sample_rate_hz=fs,
            offsets_hz=offsets,
            mode=args.mode,
            channel_rate_hz=fs / factor,
            audio_rate_hz=fs / factor / audio_factor,
            squelch_threshold=args.squelch,
        )
    )
    # Deterministic streaming gain (per-block peak normalization would
    # pump): FM discriminator output is ±π; envelope modes ~unit scale.
    scale = 32000.0 / np.pi if args.mode in ("wbfm", "nbfm") else 16000.0

    sinks = []
    for f in freqs_mhz:
        w = wave.open(f"{args.output}.{f:.4f}MHz.wav", "wb")
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(int(fs / factor / audio_factor))
        sinks.append(w)
    counts = [0] * len(freqs_mhz)
    total = int(args.seconds * fs)
    consumed = 0
    try:
        while consumed < total:
            iq = source.read(block)
            consumed += block
            audio, open_ = step(jnp.asarray(iq))
            audio = np.asarray(audio)
            open_np = np.asarray(open_)
            for k in range(len(freqs_mhz)):
                if open_np[k]:
                    counts[k] += 1
                    pcm = np.clip(audio[k] * scale, -32767, 32767).astype(np.int16)
                    sinks[k].writeframes(pcm.tobytes())
    finally:
        source.close()
        for w in sinks:
            w.close()
    for f, c in zip(freqs_mhz, counts):
        print(f"# {f:.4f} MHz: {c} open block(s) -> {args.output}.{f:.4f}MHz.wav")


def cmd_demod(args):
    """rtl_fm-style demodulator: source → audio PCM (s16le) to a file."""
    import numpy as np
    import jax.numpy as jnp

    from radio_mapper_tpu.ops import demod as demod_ops

    freqs_mhz = _parse_freq_specs(args.frequency)
    args.frequency = freqs_mhz[0]
    if args.source == "sim":
        from radio_mapper_tpu import sim
        from radio_mapper_tpu.ingest import SimulatedSource

        scen = sim.default_scenario(signal="fm", bandwidth_hz=150e3)
        source = SimulatedSource(scen, 0)
        source.tune(scen.center_frequency_mhz * 1e6)
    elif args.source == "rtl_tcp":
        from radio_mapper_tpu.net.rtl_tcp import RtlTcpSource

        host, _, port = args.rtl_tcp.partition(":")
        source = RtlTcpSource(
            host, int(port or 1234), sample_rate_hz=args.sample_rate,
            center_frequency_hz=args.frequency * 1e6,
        )
    else:
        from radio_mapper_tpu.ingest import RtlSdrProcessSource

        source = RtlSdrProcessSource(
            sample_rate_hz=args.sample_rate, center_frequency_hz=args.frequency * 1e6
        )
    if args.watch:
        if args.mode == "raw":
            source.close()
            raise SystemExit("demod: --watch needs a demod mode, not raw")
        _cmd_demod_watch(args, source, freqs_mhz)
        return
    if len(freqs_mhz) > 1:
        # rtl_fm scanning mode: with multiple -f frequencies, squelch is
        # mandatory and a closed squelch hops to the next frequency
        # (`rtl_fm.c:939-974` controller thread; hop signal :868-878).
        if args.squelch <= 0:
            source.close()
            raise SystemExit("demod: multiple frequencies require --squelch > 0")
        if args.mode == "raw":
            source.close()
            raise SystemExit("demod: raw mode does not scan; give one frequency")
        dwell = max(2048, int(args.dwell * args.sample_rate))
        total = int(args.seconds * args.sample_rate)
        hits = 0
        idx = 0
        open_dwells = {f: 0 for f in freqs_mhz}
        source.tune(freqs_mhz[idx] * 1e6)
        parts = []
        consumed = 0
        while consumed < total:
            iq = source.read(dwell)
            consumed += dwell
            gated, open_ = demod_ops.squelch(jnp.asarray(iq), args.squelch)
            if bool(np.asarray(open_)):
                hits = 0
                open_dwells[freqs_mhz[idx]] += 1
                parts.append(np.asarray(_demod_audio(
                    gated, args.mode, args.sample_rate, args.audio_rate)))
            else:
                hits += 1
                if hits >= args.squelch_hits:  # rtl_fm -t conseq_squelch
                    hits = 0
                    idx = (idx + 1) % len(freqs_mhz)
                    source.tune(freqs_mhz[idx] * 1e6)
        source.close()
        for f, count in open_dwells.items():
            print(f"# {f:.4f} MHz: {count} open dwell(s)")
        if not parts:
            print("# squelch never opened on any scanned frequency")
            np.zeros(0, np.int16).tofile(args.output)
            return
        a = np.concatenate(parts)
    else:
        n = int(args.seconds * args.sample_rate)
        iq = source.read(n)
        source.close()
        if args.squelch > 0:
            # rtl_fm's -l power gate (`rtl_fm.c:868-878`): mute below threshold.
            iq_arr, open_ = demod_ops.squelch(jnp.asarray(iq), args.squelch)
            iq = np.asarray(iq_arr)
            if not bool(np.asarray(open_)):
                print("# squelch closed (mean power below threshold); output muted")
        if args.mode == "raw":
            # rtl_fm raw mode: no demodulation — interleaved I/Q s16 at the
            # capture rate (`rtl_fm.c`'s raw output path).
            a = np.empty(2 * len(iq), np.float32)
            a[0::2] = np.real(iq)
            a[1::2] = np.imag(iq)
            peak = np.abs(a).max() + 1e-12
            pcm = np.clip(a / peak * 32000.0, -32767, 32767).astype(np.int16)
            pcm.tofile(args.output)
            print(f"wrote {pcm.size} s16le raw I/Q values @ {args.sample_rate:.0f} Hz to {args.output}")
            return
        a = np.asarray(_demod_audio(iq, args.mode, args.sample_rate, args.audio_rate))
    peak = np.abs(a).max() + 1e-12
    pcm = np.clip(a / peak * 32000.0, -32767, 32767).astype(np.int16)
    pcm.tofile(args.output)
    print(f"wrote {pcm.size} s16le samples @ {args.audio_rate:.0f} Hz to {args.output}")


def cmd_adsb(args):
    """rtl_adsb-style Mode-S decoder: prints `*<hex>;` frames."""
    from radio_mapper_tpu.ops import adsb as adsb_ops

    if args.source == "selftest":
        iq = adsb_ops.encode_frame_iq(
            adsb_ops.append_crc("8d4840d6202cc371c32ce057"), noise=0.02
        )
        for frame in adsb_ops.decode_block(iq, require_crc=not args.no_crc):
            print(frame)
        return
    if args.source == "rtl_tcp":
        from radio_mapper_tpu.net.rtl_tcp import RtlTcpSource

        host, _, port = args.rtl_tcp.partition(":")
        source = RtlTcpSource(
            host, int(port or 1234),
            sample_rate_hz=adsb_ops.ADSB_RATE_HZ, center_frequency_hz=1090e6,
        )
    else:
        from radio_mapper_tpu.ingest import RtlSdrProcessSource

        source = RtlSdrProcessSource(
            sample_rate_hz=adsb_ops.ADSB_RATE_HZ, center_frequency_hz=1090e6
        )
    try:
        for _ in range(args.blocks):
            iq = source.read(1 << 18)
            for frame in adsb_ops.decode_block(iq, require_crc=not args.no_crc):
                print(frame, flush=True)
    finally:
        source.close()


def cmd_sdrtest(args):
    """rtl_test-style SDR health benchmark (drops + sample-clock PPM)."""
    import json

    from radio_mapper_tpu.tools import sdr_test

    host, _, port = args.rtl_tcp.partition(":")
    if args.loopback:
        # Hermetic self-drive: serve a simulated source in-process and
        # benchmark our own transport (no hardware needed).
        from radio_mapper_tpu import sim
        from radio_mapper_tpu.ingest import SimulatedSource
        from radio_mapper_tpu.net import rtl_tcp

        server = rtl_tcp.RtlTcpServer(
            SimulatedSource(sim.default_scenario(signal="tone"), 0),
            host="127.0.0.1",
            port=int(port or 1234),
            throttle=args.throttle,
        )
        rtl_tcp.serve_in_thread(server)
        host = "127.0.0.1"
    report = sdr_test.sdr_test_rtl_tcp(
        host,
        int(port or 1234),
        sample_rate_hz=args.sample_rate,
        drop_seconds=args.drop_seconds,
        ppm_seconds=args.ppm_seconds,
    )
    print(json.dumps(report, indent=2))
    d = report["drop_test"]
    p = report["ppm_test"]
    print(
        f"# drops: {d['lost_bytes']} bytes in {d['gaps']} gaps "
        f"({100*d['loss_ratio']:.4f}% loss); "
        f"rate: {p['measured_rate_hz']:.0f} Hz vs nominal "
        f"{p['nominal_rate_hz']:.0f} ({p['ppm_error']:+.1f} ppm)"
    )


def cmd_bench(args):
    import bench as bench_mod

    bench_mod.main()


def cmd_test(args):
    """Environment self-test (`run.py:246-320` parity)."""
    import importlib
    import socket

    ok = True

    def check(name, fn):
        nonlocal ok
        try:
            result = fn()
            print(f"  [PASS] {name}" + (f" — {result}" if result not in (None, True) else ""))
        except Exception as e:
            ok = False
            print(f"  [FAIL] {name} — {e}")

    print("Configuration:")
    check("config defaults validate", lambda: __import__(
        "radio_mapper_tpu.config", fromlist=["Config"]).Config().validate() and None)
    print("Dependencies:")
    for mod in ("jax", "numpy", "scipy", "websockets", "aiohttp", "yaml"):
        check(f"import {mod}", lambda m=mod: importlib.import_module(m).__name__)
    print("Compute:")
    check("jax devices", lambda: __import__("jax").devices())
    check("pipeline smoke (tiny)", lambda: _pipeline_smoke())
    print("L0 driver stack:")
    check("USB bring-up + counter test (device model)", lambda: _l0_smoke())
    print("Hardware:")
    from radio_mapper_tpu.config.autodetect import auto_detect_interfaces

    report = auto_detect_interfaces()
    print(f"  local ip: {report['local_ip']}")
    print(f"  gps devices: {report['gps_devices'] or 'none'}")
    print(f"  sdr count: {report['sdr_count']}")
    print(f"  accelerator: {report['accelerator']}")
    print("Ports:")
    for port in (8081, 4000, 7000):
        s = socket.socket()
        try:
            s.bind(("127.0.0.1", port))
            print(f"  [PASS] port {port} available")
        except OSError:
            print(f"  [WARN] port {port} in use")
        finally:
            s.close()
    sys.exit(0 if ok else 1)


def _pipeline_smoke():
    import numpy as np

    from radio_mapper_tpu.models.pipeline import PipelineConfig, TDOAPipeline

    pipe = TDOAPipeline(PipelineConfig(num_buoys=3, block_len=1024, max_lag=64,
                                       solver_iterations=5))
    iq, anchors = pipe.example_inputs()
    out = pipe.jit_step()(iq, anchors)
    assert np.all(np.isfinite(np.asarray(out.fix.position_enu)))
    return "ok"


def _l0_smoke() -> str:
    """Open→probe→tune→counter-stream through the full USB driver
    protocol against the register-level device model (the reference's
    `rtl_test -t` drop check, hardware-free)."""
    import numpy as np

    from radio_mapper_tpu.net.rtl2832u_model import open_model_device
    from radio_mapper_tpu.net.usb_proto import TunerType
    from radio_mapper_tpu.tools.sdr_test import DropStats

    dev = open_model_device()
    assert dev.tuner_type == TunerType.R820T
    rate = dev.set_sample_rate(2_048_000)
    dev.set_testmode(True)
    stats = DropStats()
    stats.update(np.frombuffer(dev.read_sync(16384), np.uint8))
    dev.close()
    assert stats.lost_bytes == 0 and stats.gaps == 0
    return f"{dev.tuner_type.name} @ {rate:.0f} Hz, 0 dropped"


def _check_time_sync() -> str:
    """Best-effort host clock-sync probe for `setup` — the reference
    shells out to `ntpdate -q` (`run.py:209-220`); here we try the
    commands a modern host actually has, degrading gracefully (offline
    boxes and containers report 'unavailable', never fail)."""
    import shutil
    import subprocess

    probes = [
        (["timedatectl", "show", "--property=NTPSynchronized"],
         lambda out: "synchronized" if "NTPSynchronized=yes" in out
         else "NOT synchronized"),
        (["chronyc", "tracking"],
         lambda out: next((ln.strip() for ln in out.splitlines()
                           if "System time" in ln), "tracking ok")),
        (["ntpdate", "-q", "pool.ntp.org"], lambda out: "reachable"),
    ]
    failed = []
    for cmd, interpret in probes:
        if shutil.which(cmd[0]) is None:
            continue
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=10)
        except Exception:
            # a timeout/exec failure is still a failed probe of a tool
            # that EXISTS — report it, don't claim the tool is absent
            failed.append(cmd[0])
            continue
        if r.returncode == 0:
            return f"{cmd[0]}: {interpret(r.stdout)}"
        failed.append(cmd[0])  # e.g. timedatectl without systemd
    if failed:
        return f"probe failed ({', '.join(failed)})"
    return "unavailable (no timedatectl/chronyc/ntpdate)"


def cmd_setup(args):
    from radio_mapper_tpu.config.autodetect import auto_detect_interfaces
    from radio_mapper_tpu.config.loader import generate_example_yaml
    from radio_mapper_tpu.config.schema import TimingConfig

    report = auto_detect_interfaces()
    print("Detected interfaces:")
    for k, v in report.items():
        print(f"  {k}: {v}")
    # timing self-test (`run.py:204-220` parity): GPS hardware feeds the
    # sub-µs path; the host clock is the fallback the ntp check covers
    timing = TimingConfig()
    print("Time synchronization:")
    print(f"  method: {timing.method} "
          f"(target {timing.target_accuracy_microseconds:g} us, "
          f"max {timing.max_acceptable_microseconds:g} us)")
    print(f"  host clock: {_check_time_sync()}")
    generate_example_yaml(args.output)
    print(f"example config written to {args.output}")


def cmd_eeprom(args):
    """rtl_eeprom-parity image tool (`Code/src/rtl_eeprom.c`)."""
    from radio_mapper_tpu.tools import eeprom

    sys.exit(eeprom.run(args))


def cmd_usbprobe(args):
    """Run the librtlsdr-equivalent USB bring-up protocol
    (`Code/src/librtlsdr.c:1407-1602`) against the register-level device
    model — demonstrates the L0 open→init→probe→tune→stream state
    machine end-to-end without hardware."""
    from radio_mapper_tpu.net.rtl2832u_model import MockRtlUsbTransport
    from radio_mapper_tpu.net.usb_proto import Rtl2832u, TunerType
    from radio_mapper_tpu.tools.sdr_test import DropStats

    tuner = TunerType[args.tuner.upper()]
    transport = MockRtlUsbTransport(tuner)
    dev = Rtl2832u(transport)
    found = dev.open()
    real_rate = dev.set_sample_rate(int(args.rate))
    achieved = dev.set_center_freq(int(args.freq))
    snapped = dev.set_tuner_gain(args.gain) if found != TunerType.UNKNOWN \
        else None
    dev.set_testmode(True)
    stats = DropStats()
    import numpy as np
    for _ in range(8):
        stats.update(np.frombuffer(dev.read_sync(16384), np.uint8))
    dev.set_testmode(False)
    dev.close()
    print(f"tuner: {found.name}")
    print(f"sample rate: requested {args.rate} -> achieved {real_rate:.3f} Hz")
    print(f"center freq: requested {args.freq} -> achieved {achieved:.1f} Hz "
          f"(LO error {achieved - float(args.freq):+.1f} Hz)")
    if snapped is not None:
        print(f"gain: requested {args.gain/10:.1f} dB -> "
              f"snapped {snapped/10:.1f} dB")
    print(f"counter test: {stats.total_bytes} bytes, "
          f"{stats.lost_bytes} lost, {stats.gaps} gaps")
    print(f"control transfers: {transport.stats.control_out} out / "
          f"{transport.stats.control_in} in; "
          f"bulk bytes: {transport.stats.bulk_bytes}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="radio_mapper_tpu", description="Batched TDOA geolocation framework"
    )
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument(
        "--backend", choices=["auto", "cpu", "gpu"], default=None,
        help="JAX platform; utility commands default to cpu, "
             "pipeline/bench commands to JAX's default; gpu fails "
             "when there is none",
    )
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("server", help="run the central processor")
    s.add_argument("--host", default="0.0.0.0")
    s.add_argument("--ws-port", type=int, default=8081)
    s.add_argument("--http-port", type=int, default=4000)
    s.add_argument("--min-nodes", type=int, default=3)
    s.add_argument("--waveform-mode", choices=["auto", "always", "never"],
                   default="auto",
                   help="waveform GCC-PHAT TDOA on IQ-bearing detections "
                        "(auto = prefer, fall back to timestamps)")
    s.set_defaults(fn=cmd_server)

    s = sub.add_parser("buoy", help="run a buoy node")
    s.add_argument("--id", default="buoy-001")
    s.add_argument("--central", default="ws://localhost:8081")
    s.add_argument(
        "--source",
        choices=["sim", "file", "rtl_sdr", "rtl_tcp", "native-file",
                 "native-tcp", "usbmodel"],
        default="sim",
        help="native-* variants ingest through the C++ ring (native/); "
             "usbmodel runs the in-process L0 driver stack",
    )
    s.add_argument("--sim-index", type=int, default=0)
    s.add_argument("--file", help="raw uint8 I/Q .bin for --source file")
    s.add_argument("--rtl-tcp", default="127.0.0.1:1234")
    s.add_argument("--sample-rate", type=float, default=2_048_000.0)
    s.add_argument("--dev", action="store_true", help="development mode (simulated GPS)")
    s.add_argument("--iq-wire-format", choices=["u8", "f16", "json"], default="u8",
                   help="snippet encoding on the wire (u8 ≈ 15× smaller than json)")
    s.add_argument("--snippet-samples", type=int, default=2048,
                   help="IQ samples attached per detection for waveform TDOA")
    s.set_defaults(fn=cmd_buoy)

    s = sub.add_parser("web", help="run the web dashboard")
    s.add_argument("--central", default="http://localhost:4000")
    s.add_argument("--host", default="0.0.0.0")
    s.add_argument("--port", type=int, default=7000)
    s.add_argument("--mock", action="store_true",
                   help="serve canned data when central is unreachable (dev)")
    s.set_defaults(fn=cmd_web)

    s = sub.add_parser("simulate", help="synthetic scenario through the pipeline")
    s.add_argument("--lat", type=float, default=35.47)
    s.add_argument("--lng", type=float, default=-97.51)
    s.add_argument("--signal", default="noise", choices=["noise", "tone", "bpsk", "chirp", "fm"])
    s.add_argument("--bandwidth", type=float, default=150e3)
    s.add_argument("--snr", type=float, default=25.0)
    s.add_argument("--timing-jitter-us", type=float, default=0.0)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--dwells", type=int, default=1,
                   help="narrowband mode: correlate this many consecutive "
                        "dwells as one coherent capture (correlation_dwells)")
    s.set_defaults(fn=cmd_simulate)

    s = sub.add_parser(
        "wideband",
        help="BASELINE config-4 demo: wideband capture -> PFB channelizer "
             "-> per-subchannel all-pairs GCC -> per-subchannel fixes",
    )
    s.add_argument("--buoys", type=int, default=16)
    s.add_argument("--rate", type=float, default=10e6, help="wideband MS/s")
    s.add_argument("--subchannels", type=int, default=16)
    s.add_argument("--sub-block", type=int, default=4096)
    s.add_argument("--max-lag", type=int, default=128)
    s.add_argument("--active-sub", type=int, default=5,
                   help="subchannel index carrying the synthetic emitter")
    s.add_argument("--snr", type=float, default=25.0)
    s.add_argument("--seed", type=int, default=0)
    s.set_defaults(fn=cmd_wideband)

    s = sub.add_parser("analyze", help="analyze .bin IQ captures")
    s.add_argument("path")
    s.add_argument("--sample-rate", type=float, default=2_048_000.0)
    s.add_argument("--frequency", type=float, default=0.0, help="center freq MHz")
    s.add_argument("--plot", help="write spectrum PNG here")
    s.set_defaults(fn=cmd_analyze)

    s = sub.add_parser("capture", help="capture IQ to .bin")
    s.add_argument("--source", choices=["rtl_sdr", "sim", "usbmodel"],
                   default="rtl_sdr")
    s.add_argument("--frequency", type=float, default=121.5, help="MHz")
    s.add_argument("--sample-rate", type=float, default=2_048_000.0)
    s.add_argument("--samples", type=int, default=2_048_000)
    s.add_argument("--output", default="iq_capture.bin")
    s.set_defaults(fn=cmd_capture)

    s = sub.add_parser("demod", help="demodulate to audio PCM (rtl_fm parity)")
    s.add_argument(
        "--mode",
        choices=["wbfm", "nbfm", "am", "usb", "lsb", "raw"],
        default="wbfm",
    )
    s.add_argument("--squelch", type=float, default=0.0,
                   help="mean-power squelch threshold (rtl_fm -l), 0 = off")
    s.add_argument("--source", choices=["sim", "rtl_tcp", "rtl_sdr"], default="sim")
    s.add_argument("--rtl-tcp", default="127.0.0.1:1234")
    s.add_argument(
        "--frequency", nargs="+", default=["105.7"],
        help="MHz; several values or lower:upper:step ranges scan with "
             "squelch-driven hopping (rtl_fm -f list)")
    s.add_argument("--dwell", type=float, default=0.1,
                   help="seconds per scan dwell before a squelch decision")
    s.add_argument("--squelch-hits", type=int, default=1,
                   help="closed dwells before hopping (rtl_fm -t)")
    s.add_argument("--sample-rate", type=float, default=1_024_000.0)
    s.add_argument("--audio-rate", type=float, default=32_000.0)
    s.add_argument("--seconds", type=float, default=2.0)
    s.add_argument("--output", default="audio.s16le")
    s.add_argument(
        "--watch", action="store_true",
        help="demodulate ALL --frequency channels simultaneously from one "
             "wideband capture (batched; replaces hop scanning) and write "
             "per-channel WAV files <output>.<MHz>.wav")
    s.add_argument("--channel-rate", type=float, default=256_000.0,
                   help="--watch per-channel rate before audio decimation")
    s.set_defaults(fn=cmd_demod)

    s = sub.add_parser("adsb", help="Mode-S/ADS-B decoder (rtl_adsb parity)")
    s.add_argument("--source", choices=["selftest", "rtl_tcp", "rtl_sdr"], default="selftest")
    s.add_argument("--rtl-tcp", default="127.0.0.1:1234")
    s.add_argument("--blocks", type=int, default=8)
    s.add_argument("--no-crc", action="store_true", help="permissive (reference behavior)")
    s.set_defaults(fn=cmd_adsb)

    s = sub.add_parser("scan", help="wideband power survey (rtl_power CSV)")
    s.add_argument("freq_lo", type=float, help="MHz")
    s.add_argument("freq_hi", type=float, help="MHz")
    s.add_argument("--source", choices=["sim", "rtl_tcp", "rtl_sdr"], default="sim")
    s.add_argument("--rtl-tcp", default="127.0.0.1:1234")
    s.add_argument("--sample-rate", type=float, default=2_048_000.0)
    s.add_argument("--bin-hz", type=float, default=10_000.0)
    s.add_argument("--integration", type=float, default=1.0)
    s.add_argument("--passes", type=int, default=1)
    s.add_argument("--peak", action="store_true",
                   help="peak-hold instead of mean integration (rtl_power -P)")
    s.add_argument("--output", help="append CSV rows to this file")
    s.set_defaults(fn=cmd_scan)

    s = sub.add_parser("stream", help="continuous streaming TDOA demo")
    s.add_argument("--blocks", type=int, default=4)
    s.add_argument("--block-len", type=int, default=16_384)
    s.add_argument("--subchannels", type=int, default=8)
    s.add_argument("--max-lag", type=int, default=8)
    s.add_argument("--bandwidth", type=float, default=110e3)
    s.add_argument("--snr", type=float, default=25.0)
    s.set_defaults(fn=cmd_stream)

    s = sub.add_parser(
        "sdrtest", help="SDR drop/PPM health benchmark (rtl_test parity)"
    )
    s.add_argument("--rtl-tcp", default="127.0.0.1:1234")
    s.add_argument("--sample-rate", type=float, default=2_048_000.0)
    s.add_argument("--drop-seconds", type=float, default=5.0)
    s.add_argument("--ppm-seconds", type=float, default=10.0)
    s.add_argument(
        "--loopback", action="store_true",
        help="serve a simulated source in-process and test our own transport",
    )
    s.add_argument("--throttle", action="store_true",
                   help="loopback server paces at the nominal sample rate")
    s.set_defaults(fn=cmd_sdrtest)

    s = sub.add_parser("bench", help="run the throughput benchmark")
    s.set_defaults(fn=cmd_bench)

    s = sub.add_parser("test", help="environment self-test")
    s.set_defaults(fn=cmd_test)

    s = sub.add_parser("setup", help="autodetect hardware, write example config")
    s.add_argument("--output", default="config.example.yaml")
    s.set_defaults(fn=cmd_setup)

    s = sub.add_parser("eeprom", help="RTL2832 EEPROM image tool (rtl_eeprom parity)")
    from radio_mapper_tpu.tools import eeprom as _eeprom

    _eeprom.add_args(s)
    s.set_defaults(fn=cmd_eeprom)

    s = sub.add_parser(
        "usbprobe",
        help="librtlsdr-equivalent USB bring-up against the device model",
    )
    s.add_argument("--tuner", default="r820t",
                   choices=["e4000", "fc0012", "fc0013", "fc2580",
                            "r820t", "r828d", "unknown"],
                   help="tuner chip the modeled dongle carries")
    s.add_argument("--freq", type=float, default=121.5e6)
    s.add_argument("--rate", type=float, default=2_048_000)
    s.add_argument("--gain", type=int, default=400,
                   help="tenth-dB, snapped to the tuner table")
    s.set_defaults(fn=cmd_usbprobe)

    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    _setup_logging(args.verbose)
    _apply_backend(args)
    args.fn(args)


if __name__ == "__main__":
    main()
