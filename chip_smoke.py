#!/usr/bin/env python3
"""Smoke test of the TDOA pipeline on the GPU, through its user entry points.

    python chip_smoke.py               # one GPU
    python chip_smoke.py --devices 4   # four GPUs: the sharded paths only

One process, phases in order; any failure raises and the script exits
non-zero without printing a result:

1. device   — the card's name and power limit (``nvidia-smi``, from a child
              that stays off JAX), JAX's device kind and count.
2. flagship — 128 channels × 8 buoys × 16384 samples at 2.4 MS/s,
              max_lag 512, 8 peaks, 25 solver iterations, through
              ``TDOAPipeline.jit_step_split_uint8`` on uint8 scenes with a
              known emitter. Compile time, ``memory_analysis()``, median
              step time; every valid pair's lag against the float64 golden
              (≤ 0.1 sample) and the fix error, at the shipped matmul
              precision and at "highest".
3. wideband — config 4 (64 buoys × 10 MS/s, 16 subchannels, 2016 pairs)
              on a subchannel emitter with a known position; the active
              subchannel's lags against the golden, and its fix.
4. simulate — the CLI demo ``simulate``, run in process.

With ``--devices N`` only the sharded paths run, each compared with the
same global problem on one of the N cards: config 5 (256 ch × 8 buoys ×
16 subchannels over ("ch", "blk") meshes of N × 1 and, for even N,
N/2 × 2, where the channelizer halo crosses cards) and pair EP
(64 buoys, 2016 pairs over a "pair" mesh).

The last line of standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import statistics
import subprocess
import sys
import time

import numpy as np

import jax

from radio_mapper_tpu import golden, sim
from radio_mapper_tpu.ops import iq as iq_ops

# Fix-error bounds of the CPU tests for the same scenes:
# tests/test_pipeline.py::test_uint8_path (uint8 noise emitter) and
# tests/test_wideband.py (subchannel emitter).
FLAGSHIP_FIX_BOUND_M = 100.0
WIDEBAND_FIX_BOUND_M = 300.0
SIMULATE_FIX_BOUND_M = 100.0
# A pair's correlation is valid when the golden's peak stands this far
# above its largest sidelobe.
VALID_PSR = 1.5
# Beside the user-facing 0.1-sample bound (golden.TAU_BOUND_SAMPLES): on
# an H100 the cuFFT chain's worst |dtau| at the flagship shape is ~2e-5
# samples, while a matmul DFT at TF32 reaches ~1e-2. A bound between the
# two fails a regression to a lower-precision route.
TAU_ROUTE_BOUND_SAMPLES = 1e-3
CENTER = (35.47, -97.51)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit, one line per card, as it prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def ring_buoys(num_buoys: int, radius_m: float = 15_000.0):
    """Buoys on a ring around CENTER, as sim.default_scenario's ``buoys``."""
    lat0, lng0 = CENTER
    out = []
    for k in range(num_buoys):
        a = 2 * np.pi * k / num_buoys
        out.append((
            f"b{k}",
            lat0 + radius_m * np.cos(a) / 111_000.0,
            lng0 + radius_m * np.sin(a) / (111_000.0 * np.cos(np.radians(lat0))),
            10.0,
        ))
    return out


def grid_buoys(side: int, spacing_deg: float = 0.02):
    lat0, lng0 = CENTER
    half = (side - 1) / 2
    return [
        (f"g{r}{c}", lat0 + spacing_deg * (r - half), lng0 + spacing_deg * (c - half), 0.0)
        for r in range(side) for c in range(side)
    ]


def median_step_ms(fn, args, iters: int) -> float:
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def tau_check(label, lags, ref, *, max_lag):
    """Lags ``[..., P]`` vs ``ref``, the float64 golden's output
    (:func:`golden.gcc_phat_all_pairs_numpy`) on the same signals.

    Returns (worst, median, valid count); raises past the 0.1-sample bound
    or past :data:`TAU_ROUTE_BOUND_SAMPLES`.
    """
    valid = (ref["psr"] >= VALID_PSR) & (np.abs(ref["lag_samples"]) < max_lag - 1)
    worst, med = golden.lag_deviation(lags, ref["lag_samples"], valid)
    log(f"{label}: |dtau| vs float64 golden over {int(valid.sum())}/{valid.size} "
        f"valid pairs: worst {worst:.3e}, median {med:.3e} samples "
        f"(bounds {golden.TAU_BOUND_SAMPLES:g}, route {TAU_ROUTE_BOUND_SAMPLES:g})")
    for bound in (golden.TAU_BOUND_SAMPLES, TAU_ROUTE_BOUND_SAMPLES):
        if worst > bound:
            raise AssertionError(f"{label}: worst |dtau| {worst} > {bound}")
    return worst, med, int(valid.sum())


def memory_summary(compiled) -> str:
    ma = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    return ", ".join(f"{f[:-len('_in_bytes')]} {getattr(ma, f, 0) / 1e6:.1f} MB" for f in fields)


PRECISIONS = ("shipped", "highest")


def matmul_precision(label: str):
    """Context for a :data:`PRECISIONS` label: JAX's default or "highest"."""
    return jax.default_matmul_precision(None if label == "shipped" else label)


def run_precisions(step, args, check):
    """``check(out, label)`` at the shipped precision and at "highest"."""
    results = {}
    for label in PRECISIONS:
        with matmul_precision(label):
            out = jax.block_until_ready(step(*args))
        results[label] = check(out, label)
    return results


# ------------------------------------------------------------------ phases


def phase_device():
    from radio_mapper_tpu.utils.device import require_gpu

    devices = jax.devices()
    log("nvidia-smi:")
    log(card_name_and_power_limit())
    log(f"jax: {jax.__version__}, platform {devices[0].platform}, "
        f"device_kind {devices[0].device_kind}, count {len(devices)}")
    return require_gpu()


def phase_flagship(*, channels=128, num_buoys=8, block_len=16_384,
                   sample_rate_hz=2_400_000.0, max_lag=512, iters=20):
    from radio_mapper_tpu.models.pipeline import PipelineConfig, TDOAPipeline

    cfg = PipelineConfig(
        num_buoys=num_buoys, block_len=block_len, sample_rate_hz=sample_rate_hz,
        max_lag=max_lag, max_peaks=8, solver_iterations=25,
    )
    pipe = TDOAPipeline(cfg)
    buoys = ring_buoys(num_buoys)
    raws, anchors, emitters = [], [], []
    for c in range(channels):
        scen = sim.default_scenario(
            signal="noise", bandwidth_hz=150e3, snr_db=25.0, seed=1000 + c,
            sample_rate_hz=sample_rate_hz, block_len=block_len, buoys=buoys,
            emitter_lat=CENTER[0] + 0.02, emitter_lng=CENTER[1] - 0.02,
        )
        cap = sim.synthesize(scen)
        raws.append(sim.to_uint8(cap))
        anchors.append(cap.buoy_enu)
        emitters.append(cap.emitter_enu[0])
    raw = np.stack(raws)
    anchors = np.stack(anchors).astype(np.float32)
    emitters = np.stack(emitters)
    log(f"flagship: {channels} ch x {num_buoys} buoys x {block_len} samples @ "
        f"{sample_rate_hz / 1e6:g} MS/s, uint8 input {raw.nbytes / 1e6:.1f} MB/block, "
        f"max_lag {max_lag}")

    step = pipe.jit_step_split_uint8()
    args = (jax.device_put(raw), jax.device_put(anchors))
    t0 = time.perf_counter()
    compiled = step.lower(*args).compile()
    log(f"flagship: compile {time.perf_counter() - t0:.2f} s; memory: {memory_summary(compiled)}")
    step_ms = median_step_ms(compiled, args, iters)
    real_ms = block_len / sample_rate_hz * 1e3
    log(f"flagship: median step {step_ms:.3f} ms over {iters} steps "
        f"(block real time {real_ms:.3f} ms; informative, not a benchmark cell)")

    ref = golden.gcc_phat_all_pairs_numpy(
        iq_ops.decode_uint8_iq_numpy(raw), max_lag=max_lag, eps=cfg.gcc_eps
    )

    def check(out, label):
        fix = np.asarray(out.fix.position_enu)
        lags = np.asarray(out.correlation.lag_samples)
        if fix.shape != (channels, 3) or lags.shape != (channels, cfg.num_pairs):
            raise AssertionError(f"flagship shapes {fix.shape} {lags.shape}")
        if not (np.isfinite(fix).all() and np.isfinite(lags).all()):
            raise AssertionError("flagship: non-finite outputs")
        tau = tau_check(f"flagship [{label}]", lags, ref, max_lag=max_lag)
        err = np.linalg.norm(fix[:, :2] - emitters[:, :2], axis=-1)
        log(f"flagship [{label}]: fix error worst {err.max():.2f} m, median "
            f"{np.median(err):.2f} m (bound {FLAGSHIP_FIX_BOUND_M:g} m)")
        if err.max() > FLAGSHIP_FIX_BOUND_M:
            raise AssertionError(f"flagship fix error {err.max()} m")
        return tau, float(err.max())

    run_precisions(step, args, check)
    return step_ms


def phase_wideband(config=None, *, active=5, iters=10):
    from radio_mapper_tpu.models.wideband import WidebandConfig, WidebandTDOAPipeline
    from radio_mapper_tpu.ops import split_complex as sc_ops

    cfg = config or WidebandConfig()
    pipe = WidebandTDOAPipeline(cfg)
    b = cfg.num_buoys
    ang = 2 * np.pi * np.arange(b) / b
    anchors = np.stack(
        [9_000 * np.cos(ang), 9_000 * np.sin(ang), np.zeros(b)], axis=-1
    ).astype(np.float32)
    emitter = np.array([1_500.0, -2_200.0, 0.0])
    re, im = sim.synthesize_wideband(
        cfg, active_subchannel=active, anchors_enu=anchors, emitter_enu=emitter,
        snr_db=25.0, seed=1,
    )
    log(f"wideband: {b} buoys x {cfg.wide_rate_hz / 1e6:g} MS/s, "
        f"{cfg.num_subchannels} subchannels, {cfg.num_pairs} pairs, "
        f"emitter in subchannel {active}")
    step = pipe.jit_step_split()
    args = tuple(jax.device_put(a) for a in (re, im, anchors))
    t0 = time.perf_counter()
    compiled = step.lower(*args).compile()
    log(f"wideband: compile {time.perf_counter() - t0:.2f} s; memory: {memory_summary(compiled)}")
    step_ms = median_step_ms(compiled, args, iters)
    log(f"wideband: median step {step_ms:.3f} ms over {iters} steps "
        f"(block real time {cfg.wide_block / cfg.wide_rate_hz * 1e3:.3f} ms; informative)")

    # The golden correlates the same subchannel signals the step does.
    channelize = jax.jit(lambda a, c: sc_ops.channelize_split(
        a, c, cfg.num_subchannels, sample_rate_hz=cfg.wide_rate_hz,
        taps_per_channel=cfg.taps_per_channel, shift=False,
    ))
    cre, cim = channelize(args[0], args[1])
    sub = np.asarray(cre)[:, active, :] + 1j * np.asarray(cim)[:, active, :]
    ref = golden.gcc_phat_all_pairs_numpy(sub, max_lag=cfg.max_lag, eps=cfg.gcc_eps)

    def check(out, label):
        lags = np.asarray(out.lags)
        fixes = np.asarray(out.fixes_enu)
        if lags.shape != (cfg.num_subchannels, cfg.num_pairs):
            raise AssertionError(f"wideband lags shape {lags.shape}")
        if not np.isfinite(lags).all():
            raise AssertionError("wideband: non-finite lags")
        tau = tau_check(f"wideband [{label}] subchannel {active}", lags[active], ref,
                        max_lag=cfg.max_lag)
        err = float(np.linalg.norm(fixes[active, :2] - emitter[:2]))
        log(f"wideband [{label}]: active-subchannel fix error {err:.2f} m "
            f"(bound {WIDEBAND_FIX_BOUND_M:g} m)")
        if err > WIDEBAND_FIX_BOUND_M:
            raise AssertionError(f"wideband fix error {err} m")
        return tau, err

    run_precisions(step, args, check)
    return step_ms


def phase_simulate(backend: str = "gpu", extra=()):
    from radio_mapper_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["--backend", backend, "simulate", *extra])
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"simulate: {line}")
    err = float(next(l for l in text.splitlines() if l.startswith("error:")).split()[1])
    if not err < SIMULATE_FIX_BOUND_M:
        raise AssertionError(f"simulate fix error {err} m")
    return err


def _agreement(label, a, b, bound):
    d = float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))
    log(f"{label}: max |sharded - one card| = {d:.3e} (bound {bound:g})")
    if not d <= bound:
        raise AssertionError(f"{label}: sharded and one-card results differ by {d}")
    return d


def _on_devices(x, n: int, label: str):
    got = len({s.device for s in x.addressable_shards})
    if got != n:
        raise AssertionError(f"{label}: shards on {got} devices, expected {n}")


def _split_over(x, axis: int, parts: int, label: str):
    """``x``'s shards cut its ``axis`` into ``parts`` distinct slices."""
    starts = {s.index[axis].start or 0 for s in x.addressable_shards}
    widths = {s.data.shape[axis] for s in x.addressable_shards}
    if len(starts) != parts or widths != {x.shape[axis] // parts}:
        raise AssertionError(f"{label}: axis {axis} in slices at {sorted(starts)} "
                             f"of widths {sorted(widths)}, expected {parts}")


def phase_config5(devices, *, num_channels=256, block_len=16_384):
    """Over ch=n x blk=1 (channels split, no exchange) and, for even n,
    ch=n/2 x blk=2 (time split: the halo ``ppermute`` crosses cards), each
    against :func:`sharded.reference_step_split` on the first card."""
    from radio_mapper_tpu.parallel import mesh as mesh_lib
    from radio_mapper_tpu.parallel.sharded import (
        ShardedStepConfig, build_sharded_step_split, reference_step_split,
    )

    n = len(devices)
    cfg = ShardedStepConfig(
        num_channels=num_channels, num_buoys=8, num_subchannels=16,
        sample_rate_hz=2_400_000.0, max_lag=32, taps_per_channel=4,
        solver_iterations=6,
    )
    re = np.empty((num_channels, cfg.num_buoys, block_len), np.float32)
    im = np.empty_like(re)
    buoys = ring_buoys(cfg.num_buoys)
    for c in range(num_channels):
        cap = sim.synthesize(sim.default_scenario(
            signal="noise", bandwidth_hz=cfg.sample_rate_hz, snr_db=20.0,
            seed=2000 + c, sample_rate_hz=cfg.sample_rate_hz, block_len=block_len,
            buoys=buoys,
        ))
        re[c], im[c] = cap.iq.real, cap.iq.imag
    anchors = cap.buoy_enu.astype(np.float32)
    log(f"config-5: {num_channels} ch x {cfg.num_buoys} buoys x "
        f"{cfg.num_subchannels} subchannels, {block_len} samples/ch, max_lag "
        f"{cfg.max_lag}")

    def run(shape):
        mesh = mesh_lib.make_mesh(shape, ("ch", "blk"), devices=devices)
        step, sh = build_sharded_step_split(mesh, cfg)
        args = (jax.device_put(re, sh[0]), jax.device_put(im, sh[1]),
                jax.device_put(anchors, sh[2]))
        _on_devices(args[0], n, f"config-5 {shape} input")
        _split_over(args[0], 0, shape[0], f"config-5 {shape} input")
        _split_over(args[0], 2, shape[1], f"config-5 {shape} input")
        t0 = time.perf_counter()
        out = jax.block_until_ready(step(*args))
        log(f"config-5 on {n} device(s), mesh ch={shape[0]} x blk={shape[1]}: "
            f"compile+first {time.perf_counter() - t0:.2f} s")
        _on_devices(out.lags, n, f"config-5 {shape} lags")
        return out

    def reference(time_shards):
        t0 = time.perf_counter()
        out = jax.block_until_ready(reference_step_split(
            cfg, re, im, anchors, time_shards=time_shards, device=devices[0]))
        log(f"config-5 on 1 device(s), {time_shards} time segment(s): "
            f"compile+first {time.perf_counter() - t0:.2f} s")
        return out

    shapes = [(n, 1)] + ([(n // 2, 2)] if n % 2 == 0 else [])
    for label in PRECISIONS:
        for shape in shapes:
            with matmul_precision(label):
                out_n = run(shape)
                out_1 = reference(shape[1])
            tag = f"config-5 [{label}] ch={shape[0]} x blk={shape[1]}"
            _agreement(f"{tag} lags (samples)", out_n.lags, out_1.lags, 1e-2)
            _agreement(f"{tag} fixes (m)", out_n.fixes_enu, out_1.fixes_enu, 1.0)


def phase_pair_ep(devices, *, side=8, block_len=4096):
    from jax.sharding import Mesh

    from radio_mapper_tpu.parallel.pair_ep import PairEPConfig, build_pair_ep_step

    n = len(devices)
    scen = sim.default_scenario(
        block_len=block_len, snr_db=25.0, seed=11, bandwidth_hz=500e3,
        buoys=grid_buoys(side),
    )
    cap = sim.synthesize(scen)
    cfg = PairEPConfig(
        num_buoys=side * side, block_len=block_len,
        sample_rate_hz=scen.sample_rate_hz, max_lag=256,
    )
    log(f"pair EP: {cfg.num_buoys} buoys, {cfg.num_pairs} pairs, {block_len} "
        f"samples; mesh pair={n}")

    def run(devs):
        step, sh, pairs = build_pair_ep_step(Mesh(np.array(devs), ("pair",)), cfg)
        args = (jax.device_put(cap.iq.real.astype(np.float32), sh[0]),
                jax.device_put(cap.iq.imag.astype(np.float32), sh[1]),
                jax.device_put(cap.buoy_enu.astype(np.float32), sh[2]))
        t0 = time.perf_counter()
        out = jax.block_until_ready(step(*args))
        log(f"pair EP on {len(devs)} device(s): compile+first {time.perf_counter() - t0:.2f} s")
        return args, out, len(pairs[0])

    args4, out4, p = run(list(devices))
    _on_devices(args4[0], n, "pair EP input")
    _on_devices(out4.lags, n, "pair EP lags")
    _, out1, _ = run(list(devices[:1]))
    _agreement("pair EP lags (samples)", np.asarray(out4.lags)[:p], np.asarray(out1.lags)[:p], 1e-2)
    _agreement("pair EP fix (m)", out4.fix_enu, out1.fix_enu, 1.0)
    err = float(np.linalg.norm(np.asarray(out4.fix_enu)[:2] - cap.emitter_enu[0][:2]))
    log(f"pair EP: fix error {err:.2f} m")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--devices", type=int, default=1,
                   help="N > 1: run only the sharded paths on N GPUs")
    args = p.parse_args(argv)

    from radio_mapper_tpu.utils.device import enable_compile_cache

    devices = phase_device()
    log(f"compile cache: {enable_compile_cache()}")
    if args.devices > 1:
        if len(devices) < args.devices:
            raise RuntimeError(f"--devices {args.devices}: JAX sees {len(devices)}")
        phase_config5(devices[: args.devices])
        phase_pair_ep(devices[: args.devices])
    else:
        phase_flagship()
        phase_wideband()
        phase_simulate()
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
