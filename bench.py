"""Benchmark: full-pipeline IQ throughput on one GPU.

Runs the flagship TDOA pipeline (batched PSD detect → all-pairs GCC-PHAT →
LM solve) on the GPU and prints ONE JSON line:

    {"metric": "iq_samples_per_s_per_chip", "value": ...,
     "real_time_ratio": ..., "fft_ms_per_s": ..., "pairs_per_s": ...,
     "step_ms": ..., "path": ..., "device": {...}}

``real_time_ratio`` > 1 means the card keeps up with the headline channel
count's aggregate sample rate (channels × 8 buoys × 2.4 MS/s) with the
full detection + correlation + solve stack running, not just the FFTs.

Methodology:
- every timing is an epoch of ``iters`` chained dispatches closed by
  ``jax.block_until_ready`` on the outputs, elapsed/iters; several epochs
  per config, the MEDIAN is the headline (best epoch kept as a secondary
  field) and the spread is printed to stderr as a variance check;
- ``flops_per_block`` is XLA's own cost analysis of the compiled step.
  No peak rate is assumed for any device;
- kernel microbenches: forward-FFT samples/s and GCC pairs/s isolate the
  two hot stages from the end-to-end number.

The bench needs a GPU and fails without one. (For context, the
reference's per-node Python detector processes 16384 samples every ~2 s
≈ 8 kS/s — `buoy_node.py:364,220`.)
"""

from __future__ import annotations

import json
import sys
import time

import jax
import numpy as np

# Real-time rate of one channel: 8 buoys × 2.4 MS/s.
CHANNEL_SAMPLES_PER_S = 8 * 2_400_000.0


def _log(msg: str):
    print(f"# {msg}", file=sys.stderr)


def _build(num_channels, num_buoys, block_len, sample_rate_hz, max_lag):
    from radio_mapper_tpu.models.pipeline import PipelineConfig, TDOAPipeline

    return TDOAPipeline(
        PipelineConfig(
            num_buoys=num_buoys,
            block_len=block_len,
            sample_rate_hz=sample_rate_hz,
            max_lag=max_lag,
            max_peaks=8,
            solver_iterations=25,
        )
    )


def _epoch_time(step, args, *, iters: int, warmup: int = 2) -> float:
    """Per-step wall time: ``iters`` dispatches closed by one wait on
    all outputs, elapsed/iters. Executions serialize on the device, so
    elapsed/iters is the steady-state throughput.
    """
    for _ in range(max(warmup, 1)):
        out = step(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    outs = [step(*args) for _ in range(iters)]
    jax.block_until_ready(outs)
    return (time.perf_counter() - t0) / iters


def _median_epoch_time(step, args, *, iters: int, epochs: int = 3) -> float:
    """Median of several epochs (compile amortized once)."""
    ts = [_epoch_time(step, args, iters=iters, warmup=2 if k == 0 else 1)
          for k in range(epochs)]
    return sorted(ts)[len(ts) // 2]


def _program_flops(step, args) -> float:
    """FLOPs per step from XLA's cost analysis (0.0 if unavailable)."""
    try:
        compiled = jax.jit(step).lower(*args).compile()
        analysis = compiled.cost_analysis()
        if isinstance(analysis, (list, tuple)):
            analysis = analysis[0]
        return float(analysis.get("flops", 0.0))
    except Exception as e:
        _log(f"cost_analysis unavailable ({e})")
        return 0.0


def build_pipeline_step(
    *,
    num_channels: int = 32,
    num_buoys: int = 8,
    block_len: int = 16_384,
    sample_rate_hz: float = 2_400_000.0,
    max_lag: int = 512,
    path: str = "auto",  # auto | split | complex
    scan_blocks: int = 1,
):
    """Compile ONE step and reuse it for every epoch. Returns
    (name, compiled_step, args, flops_per_step).

    ``scan_blocks=K > 1`` compiles the K-block `lax.scan` program
    (pipeline.step_split_scan): one dispatch covers K blocks, amortizing
    the per-dispatch cost. FLOPs returned are PER BLOCK.
    """
    pipe = _build(num_channels, num_buoys, block_len, sample_rate_hz, max_lag)
    re, im, anchors = pipe.example_inputs(batch=(num_channels,), seed=0, split=True)
    if scan_blocks > 1:
        if path == "complex":
            raise ValueError("scan_blocks supports the split path only")
        # Copy ONE block to the device and materialize the K-block stack
        # there (at 256 ch × K=16 the stack is ~4.3 GB). The duplicated
        # blocks don't change the (data-independent) timing.
        import jax.numpy as jnp

        re1, im1 = jax.device_put((re, im))
        tile = jax.jit(
            lambda a: jnp.broadcast_to(a, (scan_blocks, *a.shape)) * 1.0
        )
        name = f"split-scan{scan_blocks}"
        anchors = jax.device_put(anchors)
        return (
            name,
            pipe.jit_step_split_scan(),
            (tile(re1), tile(im1), anchors),
            _program_flops(pipe.step_split, (re1, im1, anchors)),
        )

    attempts = []
    if path in ("auto", "split"):
        attempts.append(("split", pipe.step_split, pipe.jit_step_split(), (re, im, anchors)))
    if path in ("auto", "complex"):
        iq = jax.lax.complex(re, im)
        attempts.append(("complex", pipe.step, pipe.jit_step(), (iq, anchors)))

    last_err = None
    for name, raw_fn, step, args in attempts:
        try:
            args = jax.device_put(args)
            t0 = time.perf_counter()
            out = step(*args)
            jax.block_until_ready(out)
            _log(f"path {name!r}: compile+first {time.perf_counter()-t0:.1f}s")
            return name, step, args, _program_flops(raw_fn, args)
        except Exception as e:  # try the next path
            last_err = e
            _log(f"bench path {name!r} failed: {e}")
    raise RuntimeError(f"all bench paths failed: {last_err}")


def run_pipeline_bench(
    *,
    num_channels: int = 32,
    iters: int = 10,
    **kwargs,
):
    """Single-shot convenience: build + one timed epoch."""
    num_buoys = kwargs.get("num_buoys", 8)
    block_len = kwargs.get("block_len", 16_384)
    name, step, args, flops = build_pipeline_step(
        num_channels=num_channels, **kwargs
    )
    step_s = _epoch_time(step, args, iters=iters, warmup=0)
    rate = num_channels * num_buoys * block_len / step_s
    return rate, name, step_s, flops


def run_fft_microbench(*, rows: int = 256, n: int = 16_384, iters: int = 50) -> float:
    """Forward split-complex FFT throughput (complex samples/s)."""
    from radio_mapper_tpu.ops import fft as fft_ops

    rng = np.random.default_rng(0)
    re = jax.device_put(rng.normal(size=(rows, n)).astype(np.float32))
    im = jax.device_put(rng.normal(size=(rows, n)).astype(np.float32))
    step = jax.jit(fft_ops.fft_re_im)
    dt = _median_epoch_time(step, (re, im), iters=iters)
    return rows * n / dt


def run_gcc_microbench(
    *, channels: int = 32, num_buoys: int = 8, n: int = 16_384, max_lag: int = 512,
    iters: int = 50, scan_blocks: int = 64,
) -> float:
    """All-pairs GCC-PHAT throughput (pair correlations/s).

    Scan-amortized (``scan_blocks`` blocks per dispatch) with the SAME
    methodology as :func:`run_ep_microbench`, so the two pairs/s numbers
    in the JSON are directly comparable. The depth is not yet measured
    on the GPU."""
    import functools

    import jax.numpy as jnp

    from radio_mapper_tpu.ops import split_complex as sc_ops

    rng = np.random.default_rng(0)
    re = jax.device_put(rng.normal(size=(channels, num_buoys, n)).astype(np.float32))
    im = jax.device_put(rng.normal(size=(channels, num_buoys, n)).astype(np.float32))
    base = functools.partial(
        sc_ops.gcc_phat_all_pairs_split, sample_rate_hz=2_400_000.0, max_lag=max_lag
    )
    pairs = num_buoys * (num_buoys - 1) // 2
    if scan_blocks > 1:
        k = scan_blocks
        tile = jax.jit(lambda a: jnp.broadcast_to(a, (k, *a.shape)) * 1.0)
        reK, imK = tile(re), tile(im)

        @jax.jit
        def scan_step(rK, iK):
            return jax.lax.scan(lambda c, x: (c, base(x[0], x[1])), 0, (rK, iK))[1]

        dt = _median_epoch_time(scan_step, (reK, imK), iters=iters) / k
    else:
        dt = _median_epoch_time(jax.jit(base), (re, im), iters=iters)
    return channels * pairs / dt


def run_ep_microbench(
    *, num_buoys: int = 64, block_len: int = 4096, max_lag: int = 256,
    iters: int = 20, scan_blocks: int = 64,
) -> float:
    """Pair-EP step throughput: 64 receivers → 2016 pairs on a 1-device
    "pair" mesh (the 8-device CPU mesh in tests/test_pair_ep.py is the
    shape-truth side). ``scan_blocks`` folds K consecutive blocks into
    one dispatch, so the rate is the amortized steady state."""
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from radio_mapper_tpu.parallel.pair_ep import PairEPConfig, build_pair_ep_step

    cfg = PairEPConfig(
        num_buoys=num_buoys, block_len=block_len, max_lag=max_lag,
        solver_iterations=10,
    )
    mesh = Mesh(np.array(jax.devices()[:1]), ("pair",))
    step, shardings, (pi, _pj) = build_pair_ep_step(mesh, cfg)
    rng = np.random.default_rng(0)
    re = jax.device_put(
        rng.normal(size=(num_buoys, block_len)).astype(np.float32), shardings[0]
    )
    im = jax.device_put(
        rng.normal(size=(num_buoys, block_len)).astype(np.float32), shardings[1]
    )
    anchors = rng.normal(scale=5_000.0, size=(num_buoys, 3)).astype(np.float32)
    anchors[:, 2] = 0.0
    anchors = jax.device_put(anchors, shardings[2])
    if scan_blocks > 1:
        k = scan_blocks
        tile = jax.jit(lambda a: jnp.broadcast_to(a, (k, *a.shape)) * 1.0)
        reK, imK = tile(re), tile(im)

        @jax.jit
        def scan_step(rK, iK, anc):
            return jax.lax.scan(
                lambda c, x: (c, step(x[0], x[1], anc)), 0, (rK, iK)
            )[1]

        dt = _median_epoch_time(scan_step, (reK, imK, anchors), iters=iters) / k
    else:
        dt = _median_epoch_time(step, (re, im, anchors), iters=iters)
    return len(pi) / dt


def run_wideband_bench(*, iters: int = 10, scan_blocks: int = 64):
    """BASELINE config 4 for real: 64 buoys × 10 MS/s wideband → 16-way
    polyphase channelizer → per-subchannel all-pairs GCC-PHAT (2016
    pairs) → LM solve, one card, one jitted program.
    ``scan_blocks`` folds K blocks per dispatch (same amortization as the
    flagship; the 33 MB/block input stack makes depth cheap).
    Returns (ms_per_block, wide_samples_per_s, pairs_per_s)."""
    import jax.numpy as jnp

    from radio_mapper_tpu.models.wideband import WidebandConfig, WidebandTDOAPipeline

    cfg = WidebandConfig()
    pipe = WidebandTDOAPipeline(cfg)
    re, im, anchors = jax.device_put(pipe.example_inputs(seed=0))
    if scan_blocks > 1:
        k = scan_blocks
        tile = jax.jit(lambda a: jnp.broadcast_to(a, (k, *a.shape)) * 1.0)
        args = (tile(re), tile(im), anchors)

        @jax.jit
        def step(rK, iK, anc):
            return jax.lax.scan(
                lambda c, x: (c, pipe.step_split(x[0], x[1], anc)), 0, (rK, iK)
            )[1]
    else:
        k = 1
        args = (re, im, anchors)
        step = pipe.jit_step_split()
    t0 = time.perf_counter()
    jax.block_until_ready(step(*args))
    _log(f"wideband config-4 compile+first {time.perf_counter()-t0:.1f}s")
    dt = _epoch_time(step, args, iters=iters, warmup=1) / k
    wide_rate = cfg.num_buoys * cfg.wide_block / dt
    pair_rate = cfg.num_subchannels * cfg.num_pairs / dt
    return dt * 1e3, wide_rate, pair_rate


def run_ingest_bench(
    *, channels: int = 32, num_buoys: int = 8, block_len: int = 16_384,
    sample_rate_hz: float = 2_400_000.0, max_lag: int = 512, steps: int = 30,
    blocks_per_dispatch: int = 1, overdrive: float = 1.0,
):
    """Ingest-closed sustained throughput: native ring → double-buffered
    host→HBM uint8 upload → jitted step, paced at REAL TIME for the
    benched channel count (channels × buoys × sample_rate). Returns the
    IngestLoopStats; drops == 0 means the pipeline kept up with the
    virtual SDR clock (`rtl_test.c:109-135` criterion)."""
    from radio_mapper_tpu.ingest.native import NativeIngest
    from radio_mapper_tpu.ingest.runner import IngestLoop

    pipe = _build(channels, num_buoys, block_len, sample_rate_hz, max_lag)
    rng = np.random.default_rng(0)
    anchors = rng.normal(scale=8_000.0, size=(num_buoys, 3)).astype(np.float32)
    anchors[:, 2] = 0.0
    anchors = jax.device_put(
        np.ascontiguousarray(np.broadcast_to(anchors, (channels, num_buoys, 3)))
    )
    rate_samples = channels * num_buoys * sample_rate_hz
    # Multi-block dispatches use the lax.scan program (r4): the
    # [K, ch, B, 2N] block stack IS the scan input, one dispatch covers K
    # blocks of budget with the block body compiled once.
    step = (
        pipe.jit_step_split_uint8_scan()
        if blocks_per_dispatch > 1
        else pipe.jit_step_split_uint8()
    )
    loop = IngestLoop(
        step, None,
        channels=channels, num_buoys=num_buoys, block_len=block_len,
        anchors=anchors, source_samples_per_s=rate_samples,
        blocks_per_dispatch=blocks_per_dispatch,
    )
    t0 = time.perf_counter()
    loop.warm_compile()
    _log(f"ingest u8-step compile+first {time.perf_counter()-t0:.1f}s")
    # ring sized for ~8 dispatches of headroom
    # ``overdrive`` paces the virtual SDR clock FASTER than nominal: a
    # nominal-paced source caps the measurable ratio at 1.0 (the consumer
    # cannot outrun production), so drops==0 at overdrive×nominal is how
    # ">1× real time with headroom" is actually demonstrated. The
    # reported real_time_ratio stays relative to the NOMINAL rate.
    block_bytes = blocks_per_dispatch * channels * num_buoys * 2 * block_len
    ring = 1 << max(24, (block_bytes * 8).bit_length())
    ing = NativeIngest.open_synthetic_paced(
        seed=1, bytes_per_s=overdrive * 2.0 * rate_samples, ring_bytes=ring
    )
    loop.ingest = ing
    try:
        return loop.run(num_steps=steps, warmup_steps=0)
    finally:
        ing.close()


def run_ingest_loopback_bench(
    *, channels: int = 32, num_buoys: int = 8, block_len: int = 16_384,
    sample_rate_hz: float = 2_400_000.0, steps: int = 60,
    drain_threads: int = 4,
):
    """Host-ingest loopback.

    Proves the REPO-OWNED ingest leg — paced ring → parallel C++ drain
    into a pre-allocated slot → device_put — sustains the 32-channel
    flagship byte stream (1.23 GB/s of uint8) with zero drops, on the
    local CPU device so no device-link cost enters. The device step is a
    trivial decode+reduce: the full pipeline's compute belongs to the
    GPU benches above; this isolates the host leg.
    """
    import jax.numpy as jnp

    from radio_mapper_tpu.ingest.native import NativeIngest
    from radio_mapper_tpu.ingest.runner import IngestLoop

    cpu = jax.devices("cpu")[0]
    put = lambda x: jax.device_put(x, cpu)

    def consume(raw, _anchors):
        # a sparse probe-read of the device buffer: device_put already
        # copied every byte (the handoff under test); a full CPU reduce
        # would just burn the same cores the drain needs
        return jnp.sum(raw[..., ::4097].astype(jnp.float32))

    step = jax.jit(consume)
    anchors = put(np.zeros((1,), np.float32))
    rate_samples = channels * num_buoys * sample_rate_hz
    loop = IngestLoop(
        step, None,
        channels=channels, num_buoys=num_buoys, block_len=block_len,
        anchors=anchors, source_samples_per_s=rate_samples,
        device_put=put, drain_threads=drain_threads,
    )
    loop.warm_compile()
    block_bytes = channels * num_buoys * 2 * block_len
    # 32 blocks (~220 ms at the 32-ch rate) of ring: an 8-block ring
    # dropped on transient scheduler stalls (~80 MB once in 3 runs);
    # real-time-ness is judged by sustained drain, buffered slack is free
    ring = 1 << max(24, (block_bytes * 32).bit_length())
    ing = NativeIngest.open_synthetic_paced(
        seed=2, bytes_per_s=2.0 * rate_samples, ring_bytes=ring,
        chunk_bytes=1 << 18,
    )
    loop.ingest = ing
    try:
        return loop.run(num_steps=steps, warmup_steps=0)
    finally:
        ing.close()


def main():
    import os

    from radio_mapper_tpu.utils.device import enable_compile_cache, require_gpu

    devices = require_gpu()
    enable_compile_cache()

    # Host-leg proof FIRST, before the GPU sections run in this process,
    # so its numbers reflect the drain, not process history.
    loopback = None
    try:
        loopback = run_ingest_loopback_bench()
        _log(
            f"ingest loopback 32ch (host only): "
            f"{loopback.sustained_samples_per_s*2/1e9:.2f} GB/s "
            f"({loopback.real_time_ratio:.2f}x real time), "
            f"dropped_bytes={loopback.dropped_bytes}, "
            f"host {loopback.host_read_ms_per_step:.2f} ms/step"
        )
    except Exception as e:
        _log(f"ingest loopback bench failed: {e}")

    # Channel-count sweep over K-block lax.scan programs: one dispatch
    # covers K blocks, amortizing the per-dispatch cost. Each config
    # compiles once; headline = TRIMMED median over 5 epochs (epochs
    # slower than 2× the fastest are discarded). Scan depth 64 and the
    # 256-channel clamp (16) keep the input stacks ≤ 8.6 GB of f32
    # planes; neither depth is measured on the GPU yet.
    scan_k = int(os.environ.get("BENCH_SCAN_BLOCKS", "64"))
    best = {"rate": 0.0}
    for ch in (64, 128, 256):
        ch_scan = min(scan_k, 16) if ch >= 256 else min(scan_k, 64)
        try:
            path, step, args, flops = build_pipeline_step(
                num_channels=ch, scan_blocks=ch_scan
            )
        except Exception as e:
            _log(f"bench channels={ch} failed entirely: {e}")
            continue
        samples = ch_scan * ch * 8 * 16_384
        epochs = []
        for epoch in range(5):
            step_s = _epoch_time(
                step, args, iters=15, warmup=3 if epoch == 0 else 1
            )
            epochs.append((samples / step_s, step_s / ch_scan))
        epochs.sort()
        spread = (epochs[-1][0] - epochs[0][0]) / epochs[len(epochs) // 2][0]
        kept = [e for e in epochs if e[1] <= 2.0 * epochs[-1][1]]
        rate, blk_s = kept[len(kept) // 2]
        rate_best = epochs[-1][0]
        _log(
            f"channels={ch} x{ch_scan}blk: epoch spread {spread*100:.1f}%, "
            f"kept {len(kept)}/{len(epochs)}"
        )
        _log(
            f"channels={ch}: trimmed median {rate/1e6:.1f} MS/s "
            f"(best {rate_best/1e6:.1f}, path={path}, {blk_s*1e3:.2f} ms/block)"
        )
        if rate > best["rate"]:
            best = {
                "rate": rate, "rate_best": rate_best, "path": path,
                "step_s": blk_s, "flops": flops, "channels": ch,
            }

    fft_rate = 0.0
    gcc_rate = 0.0
    try:
        fft_rate = run_fft_microbench()
        _log(f"fft microbench: {fft_rate/1e6:.1f} M complex samples/s")
    except Exception as e:
        _log(f"fft microbench failed: {e}")
    try:
        gcc_rate = run_gcc_microbench()
        _log(f"gcc microbench: {gcc_rate:.0f} pair correlations/s (scan-64 amortized)")
    except Exception as e:
        _log(f"gcc microbench failed: {e}")

    ep_rate = 0.0
    try:
        ep_rate = run_ep_microbench()
        _log(
            f"ep microbench: {ep_rate:.0f} EP pairs/s "
            "(64 buoys / 2016 pairs, scan-64 amortized)"
        )
    except Exception as e:
        _log(f"ep microbench failed: {e}")

    wb = None
    try:
        wb = run_wideband_bench()
        _log(
            f"wideband config-4: {wb[0]:.1f} ms/block = {wb[1]/1e6:.1f} wide MS/s "
            f"(64 buoys x 10 MS/s), {wb[2]/1e3:.0f}k pairs/s"
        )
    except Exception as e:
        _log(f"wideband config-4 bench failed: {e}")

    # Ingest-closed sustained run: real-time pace for the benched channel
    # count; step down the ladder 32 → 8 → 1 until the loop keeps up.
    ingest = None
    ingest_channels = None
    ladder = [c for c in (32, 8, 1) if c <= min(best.get("channels") or 32, 32)]
    for try_channels in ladder:
        try:
            st = run_ingest_bench(channels=try_channels)
            _log(
                f"ingest {try_channels}ch: {st.sustained_samples_per_s/1e6:.1f} MS/s "
                f"sustained ({st.real_time_ratio:.2f}x real time), "
                f"dropped_bytes={st.dropped_bytes}, "
                f"host {st.host_read_ms_per_step:.2f} ms + put {st.transfer_ms_per_step:.2f} ms /step"
            )
            ingest = st
            ingest_channels = try_channels
            if st.dropped_bytes == 0 and st.real_time_ratio >= 0.95:
                break
        except Exception as e:
            _log(f"ingest bench {try_channels}ch failed: {e}")
    ingest_bpd = 1
    if ingest is None or ingest.real_time_ratio < 0.95:
        # Dispatch amortization: one more attempt at 1 ch with 8 blocks
        # per lax.scan dispatch, paced at 1.3x nominal — drops==0 there
        # demonstrates real time with headroom.
        try:
            st = run_ingest_bench(channels=1, blocks_per_dispatch=8,
                                  overdrive=1.3)
            _log(
                f"ingest 1ch x8blk-scan @1.3x pace: "
                f"{st.sustained_samples_per_s/1e6:.1f} MS/s "
                f"({st.real_time_ratio:.2f}x nominal), "
                f"dropped_bytes={st.dropped_bytes}"
            )
            if ingest is None or st.real_time_ratio > ingest.real_time_ratio:
                ingest, ingest_channels, ingest_bpd = st, 1, 8
        except Exception as e:
            _log(f"ingest 1ch x8blk failed: {e}")

    value = best["rate"]
    print(
        json.dumps(
            {
                "metric": "iq_samples_per_s_per_chip",
                "value": round(float(value), 1),  # median-of-epochs
                "value_best_epoch": round(float(best.get("rate_best", 0.0)), 1),
                "unit": "samples/s/chip",
                "real_time_ratio": (
                    round(value / (best["channels"] * CHANNEL_SAMPLES_PER_S), 4)
                    if value else None
                ),
                "channels": best.get("channels"),
                "flops_per_block": best.get("flops"),
                "fft_ms_per_s": round(fft_rate / 1e6, 1),
                # both pair metrics are scan-amortized steady-state rates
                "pairs_per_s": round(gcc_rate, 1),
                "ep_pairs_per_s": round(ep_rate, 1),
                "ingest_channels": ingest_channels if ingest else None,
                "ingest_blocks_per_dispatch": ingest_bpd if ingest else None,
                "ingest_sustained_ms_per_s": (
                    round(ingest.sustained_samples_per_s / 1e6, 1) if ingest else None
                ),
                "ingest_real_time_ratio": (
                    round(ingest.real_time_ratio, 3) if ingest else None
                ),
                # BYTES of ring overflow (2 bytes = one I/Q sample)
                "ingest_dropped_bytes": ingest.dropped_bytes if ingest else None,
                "ingest_host_ms_per_step": (
                    round(ingest.host_read_ms_per_step, 3) if ingest else None
                ),
                "ingest_transfer_ms_per_step": (
                    round(ingest.transfer_ms_per_step, 3) if ingest else None
                ),
                "ingest_loopback_gb_per_s": (
                    round(loopback.sustained_samples_per_s * 2 / 1e9, 3)
                    if loopback else None
                ),
                "ingest_loopback_dropped_bytes": (
                    loopback.dropped_bytes if loopback else None
                ),
                "ingest_loopback_host_ms": (
                    round(loopback.host_read_ms_per_step, 3) if loopback else None
                ),
                "wideband_ms_per_block": round(wb[0], 2) if wb else None,
                "wideband_pairs_per_s": round(wb[2], 1) if wb else None,
                "step_ms": round(best.get("step_s", 0.0) * 1e3, 3),
                "path": best.get("path"),
                "device": {
                    "platform": devices[0].platform,
                    "kind": devices[0].device_kind,
                    "count": len(devices),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
