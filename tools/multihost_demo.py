"""Two-process multi-host run of the sharded streaming step (CPU mesh).

Proves docs/MULTIHOST.md is a working recipe, not prose (VERDICT r1
item 6 / BASELINE config 5): N processes each own a slice of a GLOBAL
device mesh, `jax.distributed.initialize` wires them together, and the
same `build_sharded_step_split` program runs over the global mesh with
each process feeding only its addressable shards — exactly how a real
multi-host GPU cluster is driven, with CPU devices standing in for cards.

Usage (the test launches this twice):

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \
    python tools/multihost_demo.py --process-id 0 --num-processes 2 &
    XLA_FLAGS=--xla_force_host_platform_device_count=4 \
    python tools/multihost_demo.py --process-id 1 --num-processes 2

Each process prints one JSON line with replicated checksums of the step
output; they must agree with each other AND with a single-process run of
the same config on the same global device count.
"""

from __future__ import annotations

import argparse
import json
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--coordinator", default="127.0.0.1:9898")
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument(
        "--config5", action="store_true",
        help="run the BASELINE config-5 north-star shape (256 channels × "
        "8 buoys, 16 subchannels @ 2.4 MS/s — docs/MULTIHOST.md recipe) "
        "instead of the toy config; block length scaled for CPU memory",
    )
    args = ap.parse_args()

    import jax

    # CPU mesh stands in for chips; must be selected before backends init.
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    try:
        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )
    except Exception as e:  # pragma: no cover — env without gloo support
        print(json.dumps({"unsupported": str(e)}))
        return 0

    import numpy as np

    from radio_mapper_tpu.parallel import mesh as mesh_lib
    from radio_mapper_tpu.parallel.sharded import (
        ShardedStepConfig,
        build_sharded_step_split,
    )

    devices = jax.devices()
    n = len(devices)
    assert n == args.num_processes * args.local_devices, (n, jax.local_devices())
    shape = mesh_lib.balanced_mesh_shape(n)
    mesh = mesh_lib.make_mesh(shape, ("ch", "blk"), devices=devices)

    if args.config5:
        # EXACTLY the docs/MULTIHOST.md:39-46 recipe (BASELINE configs[4]:
        # "256+ channels sharded across N≥2 hosts") — the full 256-channel
        # program structure; only the per-step sample count is scaled down
        # so the CPU stand-in devices finish in CI time (the program,
        # shardings, and collectives are identical at any block length).
        cfg = ShardedStepConfig(
            num_channels=256,
            num_buoys=8,
            num_subchannels=16,
            sample_rate_hz=2_400_000.0,
            max_lag=32,
            taps_per_channel=4,
            solver_iterations=8,
        )
    else:
        cfg = ShardedStepConfig(
            num_channels=max(2, shape[0]),
            num_buoys=4,
            num_subchannels=8,
            taps_per_channel=4,
            max_lag=12,
            solver_iterations=8,
        )
    step, in_shardings = build_sharded_step_split(mesh, cfg)

    # Deterministic GLOBAL inputs; every process materializes the full
    # array and the callback hands XLA only the local shard — the
    # pattern a per-host ingest ring would follow with real streams.
    s = mesh.shape["blk"]
    # config-5 needs ≥ (max_lag+4)·M + history samples per blk-shard so the
    # subchannel streams are longer than the correlation lag window.
    samples = s * (1024 if args.config5 else 256)
    rng = np.random.default_rng(0)
    g_re = rng.normal(size=(cfg.num_channels, cfg.num_buoys, samples)).astype(np.float32)
    g_im = rng.normal(size=(cfg.num_channels, cfg.num_buoys, samples)).astype(np.float32)
    g_anchors = rng.normal(scale=5_000.0, size=(cfg.num_buoys, 3)).astype(np.float32)
    g_anchors[:, 2] = 0.0

    mk = lambda g, sh: jax.make_array_from_callback(g.shape, sh, lambda idx: g[idx])
    re = mk(g_re, in_shardings[0])
    im = mk(g_im, in_shardings[1])
    anchors = mk(g_anchors, in_shardings[2])

    out = step(re, im, anchors)
    jax.block_until_ready(out)

    # Replicated checksums (jit reductions over sharded arrays insert the
    # cross-process collectives).
    checks = {
        "fix_sum": float(jax.jit(lambda a: a.sum())(out.fixes_enu)),
        "cost_sum": float(jax.jit(lambda a: a.sum())(out.cost)),
        "lag_sum": float(jax.jit(lambda a: a.sum())(out.lags)),
        "process": args.process_id,
        "global_devices": n,
        "num_channels": cfg.num_channels,
    }
    print(json.dumps(checks), flush=True)
    jax.distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
