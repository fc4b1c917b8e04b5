"""Two-process multi-host validation (VERDICT r1 item 6).

Launches tools/multihost_demo.py twice (4 virtual CPU devices each →
one 8-device GLOBAL mesh across two OS processes wired by
`jax.distributed.initialize`) and checks both processes' replicated
checksums agree with each other and with a single-process 8-device run
of the identical program — proving the docs/MULTIHOST.md recipe executes,
not just reads well.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _single_process_reference(config5: bool = False):
    import jax

    from radio_mapper_tpu.parallel import mesh as mesh_lib
    from radio_mapper_tpu.parallel.sharded import (
        ShardedStepConfig,
        build_sharded_step_split,
    )

    devices = jax.devices()[:8]
    shape = mesh_lib.balanced_mesh_shape(8)
    mesh = mesh_lib.make_mesh(shape, ("ch", "blk"), devices=devices)
    if config5:
        # must mirror tools/multihost_demo.py --config5 exactly
        cfg = ShardedStepConfig(
            num_channels=256, num_buoys=8, num_subchannels=16,
            sample_rate_hz=2_400_000.0, max_lag=32, taps_per_channel=4,
            solver_iterations=8,
        )
    else:
        cfg = ShardedStepConfig(
            num_channels=max(2, shape[0]), num_buoys=4, num_subchannels=8,
            taps_per_channel=4, max_lag=12, solver_iterations=8,
        )
    step, in_shardings = build_sharded_step_split(mesh, cfg)
    s = mesh.shape["blk"]
    samples = s * (1024 if config5 else 256)
    rng = np.random.default_rng(0)
    g_re = rng.normal(size=(cfg.num_channels, cfg.num_buoys, samples)).astype(np.float32)
    g_im = rng.normal(size=(cfg.num_channels, cfg.num_buoys, samples)).astype(np.float32)
    g_anchors = rng.normal(scale=5_000.0, size=(cfg.num_buoys, 3)).astype(np.float32)
    g_anchors[:, 2] = 0.0
    out = step(
        jax.device_put(g_re, in_shardings[0]),
        jax.device_put(g_im, in_shardings[1]),
        jax.device_put(g_anchors, in_shardings[2]),
    )
    return {
        "fix_sum": float(np.asarray(out.fixes_enu).sum()),
        "cost_sum": float(np.asarray(out.cost).sum()),
        "lag_sum": float(np.asarray(out.lags).sum()),
    }


def _run_two_process_demo(extra_args=(), port=19898):
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("JAX_PLATFORMS", None)
    # Prepend (never clobber an existing path) so the subprocess can
    # import the package without an editable install.
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    cmd = lambda pid: [
        sys.executable, os.path.join(REPO, "tools", "multihost_demo.py"),
        "--process-id", str(pid), "--num-processes", "2",
        "--coordinator", f"127.0.0.1:{port}", *extra_args,
    ]
    procs = [
        subprocess.Popen(
            cmd(pid), env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            stdout, stderr = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost demo timed out")
        lines = [l for l in stdout.splitlines() if l.startswith("{")]
        assert lines, f"no JSON from process (rc={p.returncode}):\n{stderr[-2000:]}"
        outs.append(json.loads(lines[-1]))

    if any("unsupported" in o for o in outs):
        pytest.skip(f"distributed CPU collectives unavailable: {outs}")
    return outs


def test_two_process_multihost_matches_single_process():
    outs = _run_two_process_demo()
    assert outs[0]["global_devices"] == 8
    for key in ("fix_sum", "cost_sum", "lag_sum"):
        assert outs[0][key] == pytest.approx(outs[1][key], rel=1e-5), key

    ref = _single_process_reference()
    for key in ("fix_sum", "cost_sum", "lag_sum"):
        assert outs[0][key] == pytest.approx(ref[key], rel=1e-4), (
            key, outs[0][key], ref[key],
        )


def test_two_process_multihost_config5_256ch():
    """BASELINE config 5 executes for real (VERDICT r4 item 1): the
    256-channel × 8-buoy × 16-subchannel north-star program runs across
    two OS processes wired into one 8-device global mesh, and both
    processes' replicated checksums match a single-process run of the
    identical program."""
    outs = _run_two_process_demo(extra_args=("--config5",), port=19899)
    assert outs[0]["global_devices"] == 8
    assert outs[0]["num_channels"] == 256
    for key in ("fix_sum", "cost_sum", "lag_sum"):
        assert outs[0][key] == pytest.approx(outs[1][key], rel=1e-5), key

    ref = _single_process_reference(config5=True)
    for key in ("fix_sum", "cost_sum", "lag_sum"):
        assert outs[0][key] == pytest.approx(ref[key], rel=1e-4), (
            key, outs[0][key], ref[key],
        )
