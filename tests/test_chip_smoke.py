"""chip_smoke.py and the device helpers, at tiny sizes on the CPU.

The full-size run needs a GPU (``python chip_smoke.py``); here every
phase runs on small shapes, the sharded phases on 4 virtual CPU devices,
and the ``gpu``-marked tests skip unless JAX's devices are GPUs.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import chip_smoke
from radio_mapper_tpu.utils import device

REPO = Path(__file__).resolve().parents[1]


def _small_wideband():
    from radio_mapper_tpu.models.wideband import WidebandConfig

    return WidebandConfig(
        num_buoys=8, wide_rate_hz=4_096_000.0, num_subchannels=8,
        sub_block=1024, max_lag=64, solver_iterations=20,
    )


# -------------------------------------------------------- device helpers


def test_require_gpu_refuses_cpu_backend():
    with pytest.raises(RuntimeError, match="no GPU"):
        device.require_gpu()


def test_compile_cache_uses_env_dir_and_sets_nothing(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert device.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_default_is_fixed_checkout_dir(monkeypatch):
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    path = device.enable_compile_cache()
    assert path == str(REPO / ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", str(REPO / ".jax_cache"))]
    # same path every call (no pid/time/temp component), ignored by git
    assert device.enable_compile_cache() == path
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().splitlines()


# ------------------------------------------------------------- the script


def test_main_refuses_cpu_only_process(capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.main([])
    out = capsys.readouterr().out
    assert '"ok"' not in out
    assert out.startswith("nvidia-smi:\n")  # the card lines come first, whatever the backend


def test_script_alone_in_a_directory_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_flagship_phase_tiny(capsys):
    chip_smoke.phase_flagship(channels=2, block_len=4096, max_lag=256, iters=2)
    out = capsys.readouterr().out
    assert "flagship [shipped]: |dtau|" in out and "flagship [highest]: |dtau|" in out
    assert "memory:" in out and "compile" in out


def test_wideband_phase_tiny(capsys):
    chip_smoke.phase_wideband(_small_wideband(), active=3, iters=2)
    out = capsys.readouterr().out
    assert "wideband [highest]: active-subchannel fix error" in out


def test_simulate_phase_in_process(capsys):
    err = chip_smoke.phase_simulate("cpu")
    assert err < chip_smoke.SIMULATE_FIX_BOUND_M
    assert "simulate: emitter (fix):" in capsys.readouterr().out


@pytest.mark.parametrize("phase", ["config5", "pair_ep"])
def test_sharded_phase_on_four_virtual_devices(phase, capsys):
    devices = jax.devices()[:4]
    assert len(devices) == 4
    if phase == "config5":
        chip_smoke.phase_config5(devices, num_channels=8, block_len=4096)
    else:
        chip_smoke.phase_pair_ep(devices, side=4, block_len=2048)
    out = capsys.readouterr().out
    assert "max |sharded - one card|" in out
    assert "on 4 device(s)" in out and "on 1 device(s)" in out
    if phase == "config5":
        # both meshes, the second with the halo crossing devices
        assert "config-5 [highest] ch=4 x blk=1 fixes" in out
        assert "config-5 [highest] ch=2 x blk=2 fixes" in out
        assert "2 time segment(s)" in out


def test_config5_split_check_rejects_unsplit_axis():
    from jax.sharding import NamedSharding, PartitionSpec as P

    from radio_mapper_tpu.parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh((2, 2), ("ch", "blk"), devices=jax.devices()[:4])
    x = jax.device_put(np.zeros((4, 2, 64), np.float32), NamedSharding(mesh, P("ch", None, "blk")))
    chip_smoke._split_over(x, 2, 2, "ok")
    chip_smoke._split_over(x, 0, 2, "ok")
    with pytest.raises(AssertionError):
        chip_smoke._split_over(x, 1, 2, "buoy axis is not split")


def test_tau_check_rejects_a_tenth_of_a_sample():
    ref = {
        "lag_samples": np.array([1.0, 2.0]),
        "psr": np.array([5.0, 5.0]),
    }
    chip_smoke.tau_check("ok", np.array([1.0005, 2.0]), ref, max_lag=16)
    with pytest.raises(AssertionError):
        chip_smoke.tau_check("bad", np.array([1.2, 2.0]), ref, max_lag=16)


def test_tau_check_rejects_a_lower_precision_route():
    """Inside 0.1 sample, but at the TF32 matmul DFT's ~1e-2 on the card."""
    ref = {"lag_samples": np.array([1.0, 2.0]), "psr": np.array([5.0, 5.0])}
    assert chip_smoke.TAU_ROUTE_BOUND_SAMPLES < 1e-2 < chip_smoke.golden.TAU_BOUND_SAMPLES
    with pytest.raises(AssertionError):
        chip_smoke.tau_check("tf32", np.array([1.01, 2.0]), ref, max_lag=16)


def test_sharded_agreement_rejects_divergence():
    with pytest.raises(AssertionError):
        chip_smoke._agreement("x", np.zeros(3), np.array([0.0, 0.5, 0.0]), 1e-2)


# ------------------------------------------------------------- on the card


@pytest.mark.gpu
def test_require_gpu_on_gpu():
    assert device.require_gpu()[0].platform == "gpu"


@pytest.mark.gpu
def test_flagship_phase_on_gpu():
    chip_smoke.phase_flagship(channels=8, iters=3)


@pytest.mark.gpu
def test_cli_backend_gpu_on_gpu(capsys):
    chip_smoke.phase_simulate("gpu")
