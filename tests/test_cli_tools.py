"""CLI, analyzer, autodetect and webapp tests."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from radio_mapper_tpu.analyzer import analyze_iq_file
from radio_mapper_tpu.config.autodetect import (
    auto_detect_interfaces,
    detect_local_ip,
    detect_sdr_count,
)
from radio_mapper_tpu.ops import iq as iq_ops


def _write_capture(path, tone_hz=200e3, fs=2_048_000.0, n=65536):
    t = np.arange(n) / fs
    data = 60.0 * np.exp(2j * np.pi * tone_hz * t) + np.random.default_rng(0).normal(
        size=n
    )
    iq_ops.save_iq_bin(str(path), data)


def test_analyzer_finds_tone(tmp_path):
    p = tmp_path / "iq_capture_test.bin"
    _write_capture(p)
    a = analyze_iq_file(str(p), sample_rate_hz=2_048_000.0, center_frequency_hz=100e6)
    assert a.num_samples == 65536
    assert len(a.peak_frequencies_hz) >= 1
    # Strongest peak at +200 kHz offset.
    best = a.peak_frequencies_hz[int(np.argmax(a.peak_powers_db))]
    assert abs(best - 200e3) < 1e3
    assert "MHz" in a.summary()


def test_analyzer_plot(tmp_path):
    p = tmp_path / "cap.bin"
    _write_capture(p, n=16384)
    png = tmp_path / "spec.png"
    analyze_iq_file(str(p), plot_path=str(png))
    assert png.exists() and png.stat().st_size > 1000


def test_autodetect_degrades_gracefully():
    report = auto_detect_interfaces()
    assert isinstance(report["local_ip"], str)
    assert report["sdr_count"] == 0  # no dongle in this image
    assert detect_sdr_count(binary="definitely-not-a-binary") == 0
    assert detect_local_ip()


def test_cli_simulate_and_test(tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "from radio_mapper_tpu.cli import main;"
        "main(['simulate','--seed','4'])"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300, env=env
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "emitter (fix):" in out.stdout
    err_line = [l for l in out.stdout.splitlines() if l.startswith("error:")][0]
    err_m = float(err_line.split()[1])
    assert err_m < 100.0


def test_cli_env_selftest_passes():
    """`test` subcommand (`run.py:246-320` parity) exits 0 here and
    covers config, deps, a tiny pipeline smoke, and the L0 driver
    bring-up against the device model."""
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "from radio_mapper_tpu.cli import main;"
        "main(['test'])"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-500:]
    assert "[PASS] USB bring-up + counter test (device model)" in out.stdout
    assert "[FAIL]" not in out.stdout


def test_cli_setup_reports_timing(tmp_path, capsys, monkeypatch):
    """`setup` parity with the reference's env self-test (`run.py:204-220`):
    interface detection + a timing-sync section. The host probe is
    stubbed out — it may spawn subprocesses / touch the network, and the
    suite must stay hermetic (CLAUDE.md conventions)."""
    import radio_mapper_tpu.cli as cli_mod
    from radio_mapper_tpu.cli import main

    monkeypatch.setattr(cli_mod, "_check_time_sync",
                        lambda: "stub: synchronized")
    out_yaml = tmp_path / "cfg.yaml"
    main(["setup", "--output", str(out_yaml)])
    out = capsys.readouterr().out
    assert "Detected interfaces:" in out
    assert "Time synchronization:" in out
    assert "method: gps (target 1 us, max 100 us)" in out
    assert "host clock:" in out
    assert out_yaml.exists()


def test_cli_capture_sim_and_analyze(tmp_path):
    env = dict(os.environ)
    out_bin = tmp_path / "c.bin"
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "from radio_mapper_tpu.cli import main;"
        f"main(['capture','--source','sim','--samples','32768','--output',r'{out_bin}'])"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stderr[-1500:]
    assert out_bin.exists() and out_bin.stat().st_size == 2 * 32768


def test_webapp_serves_ui_and_proxies(tmp_path):
    import asyncio

    async def run():
        import aiohttp

        from radio_mapper_tpu.runtime.central import CentralProcessor
        from radio_mapper_tpu.webapp.app import WebApp

        central = CentralProcessor(host="127.0.0.1", ws_port=18951, http_port=18952)
        await central.start()
        app = WebApp("http://127.0.0.1:18952", host="127.0.0.1", port=18953)
        await app.start()
        try:
            async with aiohttp.ClientSession() as http:
                async with http.get("http://127.0.0.1:18953/") as r:
                    html = await r.text()
                    assert r.status == 200
                    assert "radio-mapper-tpu" in html and "leaflet" in html.lower()
                async with http.get("http://127.0.0.1:18953/api/nodes") as r:
                    assert await r.json() == []
                async with http.get("http://127.0.0.1:18953/api/system-status") as r:
                    st = await r.json()
                    assert st["connected_nodes"] == 0
                async with http.get("http://127.0.0.1:18953/api/local-status") as r:
                    local = await r.json()
                    assert "gps_devices" in local
        finally:
            await app.stop()
            await central.stop()

    asyncio.run(run())


def test_webapp_proxy_unreachable_central():
    import asyncio

    async def run():
        import aiohttp

        from radio_mapper_tpu.webapp.app import WebApp

        app = WebApp("http://127.0.0.1:1", host="127.0.0.1", port=18954)
        await app.start()
        try:
            async with aiohttp.ClientSession() as http:
                async with http.get("http://127.0.0.1:18954/api/nodes") as r:
                    assert r.status == 502
                    body = await r.json()
                    assert "central unavailable" in body["error"]
        finally:
            await app.stop()

    asyncio.run(run())


def test_webapp_dev_mock_fallback():
    import asyncio

    async def run():
        import aiohttp

        from radio_mapper_tpu.webapp.app import WebApp

        app = WebApp("http://127.0.0.1:1", host="127.0.0.1", port=18955, dev_mock=True)
        await app.start()
        try:
            async with aiohttp.ClientSession() as http:
                async with http.get("http://127.0.0.1:18955/api/nodes") as r:
                    assert r.status == 200
                    nodes = await r.json()
                    assert len(nodes) == 3 and nodes[0]["id"].startswith("mock-")
                async with http.get("http://127.0.0.1:18955/api/system-status") as r:
                    st = await r.json()
                    assert st["mock"] is True
        finally:
            await app.stop()

    asyncio.run(run())


def test_cli_wideband_demo(capsys):
    """Config-4 CLI demo: active subchannel wins the weights and the fix
    lands within a few subchannel samples."""
    from radio_mapper_tpu.cli import main

    main([
        "--backend", "cpu", "wideband", "--buoys", "6",
        "--rate", "2048000", "--subchannels", "4", "--sub-block", "512",
        "--max-lag", "48", "--active-sub", "2",
    ])
    out = capsys.readouterr().out
    assert "<- active" in out
    assert "error" in out
    import re as _re

    err = float(_re.search(r"error ([\d.]+) m", out).group(1))
    # subchannel sample at 512 kS/s = 585 m
    assert err < 600.0, out


def test_backend_choices_are_auto_cpu_gpu():
    import pytest

    from radio_mapper_tpu.cli import build_parser

    p = build_parser()
    for choice in ("auto", "cpu", "gpu"):
        assert p.parse_args(["--backend", choice, "simulate"]).backend == choice
    with pytest.raises(SystemExit):
        p.parse_args(["--backend", "tpu", "simulate"])


def test_backend_gpu_fails_without_a_gpu():
    import pytest

    from radio_mapper_tpu.cli import main

    with pytest.raises(SystemExit, match="--backend gpu: no GPU"):
        main(["--backend", "gpu", "simulate"])


def test_simulate_runs_on_the_default_backend():
    """`simulate` is a pipeline command: it takes JAX's default backend
    (the GPU on a GPU host); host utilities and `server` stay on CPU."""
    from radio_mapper_tpu import cli

    assert "simulate" not in cli._CPU_DEFAULT_COMMANDS
    assert {"server", "scan", "demod"} <= cli._CPU_DEFAULT_COMMANDS


def test_autodetect_reports_accelerator():
    from radio_mapper_tpu.config.autodetect import detect_accelerator

    report = detect_accelerator()
    assert report["backend"] == "cpu" and report["num_devices"] >= 1
