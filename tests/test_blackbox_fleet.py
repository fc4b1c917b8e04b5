"""Black-box 3-buoy fleet: the deploy/docker-compose.yml topology as real
subprocesses, asserting triangulated FIXES flow through the WS/HTTP plane.

VERDICT r3 item 7's "done" criterion: bring up central + web + three
simulated buoys (the exact commands the compose services run) and watch
`/api/signals` produce triangulations from live correlated detections —
the full detect → snippet wire → waveform GCC → solve → API chain, no
in-process handles anywhere.
"""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# Ports the OS hands out now, not fixed numbers other tests may hold
# under parallel workers.
WS_PORT, HTTP_PORT, WEB_PORT = _free_port(), _free_port(), _free_port()


def _get(url, timeout=5.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read().decode()


def _wait_http(url, deadline_s=60.0):
    deadline = time.time() + deadline_s
    last = None
    while time.time() < deadline:
        try:
            status, body = _get(url)
            if status == 200:
                return body
        except Exception as e:
            last = e
        time.sleep(0.5)
    raise TimeoutError(f"{url} never came up: {last}")


@pytest.mark.slow
def test_three_buoy_fleet_produces_fixes():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    spawn = lambda *args: subprocess.Popen(
        [sys.executable, "-m", "radio_mapper_tpu", *args],
        env=env, cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    procs = []
    try:
        procs.append(spawn(
            "server", "--host", "127.0.0.1",
            "--ws-port", str(WS_PORT), "--http-port", str(HTTP_PORT),
        ))
        _wait_http(f"http://127.0.0.1:{HTTP_PORT}/api/system-status")
        procs.append(spawn(
            "web", "--central", f"http://127.0.0.1:{HTTP_PORT}",
            "--host", "127.0.0.1", "--port", str(WEB_PORT),
        ))
        # the compose file's three buoy services, verbatim commands
        for k in range(3):
            procs.append(spawn(
                "--backend", "cpu", "buoy", "--id", f"buoy-{k+1}",
                "--source", "sim", "--sim-index", str(k),
                "--central", f"ws://127.0.0.1:{WS_PORT}", "--dev",
            ))

        # all three register (generous: 5 subprocesses JIT-compile
        # concurrently on a 2-vCPU CI box)
        deadline = time.time() + 240.0
        while time.time() < deadline:
            _, body = _get(f"http://127.0.0.1:{HTTP_PORT}/api/nodes")
            ids = {n["id"] for n in json.loads(body)}
            if {"buoy-1", "buoy-2", "buoy-3"} <= ids:
                break
            time.sleep(1.0)
        assert {"buoy-1", "buoy-2", "buoy-3"} <= ids, ids

        # correlated detections triangulate: /api/signals fills with fixes
        deadline = time.time() + 360.0
        signals = []
        while time.time() < deadline:
            _, body = _get(f"http://127.0.0.1:{HTTP_PORT}/api/signals")
            signals = json.loads(body)
            if signals:
                break
            time.sleep(2.0)
        assert signals, "no triangulated fixes reached /api/signals"
        sig = signals[0]
        assert len(set(sig["detected_by"])) >= 3, sig
        assert "lat" in sig and "lng" in sig
        # the scenario emitter sits at (35.47, -97.51); a live waveform
        # fix lands within a few km (dev clocks, 2 s dwells)
        assert abs(sig["lat"] - 35.47) < 0.2, sig
        assert abs(sig["lng"] + 97.51) < 0.2, sig

        # the web proxy serves the same fixes (dashboard surface)
        body = _wait_http(f"http://127.0.0.1:{WEB_PORT}/api/signals")
        assert json.loads(body)
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
