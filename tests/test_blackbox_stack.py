"""Black-box stack test: real subprocesses, real HTTP/WS, DOM checks.

Mirrors the reference's live integration suite
(`/root/reference/tests/test_system_integration.py:61-182`), which drives
a docker-compose stack over HTTP/WS — here the same topology (central +
web dashboard + buoy) launches as actual CLI subprocesses (`python -m
radio_mapper_tpu server|buoy|web`, the processes the compose file runs),
and everything is probed from the outside: no in-process handles.
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


def test_blackbox_stack():
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
        procs.append(spawn(
            "--backend", "cpu", "buoy", "--dev", "--id", "bb-live-1",
            "--central", f"ws://127.0.0.1:{WS_PORT}",
        ))

        # Central liveness + node registration over the real WS link
        # (reference :162-182 checks the nodes API reflects the client).
        deadline = time.time() + 90.0
        nodes = []
        while time.time() < deadline:
            _, body = _get(f"http://127.0.0.1:{HTTP_PORT}/api/nodes")
            nodes = json.loads(body)
            if any(n["id"] == "bb-live-1" for n in nodes):
                break
            time.sleep(1.0)
        assert any(n["id"] == "bb-live-1" for n in nodes), nodes

        # Detections flow end-to-end (buoy scans a simulated SDR on CPU).
        deadline = time.time() + 120.0
        dets = []
        while time.time() < deadline:
            _, body = _get(f"http://127.0.0.1:{HTTP_PORT}/api/detections")
            dets = json.loads(body)
            if dets:
                break
            time.sleep(1.0)
        assert dets, "no detections reached central"
        assert dets[0]["node_id"] == "bb-live-1"
        assert "frequency_mhz" in dets[0] and "confidence" in dets[0]

        # Webapp proxies the central APIs (reference webapp checks :87-94).
        body = _wait_http(f"http://127.0.0.1:{WEB_PORT}/api/devices")
        devices = json.loads(body)
        assert any(d["id"] == "bb-live-1" for d in devices)
        _, sig_body = _get(f"http://127.0.0.1:{WEB_PORT}/api/detections")
        assert json.loads(sig_body)

        # Dashboard DOM: the UI actually ships the map + panels
        # (reference index.html parity surface).
        _, html = _get(f"http://127.0.0.1:{WEB_PORT}/")
        for marker in (
            'id="map"', 'id="signal-list"', 'id="detection-list"',
            'id="alert-banner"', 'id="search-freq"', 'id="t-nodes"',
            "leaflet",
        ):
            assert marker in html or marker.capitalize() in html, marker

        # The pure JS layer is served (index.html references it).
        _, appjs = _get(f"http://127.0.0.1:{WEB_PORT}/static/app.js")
        assert "function statusModel(" in appjs

        # Prometheus metrics exposed.
        _, metrics = _get(f"http://127.0.0.1:{HTTP_PORT}/metrics")
        assert "detections_received" in metrics
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
