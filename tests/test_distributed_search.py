"""Distributed waveform search: HTTP /api/search_signal with iq_pattern
fans out to live buoy nodes over WS and aggregates ranked matches."""

import asyncio
import datetime
import socket

import numpy as np

from radio_mapper_tpu.runtime.buoy import BuoyNode, BuoyNodeConfig
from radio_mapper_tpu.runtime.datamodel import SignalDetection


def _det(buoy_id, f_mhz):
    now = datetime.datetime.now(datetime.timezone.utc).isoformat()
    return SignalDetection(
        buoy_id=buoy_id, frequency_mhz=f_mhz, signal_strength_dbm=-50.0,
        timestamp_utc=now, gps_timestamp_ns=0, lat=35.0, lng=-97.0,
        confidence=0.9, signal_type="unknown",
    )


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_distributed_waveform_search_live():
    asyncio.run(_drive(_free_port(), _free_port()))


async def _drive(ws_port, http_port):
    import aiohttp

    from radio_mapper_tpu.runtime.central import CentralProcessor

    central = CentralProcessor(host="127.0.0.1", ws_port=ws_port, http_port=http_port)
    await central.start()
    rng = np.random.default_rng(11)
    q = (rng.normal(size=256) + 1j * rng.normal(size=256)).astype(np.complex64)

    nodes, tasks = [], []
    try:
        # Two live buoys; one holds a shifted copy of the pattern, the
        # other only noise.
        for k, snip in enumerate(
            [np.roll(q, 21), (rng.normal(size=256) + 1j * rng.normal(size=256)).astype(np.complex64)]
        ):
            node = BuoyNode(
                BuoyNodeConfig(
                    buoy_id=f"ds-{k}", development_mode=True,
                    central_ws_url=f"ws://127.0.0.1:{ws_port}",
                )
            )
            d = _det(f"ds-{k}", 121.5)
            node.signal_history.append(d)
            node.snippet_history.append((d, snip))
            nodes.append(node)
            tasks.append(asyncio.create_task(node.run()))

        deadline = asyncio.get_event_loop().time() + 15
        while len(central.nodes) < 2:
            assert asyncio.get_event_loop().time() < deadline, "nodes never registered"
            await asyncio.sleep(0.1)

        pattern = [[float(v.real), float(v.imag)] for v in q]
        async with aiohttp.ClientSession() as http:
            async with http.post(
                f"http://127.0.0.1:{http_port}/api/search_signal",
                json={"iq_pattern": pattern, "min_score": 0.5, "timeout_s": 10.0},
            ) as r:
                body = await r.json()
        assert body["nodes_queried"] == 2
        assert body["count"] == 1, body
        m = body["matches"][0]
        assert m["node_id"] == "ds-0" and m["buoy_id"] == "ds-0"
        assert abs(m["match_score"] - 1.0) < 1e-3
        assert m["match_lag"] == 21

        # Metadata-only search still behaves as before (central fix buffer).
        async with aiohttp.ClientSession() as http:
            async with http.post(
                f"http://127.0.0.1:{http_port}/api/search_signal", json={}
            ) as r:
                assert r.status == 400
    finally:
        for t in tasks:
            t.cancel()
        await central.stop()
