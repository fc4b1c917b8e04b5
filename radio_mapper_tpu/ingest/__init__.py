"""IQ ingest sources: simulated, file replay, rtl_sdr pipe, rtl_tcp socket.

The ingest abstraction replaces the reference's L0-L2 stack (librtlsdr →
rtl_sdr CLI → Python pipe readers). Every source yields complex64 blocks
at a known sample rate and supports retuning, so the node runtime and the
device pipeline are agnostic to where samples come from:

- :class:`SimulatedSource` — deterministic synthetic streams from a
  :mod:`radio_mapper_tpu.sim` scenario (the hardware-free dev/test path;
  generalizes `buoy_node.py:244-296`);
- :class:`FileSource` — loops a raw uint8 I/Q ``.bin`` capture
  (`signal_analyzer.py:14-45` format);
- :class:`RtlSdrProcessSource` — persistent ``rtl_sdr`` subprocess
  streaming to stdout (`iq_stream_client.py:100-159`);
- :class:`RtlTcpSource` — client for the rtl_tcp wire protocol
  (`Code/src/rtl_tcp.c:270-365`), see :mod:`radio_mapper_tpu.net.rtl_tcp`;
- the C++ host ingest daemon (``native/``) plugs in through
  :class:`radio_mapper_tpu.ingest.native.NativeRingSource`.
"""

from radio_mapper_tpu.ingest.sources import (
    FileSource,
    IQSource,
    RtlSdrProcessSource,
    SimulatedSource,
)

__all__ = ["IQSource", "SimulatedSource", "FileSource", "RtlSdrProcessSource"]
