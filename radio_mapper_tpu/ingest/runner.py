"""Ingest-closed pipeline loop: native ring → host→HBM → jitted step.

This is the framework's analog of the reference's whole L0 design —
librtlsdr keeps 15 × 256 KiB USB transfers in flight so the dongle never
stalls (`Code/src/librtlsdr.c:1769-1891, 358-359`) and `rtl_test`'s only
perf harness asserts zero sample drops at the tuned rate
(`Code/src/rtl_test.c:109-135`). Here the equivalent overlap is:

  ring (producer thread, paced)    — native/ingest.cpp
    → host read of block k+1       — rmt_ingest_read (memcpy out of ring)
    → async device_put of k+1      — JAX transfer engine, overlaps with…
    → dispatched step on block k   — the jitted split pipeline on-device
    → (one trailing scalar fetch closes the timing epoch)

`jax.device_put` and jitted dispatch both return before the work
finishes, so the host loop naturally keeps one block of transfer and one
step of compute in flight; the device serializes its own queue. Raw
uint8 bytes ship to the device and decode THERE (2 bytes/sample moved
instead of 8 for split float32 — the transfer leg is the scarce resource,
exactly why rtl_tcp ships bytes too).

Drop accounting: with a paced source (a virtual SDR clock),
``stats().bytes_dropped == 0`` after a sustained run is the real-time
criterion.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import jax
import numpy as np


@dataclasses.dataclass
class IngestLoopStats:
    steps: int
    samples_per_step: int
    elapsed_s: float
    sustained_samples_per_s: float
    host_read_ms_per_step: float  # ring memcpy + reshape leg (host)
    transfer_ms_per_step: float  # device_put call overhead (async issue)
    real_time_ratio: float  # sustained rate / source rate (>=1 keeps up)
    dropped_bytes: int  # ring-overflow BYTES (2 bytes = one I/Q sample)
    bytes_consumed: int

    @property
    def dropped_samples(self) -> int:
        """Ring-overflow complex samples (uint8 I/Q ⇒ 2 bytes/sample)."""
        return self.dropped_bytes // 2

    @property
    def drops(self) -> int:  # back-compat alias (pre-r5 name; bytes!)
        return self.dropped_bytes


class IngestLoop:
    """Drive a jitted step from a native ring with double buffering.

    Args:
      step: jitted ``(raw_u8[ch, B, 2N], anchors) -> PipelineOutput`` (or
        any output pytree with at least one array leaf).
      ingest: a :class:`radio_mapper_tpu.ingest.native.NativeIngest`.
      channels, num_buoys, block_len: block geometry; one ring read is
        ``channels · num_buoys · 2 · block_len`` bytes.
      anchors: device-resident anchors array passed to every step.
      source_samples_per_s: the source's aggregate complex-sample rate
        (for the real-time ratio); 0 disables the ratio.
    """

    def __init__(
        self,
        step: Callable,
        ingest,
        *,
        channels: int,
        num_buoys: int,
        block_len: int,
        anchors,
        source_samples_per_s: float = 0.0,
        device_put: Optional[Callable] = None,
        blocks_per_dispatch: int = 1,
        drain_threads: int = 0,
        reuse_slots: bool = False,
    ):
        """``blocks_per_dispatch > 1`` stacks k consecutive blocks as a
        leading batch axis per step call — the pipeline is batch-generic,
        so one dispatch (and its fixed dispatch and transfer-issue
        overhead) then covers k blocks of real-time budget. This is the
        dispatch-bound regime's lever."""
        self.step = step
        self.ingest = ingest
        self.channels = channels
        self.num_buoys = num_buoys
        self.block_len = block_len
        self.anchors = anchors
        self.source_samples_per_s = source_samples_per_s
        self._device_put = device_put or jax.device_put
        self.blocks_per_dispatch = int(blocks_per_dispatch)
        self.block_bytes = (
            self.blocks_per_dispatch * channels * num_buoys * 2 * block_len
        )
        # The ring drain fills either a FRESH buffer per read (default —
        # np.empty is microseconds and, crucially, safe: `jax.device_put`
        # is ZERO-COPY on the CPU backend and asynchronous everywhere, so
        # a reused buffer can be overwritten while a still-pending step
        # reads it) or, with ``reuse_slots=True``, two pre-allocated
        # destinations in rotation — an opt-in for pinned-memory setups
        # where the caller synchronizes transfer completion itself.
        # ``drain_threads > 1`` runs the ring→buffer memcpy as the C++
        # parallel drain (`ring_buffer.hpp read_ranges`).
        self.drain_threads = int(drain_threads)
        self._slots = (
            [np.empty(self.block_bytes, np.uint8) for _ in range(2)]
            if reuse_slots else None
        )
        self._slot_idx = 0

    def warm_compile(self, seed: int = 0):
        """Compile + execute the step on a synthetic block (no ring read).

        Call BEFORE opening a paced source so compile time doesn't fill
        the ring and show up as spurious drops.
        """
        rng = np.random.default_rng(seed)
        block = rng.integers(0, 256, size=self._block_shape(), dtype=np.uint8)
        jax.block_until_ready(self.step(self._device_put(block), self.anchors))

    def _block_shape(self):
        base = (self.channels, self.num_buoys, 2 * self.block_len)
        if self.blocks_per_dispatch > 1:
            return (self.blocks_per_dispatch, *base)
        return base

    def _read_block(self, timeout_ms: int = 10_000) -> np.ndarray:
        if self._slots is not None:
            buf = self._slots[self._slot_idx]
            self._slot_idx ^= 1
        else:
            buf = np.empty(self.block_bytes, np.uint8)
        if hasattr(self.ingest, "read_into"):
            got, _ts = self.ingest.read_into(
                buf, timeout_ms, threads=self.drain_threads
            )
        else:  # pure-Python sources
            raw, _ts = self.ingest.read_bytes(self.block_bytes, timeout_ms)
            got = raw.size
            buf[:got] = raw
        if got < self.block_bytes:
            raise IOError(
                f"ring underrun: wanted {self.block_bytes} got {got} "
                "(source stalled or timeout too small)"
            )
        return buf.reshape(self._block_shape())

    def run(self, num_steps: int, *, warmup_steps: int = 1) -> IngestLoopStats:
        """Run the overlap loop; returns sustained-throughput stats.

        The timed window ends when the final step's outputs are ready;
        steps run in order on the device, so every earlier one is done.
        """
        # Warmup: compile + first transfers outside the timed window.
        # NOTE: with a paced source the ring fills during compile, so for
        # drop-accounting runs compile the step BEFORE opening the source
        # (warm_compile()) and pass warmup_steps=0.
        out = None
        for _ in range(warmup_steps):
            dev = self._device_put(self._read_block())
            out = self.step(dev, self.anchors)

        host_ms = 0.0
        put_ms = 0.0
        t0 = time.perf_counter()
        next_dev = None
        for k in range(num_steps):
            if next_dev is None:
                th = time.perf_counter()
                block = self._read_block()
                tp = time.perf_counter()
                next_dev = self._device_put(block)
                host_ms += (tp - th) * 1e3
                put_ms += (time.perf_counter() - tp) * 1e3
            out = self.step(next_dev, self.anchors)  # async dispatch
            next_dev = None
            if k + 1 < num_steps:
                # overlap: pull + upload block k+1 while step k computes
                th = time.perf_counter()
                block = self._read_block()
                tp = time.perf_counter()
                next_dev = self._device_put(block)
                host_ms += (tp - th) * 1e3
                put_ms += (time.perf_counter() - tp) * 1e3
        jax.block_until_ready(out)
        elapsed = time.perf_counter() - t0

        samples_per_step = (
            self.blocks_per_dispatch * self.channels * self.num_buoys * self.block_len
        )
        sustained = samples_per_step * num_steps / elapsed
        stats = self.ingest.stats()
        return IngestLoopStats(
            steps=num_steps,
            samples_per_step=samples_per_step,
            elapsed_s=elapsed,
            sustained_samples_per_s=sustained,
            host_read_ms_per_step=host_ms / num_steps,
            transfer_ms_per_step=put_ms / num_steps,
            real_time_ratio=(
                sustained / self.source_samples_per_s
                if self.source_samples_per_s
                else 0.0
            ),
            dropped_bytes=int(stats["bytes_dropped"]),
            bytes_consumed=int(stats["bytes_consumed"]),
        )
