"""Overlap-save halo exchange along a sharded time axis.

Continuous DSP over a time-sharded stream needs each shard to see the tail
of its left neighbor (filter/channelizer history) — the classic
overlap-save layout. The exchange is one `jax.lax.ppermute` hop over
the "blk" mesh axis: a single neighbor transfer per step, fully
overlappable with compute by XLA's scheduler.

The reference has no equivalent — its stream blocks are processed
independently and inter-block signal continuity is simply lost
(`iq_stream_client.py:496-503`, SURVEY §5 "long-context"). These helpers
are what make the sharded pipeline gap-free.

All functions must be called inside `shard_map` (they use collectives over
a named axis) with the time axis as the *last* array axis.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def left_halo(x: jnp.ndarray, axis_name: str, halo: int, *, wrap: bool = False) -> jnp.ndarray:
    """Tail (last ``halo`` samples) of the left neighbor's shard.

    Shard 0 receives zeros unless ``wrap`` (matching a zero initial filter
    state at stream start).
    """
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    tail = x[..., -halo:]
    if n == 1:
        received = jnp.zeros_like(tail) if not wrap else tail
        return received
    perm = [(i, (i + 1) % n) for i in range(n)]
    received = jax.lax.ppermute(tail, axis_name, perm)
    if not wrap:
        received = jnp.where(idx == 0, jnp.zeros_like(received), received)
    return received


def right_halo(x: jnp.ndarray, axis_name: str, halo: int, *, wrap: bool = False) -> jnp.ndarray:
    """Head (first ``halo`` samples) of the right neighbor's shard."""
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    head = x[..., :halo]
    if n == 1:
        return head if wrap else jnp.zeros_like(head)
    perm = [(i, (i - 1) % n) for i in range(n)]
    received = jax.lax.ppermute(head, axis_name, perm)
    if not wrap:
        received = jnp.where(idx == n - 1, jnp.zeros_like(received), received)
    return received


def with_left_halo(x: jnp.ndarray, axis_name: str, halo: int, *, wrap: bool = False) -> jnp.ndarray:
    """Prepend the left neighbor's tail: ``[..., halo + local]``."""
    return jnp.concatenate([left_halo(x, axis_name, halo, wrap=wrap), x], axis=-1)


def with_right_halo(x: jnp.ndarray, axis_name: str, halo: int, *, wrap: bool = False) -> jnp.ndarray:
    """Append the right neighbor's head: ``[..., local + halo]``."""
    return jnp.concatenate([x, right_halo(x, axis_name, halo, wrap=wrap)], axis=-1)
