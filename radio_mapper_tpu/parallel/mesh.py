"""Mesh construction helpers."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DEFAULT_AXES = ("ch", "blk")


def balanced_mesh_shape(n: int) -> Tuple[int, int]:
    """Factor n into (a, b), a·b = n, as square as possible, a ≤ b."""
    a = int(n**0.5)
    while a > 1 and n % a != 0:
        a -= 1
    return a, n // a


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = DEFAULT_AXES,
    devices=None,
) -> Mesh:
    """Create a mesh over the available devices.

    Default: a 2-D ("ch", "blk") mesh with a near-square factorization —
    channels shard one way, time blocks the other, so neighboring devices carry
    the overlap-save halos while DP rides the orthogonal axis.
    """
    devices = list(devices) if devices is not None else jax.devices()
    n = len(devices)
    if shape is None:
        if len(axis_names) == 2:
            shape = balanced_mesh_shape(n)
        else:
            shape = (n,)
    total = 1
    for s in shape:
        total *= s
    if total != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    return jax.make_mesh(tuple(shape), tuple(axis_names), devices=devices)


def channel_sharding(mesh: Mesh, ndim: int, channel_axis: int = 0) -> NamedSharding:
    """Shard one array dim over the "ch" mesh axis, replicate the rest."""
    spec = [None] * ndim
    spec[channel_axis] = "ch"
    return NamedSharding(mesh, P(*spec))


def time_sharding(mesh: Mesh, ndim: int, time_axis: int = -1) -> NamedSharding:
    """Shard the time/sample dim over the "blk" mesh axis."""
    spec = [None] * ndim
    spec[time_axis % ndim] = "blk"
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
