"""Geodesy: spherical ECEF (reference parity), WGS84, ENU frames, haversine.

The reference uses a *spherical* Earth model with the WGS84 equatorial
radius for all coordinate transforms (`tdoa_processor.py:71-136`). This
module keeps that model (functions suffixed ``_sphere``) for behavioral
parity and regression tests, and adds a proper WGS84 ellipsoid plus local
ENU (east-north-up) tangent frames — the solver works in ENU meters, where
a ≤50 km buoy network (`config.yaml:145`) is numerically comfortable in
float32 on the device.

All functions accept scalars or arrays and are jax-traceable (they are also
valid NumPy code, so float64 golden values come from calling them with
NumPy inputs under ``jax.enable_x64`` — or via the ``*_np`` aliases that use
NumPy directly).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

from radio_mapper_tpu.constants import EARTH_RADIUS_M, WGS84_A, WGS84_B, WGS84_E2

# --- Spherical model (parity with tdoa_processor.py:71-136) -----------------


def lat_lng_to_ecef_sphere(lat_deg, lng_deg, alt_m=0.0):
    """Spherical ECEF: (R+alt)·[cosφcosλ, cosφsinλ, sinφ] (`tdoa_processor.py:77-93`)."""
    lat = jnp.deg2rad(lat_deg)
    lng = jnp.deg2rad(lng_deg)
    r = EARTH_RADIUS_M + alt_m
    cos_lat = jnp.cos(lat)
    return (
        r * cos_lat * jnp.cos(lng),
        r * cos_lat * jnp.sin(lng),
        r * jnp.sin(lat),
    )


def ecef_to_lat_lng_sphere(x, y, z):
    """Inverse spherical transform (`tdoa_processor.py:96-104`)."""
    lng = jnp.arctan2(y, x)
    hyp = jnp.sqrt(x * x + y * y)
    lat = jnp.arctan2(z, hyp)
    alt = jnp.sqrt(x * x + y * y + z * z) - EARTH_RADIUS_M
    return jnp.rad2deg(lat), jnp.rad2deg(lng), alt


def distance_3d_sphere(lat1, lng1, alt1, lat2, lng2, alt2):
    """Chord distance between two points (`tdoa_processor.py:107-113`)."""
    p1 = jnp.stack(lat_lng_to_ecef_sphere(lat1, lng1, alt1), axis=-1)
    p2 = jnp.stack(lat_lng_to_ecef_sphere(lat2, lng2, alt2), axis=-1)
    return jnp.linalg.norm(p2 - p1, axis=-1)


def bearing_distance(lat1, lng1, lat2, lng2):
    """Haversine great-circle distance + initial bearing (`tdoa_processor.py:116-136`).

    Returns ``(bearing_deg in [0, 360), distance_m)``.
    """
    phi1 = jnp.deg2rad(lat1)
    phi2 = jnp.deg2rad(lat2)
    dlng = jnp.deg2rad(lng2 - lng1)
    a = (
        jnp.sin((phi2 - phi1) / 2) ** 2
        + jnp.cos(phi1) * jnp.cos(phi2) * jnp.sin(dlng / 2) ** 2
    )
    c = 2.0 * jnp.arctan2(jnp.sqrt(a), jnp.sqrt(1.0 - a))
    distance = EARTH_RADIUS_M * c
    y = jnp.sin(dlng) * jnp.cos(phi2)
    x = jnp.cos(phi1) * jnp.sin(phi2) - jnp.sin(phi1) * jnp.cos(phi2) * jnp.cos(dlng)
    bearing = (jnp.rad2deg(jnp.arctan2(y, x)) + 360.0) % 360.0
    return bearing, distance


# --- WGS84 ellipsoid ---------------------------------------------------------


def lat_lng_to_ecef_wgs84(lat_deg, lng_deg, alt_m=0.0):
    lat = jnp.deg2rad(lat_deg)
    lng = jnp.deg2rad(lng_deg)
    sin_lat = jnp.sin(lat)
    n = WGS84_A / jnp.sqrt(1.0 - WGS84_E2 * sin_lat * sin_lat)
    cos_lat = jnp.cos(lat)
    x = (n + alt_m) * cos_lat * jnp.cos(lng)
    y = (n + alt_m) * cos_lat * jnp.sin(lng)
    z = (n * (1.0 - WGS84_E2) + alt_m) * sin_lat
    return x, y, z


def ecef_to_lat_lng_wgs84(x, y, z):
    """Bowring's closed-form approximation (sub-mm for terrestrial points)."""
    lng = jnp.arctan2(y, x)
    p = jnp.sqrt(x * x + y * y)
    theta = jnp.arctan2(z * WGS84_A, p * WGS84_B)
    ep2 = (WGS84_A**2 - WGS84_B**2) / WGS84_B**2
    lat = jnp.arctan2(
        z + ep2 * WGS84_B * jnp.sin(theta) ** 3,
        p - WGS84_E2 * WGS84_A * jnp.cos(theta) ** 3,
    )
    sin_lat = jnp.sin(lat)
    n = WGS84_A / jnp.sqrt(1.0 - WGS84_E2 * sin_lat * sin_lat)
    alt = p / jnp.cos(lat) - n
    return jnp.rad2deg(lat), jnp.rad2deg(lng), alt


# --- Local ENU tangent frame -------------------------------------------------


def enu_rotation(lat_deg, lng_deg):
    """Rows are the local east/north/up unit vectors in ECEF."""
    lat = jnp.deg2rad(lat_deg)
    lng = jnp.deg2rad(lng_deg)
    sl, cl = jnp.sin(lat), jnp.cos(lat)
    so, co = jnp.sin(lng), jnp.cos(lng)
    return jnp.stack(
        [
            jnp.stack([-so, co, jnp.zeros_like(so)], axis=-1),
            jnp.stack([-sl * co, -sl * so, cl], axis=-1),
            jnp.stack([cl * co, cl * so, sl], axis=-1),
        ],
        axis=-2,
    )


def lat_lng_to_enu(lat_deg, lng_deg, alt_m, ref_lat_deg, ref_lng_deg, ref_alt_m=0.0):
    """ENU meters of a point relative to a reference origin (WGS84)."""
    p = jnp.stack(lat_lng_to_ecef_wgs84(lat_deg, lng_deg, alt_m), axis=-1)
    o = jnp.stack(lat_lng_to_ecef_wgs84(ref_lat_deg, ref_lng_deg, ref_alt_m), axis=-1)
    rot = enu_rotation(ref_lat_deg, ref_lng_deg)
    return jnp.einsum("...ij,...j->...i", rot, p - o)


def enu_to_lat_lng(enu, ref_lat_deg, ref_lng_deg, ref_alt_m=0.0):
    """Inverse of :func:`lat_lng_to_enu`; ``enu`` is ``[..., 3]``."""
    o = jnp.stack(lat_lng_to_ecef_wgs84(ref_lat_deg, ref_lng_deg, ref_alt_m), axis=-1)
    rot = enu_rotation(ref_lat_deg, ref_lng_deg)
    p = o + jnp.einsum("...ji,...j->...i", rot, enu)
    return ecef_to_lat_lng_wgs84(p[..., 0], p[..., 1], p[..., 2])


# --- NumPy float64 goldens ---------------------------------------------------


def lat_lng_to_ecef_sphere_np(lat_deg, lng_deg, alt_m=0.0) -> Tuple[np.ndarray, ...]:
    lat = np.deg2rad(np.asarray(lat_deg, dtype=np.float64))
    lng = np.deg2rad(np.asarray(lng_deg, dtype=np.float64))
    r = EARTH_RADIUS_M + np.asarray(alt_m, dtype=np.float64)
    return (
        r * np.cos(lat) * np.cos(lng),
        r * np.cos(lat) * np.sin(lng),
        r * np.sin(lat),
    )


def lat_lng_to_enu_np(lat_deg, lng_deg, alt_m, ref_lat, ref_lng, ref_alt=0.0) -> np.ndarray:
    def ecef(la, lo, al):
        la, lo = np.deg2rad(float(la)), np.deg2rad(float(lo))
        sin_lat = np.sin(la)
        n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sin_lat**2)
        return np.array(
            [
                (n + al) * np.cos(la) * np.cos(lo),
                (n + al) * np.cos(la) * np.sin(lo),
                (n * (1.0 - WGS84_E2) + al) * sin_lat,
            ]
        )

    p = ecef(lat_deg, lng_deg, alt_m)
    o = ecef(ref_lat, ref_lng, ref_alt)
    la, lo = np.deg2rad(float(ref_lat)), np.deg2rad(float(ref_lng))
    rot = np.array(
        [
            [-np.sin(lo), np.cos(lo), 0.0],
            [-np.sin(la) * np.cos(lo), -np.sin(la) * np.sin(lo), np.cos(la)],
            [np.cos(la) * np.cos(lo), np.cos(la) * np.sin(lo), np.sin(la)],
        ]
    )
    return rot @ (p - o)
