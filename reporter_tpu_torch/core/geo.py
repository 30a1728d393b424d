"""Geodesy helpers shared by host code and the device matcher.

The reference measures probe separation with an equirectangular approximation
(reference: Batch.java:34-41); we keep the identical constant so streaming
report thresholds trip at the same distances.
"""
from __future__ import annotations

import math

import numpy as np

RAD_PER_DEG = math.pi / 180.0
# Half the WGS84-ish circumference used by the reference, per degree.
METERS_PER_DEG = 20037581.187 / 180.0


def equirectangular_m(lat_a, lon_a, lat_b, lon_b):
    """Equirectangular-approximation distance in meters.

    Works on scalars or numpy arrays (broadcasting). Matches the streaming
    worker's separation metric (reference: Batch.java:37-41).
    """
    x = (np.asarray(lon_a) - np.asarray(lon_b)) * METERS_PER_DEG * np.cos(
        0.5 * (np.asarray(lat_a) + np.asarray(lat_b)) * RAD_PER_DEG
    )
    y = (np.asarray(lat_a) - np.asarray(lat_b)) * METERS_PER_DEG
    d = np.sqrt(x * x + y * y)
    if np.ndim(d) == 0:
        return float(d)
    return d


def local_meters_projection(lat0: float, lon0: float):
    """Return (to_xy, to_ll) converting lat/lon degrees <-> local meters.

    A flat equirectangular chart anchored at (lat0, lon0); accurate to well
    under GPS noise over a metro-area extent, and cheap enough to run per
    probe batch on the host.
    """
    coslat = math.cos(lat0 * RAD_PER_DEG)

    def to_xy(lat, lon):
        x = (np.asarray(lon) - lon0) * METERS_PER_DEG * coslat
        y = (np.asarray(lat) - lat0) * METERS_PER_DEG
        return x, y

    def to_ll(x, y):
        lon = np.asarray(x) / (METERS_PER_DEG * coslat) + lon0
        lat = np.asarray(y) / METERS_PER_DEG + lat0
        return lat, lon

    return to_xy, to_ll
