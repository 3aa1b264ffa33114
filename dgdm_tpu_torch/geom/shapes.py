"""Synthetic icon images — stand-ins for the Icons-50 dataset the reference
feeds to ``assets/icon_process.py`` (not shipped with either repo).

Five shape families with seed-controlled variation give the geometric
diversity (convexity, aspect, lobes, notches) needed for engine calibration
to generalize; each is a radial function r(angle) rendered onto a white
background, so contour extraction behaves exactly as on real icons.

PyTorch port: numpy copy of ``dgdm_tpu/geom/shapes.py``.
"""

from __future__ import annotations

import numpy as np

FAMILIES = ("star", "ellipse", "polygon", "peanut", "notch")


def _radial_icon(rad_fn, size: int) -> np.ndarray:
    yy, xx = np.mgrid[0:size, 0:size]
    c = size / 2
    ang = np.arctan2(yy - c, xx - c)
    r = np.hypot(xx - c, yy - c)
    img = np.where(r < rad_fn(ang) * size, 30, 255).astype(np.uint8)
    return np.stack([img] * 3, -1)


def synthetic_icon(seed: int = 0, family: str = "star", size: int = 64) -> np.ndarray:
    """A white-background image with one dark shape, like an Icons-50 icon."""
    rng = np.random.RandomState(seed * len(FAMILIES) + FAMILIES.index(family))
    if family == "star":
        k = rng.randint(3, 7)
        p1, p2 = rng.uniform(0, 2 * np.pi, 2)
        a1 = rng.uniform(0.12, 0.3)
        a2 = rng.uniform(0.03, 0.12)
        fn = lambda t: 0.33 * (1 + a1 * np.sin(k * t + p1) + a2 * np.sin((k + 4) * t + p2))
    elif family == "ellipse":
        e = rng.uniform(1.2, 2.4)
        p = rng.uniform(0, np.pi)
        fn = lambda t: 0.36 / np.sqrt(np.cos(t - p) ** 2 * e + np.sin(t - p) ** 2 / e)
    elif family == "polygon":
        k = rng.randint(3, 7)
        p = rng.uniform(0, 2 * np.pi)
        # regular k-gon radius profile, slightly rounded by clipping
        fn = lambda t: 0.30 / np.clip(
            np.cos((np.mod(k * (t + p), 2 * np.pi) - np.pi) / k), 0.55, 1.0
        )
    elif family == "peanut":
        a = rng.uniform(0.25, 0.45)
        p = rng.uniform(0, np.pi)
        fn = lambda t: 0.34 * (1 - a * np.abs(np.sin(t - p))) * (1 + 0.05 * np.sin(3 * t))
    elif family == "notch":
        w = rng.uniform(0.25, 0.6)
        p = rng.uniform(0, 2 * np.pi)
        depth = rng.uniform(0.3, 0.55)

        def fn(t):
            d = np.abs(np.mod(t - p + np.pi, 2 * np.pi) - np.pi)
            return 0.36 * np.where(d < w, 1 - depth * (1 - d / w), 1.0)
    else:
        raise ValueError(f"unknown family {family!r}")
    return _radial_icon(fn, size)


def suite_icon(i: int, size: int = 64) -> np.ndarray:
    """Deterministic diverse icon #i (cycles through the families)."""
    return synthetic_icon(seed=i // len(FAMILIES), family=FAMILIES[i % len(FAMILIES)], size=size)
