"""Icon image -> 2D object contour.

Behavior-matches the reference pipeline (``assets/icon_process.py:7-54``):
resize to 128x128, grayscale, binary-inverse threshold at 240, outer contours,
keep the longest by arc length, resample to ``num_points`` by arc length
(quantized to integer pixel coords, as the reference does), then rescale to
[-0.05, 0.05].

cv2 is used when present; a pure-numpy fallback (boundary tracing on the
binarized mask) covers environments without it.

PyTorch port: numpy copy of ``dgdm_tpu/geom/contour.py``, plus the icon
sources of ``dgdm_tpu/cli/datagen.py:23-40`` (``load_icon``,
``synthetic_icon``) that the sample CLI reads test objects with.
"""

from __future__ import annotations

import numpy as np

try:  # pragma: no cover - import guard
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False


def resample_contour(contour: np.ndarray, num_points: int) -> np.ndarray:
    """Arc-length uniform resampling, int-pixel quantized like the reference
    (``assets/icon_process.py:7-27``)."""
    contour = contour.reshape(-1, 2).astype(np.float64)
    distances = np.sqrt(np.sum(np.diff(contour, axis=0) ** 2, axis=1))
    cumulative = np.concatenate([[0.0], np.cumsum(distances)])
    uniform = np.linspace(0.0, cumulative[-1], num_points)
    x = np.interp(uniform, cumulative, contour[:, 0])
    y = np.interp(uniform, cumulative, contour[:, 1])
    return np.stack([x, y], axis=-1).astype(np.int32)


def _binarize(image: np.ndarray, size: int, threshold: int) -> np.ndarray:
    if _HAS_CV2:
        image = cv2.resize(image, (size, size))
        gray = cv2.cvtColor(image, cv2.COLOR_BGR2GRAY)
        _, mask = cv2.threshold(gray, threshold, 255, cv2.THRESH_BINARY_INV)
        return mask
    # numpy fallback: nearest resize + BGR->gray with cv2 weights
    h, w = image.shape[:2]
    yi = (np.arange(size) * h // size).clip(0, h - 1)
    xi = (np.arange(size) * w // size).clip(0, w - 1)
    img = image[np.ix_(yi, xi)]
    gray = (
        0.114 * img[..., 0] + 0.587 * img[..., 1] + 0.299 * img[..., 2]
    )
    return np.where(gray <= threshold, 255, 0).astype(np.uint8)


def _trace_boundary(mask: np.ndarray) -> np.ndarray:
    """Moore-neighbor boundary tracing of the largest connected component.
    Fallback path when cv2 is unavailable; returns (N, 2) as (x, y)."""
    from scipy import ndimage

    labels, num = ndimage.label(mask > 0)
    if num == 0:
        raise ValueError("empty mask")
    sizes = ndimage.sum(mask > 0, labels, range(1, num + 1))
    comp = (labels == (1 + int(np.argmax(sizes))))
    ys, xs = np.nonzero(comp)
    start = (ys[np.lexsort((xs, ys))[0]], xs[np.lexsort((xs, ys))[0]])
    # Moore neighborhood (N, NE, E, SE, S, SW, W, NW); start scanning from
    # the W neighbour of the top-left-most pixel (guaranteed outside)
    nbrs = [(-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1)]
    contour = [start]
    prev_dir = 2  # pretend we arrived moving east
    first_move = None
    cur = start
    h, w = comp.shape
    for _ in range(8 * comp.sum()):
        found = False
        for k in range(8):
            d = (prev_dir + 5 + k) % 8  # backtrack + 1, sweep clockwise
            ny, nx = cur[0] + nbrs[d][0], cur[1] + nbrs[d][1]
            if 0 <= ny < h and 0 <= nx < w and comp[ny, nx]:
                cur = (ny, nx)
                prev_dir = d
                contour.append(cur)
                found = True
                break
        if not found:
            break
        if first_move is None:
            first_move = prev_dir
        elif cur == start and prev_dir == first_move:
            break
    pts = np.asarray(contour, dtype=np.float64)
    return pts[:, ::-1]  # (x, y)


def extract_contours(
    image: np.ndarray,
    num_points: int = 100,
    rescale: bool = True,
    image_size: int = 128,
    threshold: int = 240,
) -> np.ndarray:
    """(H, W, 3) uint8 image -> (num_points, 2) contour."""
    mask = _binarize(np.asarray(image), image_size, threshold)
    if _HAS_CV2:
        contours, _ = cv2.findContours(
            mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE
        )
        lengths = [cv2.arcLength(c, True) for c in contours]
        contour = contours[int(np.argmax(lengths))]
    else:
        contour = _trace_boundary(mask)
    resampled = resample_contour(contour, num_points).astype(np.float64)
    if rescale:
        resampled = resampled / image_size * (2 * 0.05) - 0.05
    return resampled


def ensure_ccw(contour: np.ndarray) -> np.ndarray:
    """Orient a polygon counter-clockwise (positive signed area)."""
    x, y = contour[:, 0], contour[:, 1]
    area2 = np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)
    return contour if area2 >= 0 else contour[::-1].copy()


# -- icon sources (dgdm_tpu/cli/datagen.py:23-40) ---------------------------


def load_icon(object_dir: str, idx: int) -> np.ndarray:
    data = np.load(object_dir, allow_pickle=True).item()
    return data["image"][idx].transpose((1, 2, 0))


def synthetic_icon(idx: int, size: int = 64) -> np.ndarray:
    rng = np.random.RandomState(idx)
    yy, xx = np.mgrid[0:size, 0:size]
    c = size / 2
    ang = np.arctan2(yy - c, xx - c)
    r = np.hypot(xx - c, yy - c)
    rad = size * 0.35 * (
        1 + 0.25 * np.sin(3 * ang + rng.uniform(0, 6)) + 0.1 * np.sin(7 * ang)
    )
    img = np.where(r < rad, 30, 255).astype(np.uint8)
    return np.stack([img] * 3, -1)
