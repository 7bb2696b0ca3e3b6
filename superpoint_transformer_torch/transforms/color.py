"""Color features and augmentations on the host, copies of the JAX
package's `transforms/color.py` (reference src/transforms/point.py:
ColorAutoContrast:409, ColorDrop:491, ColorNormalize:548 and the
rgb->hsv/lab conversions of PointFeatures:41), and the position helpers
beside them. All operate on numpy `Data`; RGB is float in [0, 1] after
loading (`rgb_to_float=True`).
"""
import numpy as np

__all__ = ['rgb_to_hsv', 'rgb_to_lab', 'add_color_features',
           'color_auto_contrast', 'color_drop', 'color_normalize',
           'center_position', 'room_position']


def rgb_to_hsv(rgb):
    """[N, 3] float RGB in [0,1] -> HSV in [0,1] (h normalized)."""
    r, g, b = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    mx = rgb.max(1)
    mn = rgb.min(1)
    d = mx - mn
    h = np.zeros_like(mx)
    nz = d > 1e-12
    idx = nz & (mx == r)
    h[idx] = ((g[idx] - b[idx]) / d[idx]) % 6
    idx = nz & (mx == g) & (mx != r)
    h[idx] = (b[idx] - r[idx]) / d[idx] + 2
    idx = nz & (mx == b) & (mx != r) & (mx != g)
    h[idx] = (r[idx] - g[idx]) / d[idx] + 4
    h = h / 6.0
    s = np.where(mx > 1e-12, d / np.maximum(mx, 1e-12), 0.0)
    return np.stack([h, s, mx], 1).astype(np.float32)


def rgb_to_lab(rgb):
    """[N, 3] float RGB in [0,1] -> CIE-LAB scaled to ~[0,1]."""
    def f(t):
        return np.where(t > 0.008856, np.cbrt(t),
                        7.787 * t + 16.0 / 116.0)
    rgb_lin = np.where(rgb > 0.04045,
                       ((rgb + 0.055) / 1.055) ** 2.4, rgb / 12.92)
    M = np.array([[0.412453, 0.357580, 0.180423],
                  [0.212671, 0.715160, 0.072169],
                  [0.019334, 0.119193, 0.950227]])
    xyz = rgb_lin @ M.T
    xyz = xyz / np.array([0.95047, 1.0, 1.08883])
    fx, fy, fz = f(xyz[:, 0]), f(xyz[:, 1]), f(xyz[:, 2])
    L = 116.0 * fy - 16.0
    a = 500.0 * (fx - fy)
    b = 200.0 * (fy - fz)
    return np.stack([L / 100.0, a / 128.0 + 0.5, b / 128.0 + 0.5],
                    1).astype(np.float32)


def add_color_features(data, keys=('hsv',)):
    """Derive 'hsv' / 'lab' attributes from 'rgb'."""
    rgb = data.get('rgb')
    if rgb is None:
        return data
    rgb = np.asarray(rgb, np.float32)
    if rgb.max() > 1.5:
        rgb = rgb / 255.0
    if 'hsv' in keys:
        data['hsv'] = rgb_to_hsv(rgb)
    if 'lab' in keys:
        data['lab'] = rgb_to_lab(rgb)
    return data


def color_auto_contrast(data, rng=None, p=0.2, blend=None):
    """Randomly stretch colors to full contrast (reference
    ColorAutoContrast, src/transforms/point.py:409)."""
    rgb = data.get('rgb')
    if rgb is None:
        return data
    rng = rng or np.random.default_rng()
    if rng.random() > p:
        return data
    rgb = np.asarray(rgb, np.float32)
    lo = rgb.min(0, keepdims=True)
    hi = rgb.max(0, keepdims=True)
    stretched = (rgb - lo) / np.maximum(hi - lo, 1e-12)
    t = rng.random() if blend is None else blend
    data['rgb'] = ((1 - t) * rgb + t * stretched).astype(np.float32)
    return data


def color_drop(data, rng=None, p=0.2):
    """Zero all colors with probability p (reference ColorDrop,
    src/transforms/point.py:491)."""
    rgb = data.get('rgb')
    if rgb is None:
        return data
    rng = rng or np.random.default_rng()
    if rng.random() < p:
        data['rgb'] = np.zeros_like(np.asarray(rgb, np.float32))
    return data


def color_normalize(data, mean=None, std=None):
    """Standardize colors (reference ColorNormalize,
    src/transforms/point.py:548)."""
    rgb = data.get('rgb')
    if rgb is None:
        return data
    rgb = np.asarray(rgb, np.float32)
    mean = rgb.mean(0, keepdims=True) if mean is None else mean
    std = rgb.std(0, keepdims=True) if std is None else std
    data['rgb'] = (rgb - mean) / np.maximum(std, 1e-12)
    return data


def center_position(data):
    """Recenter XY(Z) on the origin (reference CenterPosition,
    src/transforms/geometry.py:14); keeps `pos_offset`."""
    pos = np.asarray(data.pos)
    offset = pos.mean(0)
    data['pos'] = (pos - offset).astype(np.float32)
    data['pos_offset'] = data.get('pos_offset', 0) + offset
    return data


def room_position(data):
    """Per-room normalized position in [0,1]^2 x [0,1] (reference
    RoomPosition, src/transforms/point.py:329) -> 'pos_room'."""
    pos = np.asarray(data.pos)
    lo = pos.min(0)
    hi = pos.max(0)
    data['pos_room'] = (
        (pos - lo) / np.maximum(hi - lo, 1e-12)).astype(np.float32)
    return data
