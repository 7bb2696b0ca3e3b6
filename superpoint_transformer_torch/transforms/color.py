"""Color augmentations on the host: `color_auto_contrast` and
`color_drop`, copies of the JAX package's `transforms/color.py`
(reference src/transforms/point.py: ColorAutoContrast:409,
ColorDrop:491). RGB is float in [0, 1].
"""
import numpy as np

__all__ = ['color_auto_contrast', 'color_drop']


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
