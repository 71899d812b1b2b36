"""Visualization: disparity/depth heatmaps with the reference's exact
display semantics (gamma, EMA temporal smoothing, TURBO colormap,
overlay blending) — host-side numpy; rendering is not a device concern.

Reference behaviors reproduced:
- show_disparityMap (stereo_disparity.cpp:42-73): mask disp>0, normalize
  by numDisparities, gamma 0.6, 8-bit, EMA α=0.63 with previous frame;
- show_depthMap (stereo_disparity.cpp:83-124): Z channel, validity
  0<Z<10000 & finite, min/max smoothed with α=0.1 and clamped, TURBO
  colormap, EMA α=0.63;
- overlay (stereo_displayer.cpp:167-183): colormapped disparity resized
  to full res, addWeighted 0.7*image + 0.3*heat.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["turbo_colormap", "DisparityVis", "DepthVis", "overlay_heat",
           "draw_epipolar_lines"]


def _turbo_lut() -> np.ndarray:
    """256-entry RGB turbo LUT via the published polynomial approximation
    (Google AI blog, 2019)."""
    x = np.linspace(0.0, 1.0, 256)
    r = np.array([0.13572138, 4.61539260, -42.66032258, 132.13108234,
                  -152.94239396, 59.28637943])
    g = np.array([0.09140261, 2.19418839, 4.84296658, -14.18503333,
                  4.27729857, 2.82956604])
    b = np.array([0.10667330, 12.64194608, -60.58204836, 110.36276771,
                  -89.90310912, 27.34824973])

    def poly(c):
        v = np.zeros_like(x)
        for i, coef in enumerate(c):
            v += coef * x ** i
        return np.clip(v, 0, 1)

    lut = np.stack([poly(r), poly(g), poly(b)], axis=1)
    return (lut * 255).astype(np.uint8)


_TURBO = _turbo_lut()


def turbo_colormap(values01: np.ndarray) -> np.ndarray:
    """(H, W) in [0,1] -> (H, W, 3) RGB uint8 (COLORMAP_TURBO analog)."""
    idx = np.clip(values01 * 255.0, 0, 255).astype(np.uint8)
    return _TURBO[idx]


class DisparityVis:
    """show_disparityMap semantics with temporal EMA state."""

    def __init__(self, num_disparities: int, gamma: float = 0.6,
                 ema_alpha: float = 0.63):
        self.num_disparities = num_disparities
        self.gamma = gamma
        self.ema_alpha = ema_alpha
        self._prev: Optional[np.ndarray] = None

    def __call__(self, disp: np.ndarray) -> np.ndarray:
        disp = np.asarray(disp, np.float32)
        valid = disp > 0
        norm = np.clip(disp / self.num_disparities, 0.0, 1.0)
        norm = np.where(valid, norm ** self.gamma, 0.0)
        vis = (norm * 255.0).astype(np.float32)
        if self._prev is not None:
            vis = self.ema_alpha * vis + (1 - self.ema_alpha) * self._prev
        self._prev = vis
        return vis.astype(np.uint8)

    def reset(self) -> None:
        self._prev = None


class DepthVis:
    """show_depthMap semantics: smoothed min/max normalization + TURBO
    + EMA."""

    def __init__(self, z_max: float = 10000.0, range_alpha: float = 0.1,
                 ema_alpha: float = 0.63):
        self.z_max = z_max
        self.range_alpha = range_alpha
        self.ema_alpha = ema_alpha
        self._min: Optional[float] = None
        self._max: Optional[float] = None
        self._prev: Optional[np.ndarray] = None

    def __call__(self, depth_z: np.ndarray) -> np.ndarray:
        z = np.asarray(depth_z, np.float32)
        valid = np.isfinite(z) & (z > 0) & (z < self.z_max)
        if valid.any():
            zmin = float(z[valid].min())
            zmax = float(z[valid].max())
        else:
            zmin, zmax = 0.0, self.z_max
        if self._min is None:
            self._min, self._max = zmin, zmax
        else:
            a = self.range_alpha
            self._min = (1 - a) * self._min + a * zmin
            self._max = (1 - a) * self._max + a * zmax
        lo, hi = self._min, max(self._max, self._min + 1e-3)
        norm = np.clip((z - lo) / (hi - lo), 0.0, 1.0)
        norm = np.where(valid, norm, 0.0)
        rgb = turbo_colormap(norm).astype(np.float32)
        if self._prev is not None:
            rgb = self.ema_alpha * rgb + (1 - self.ema_alpha) * self._prev
        self._prev = rgb
        return rgb.astype(np.uint8)

    def reset(self) -> None:
        self._min = self._max = None
        self._prev = None


def overlay_heat(image_gray: np.ndarray, disp_vis: np.ndarray,
                 w_img: float = 0.7, w_heat: float = 0.3) -> np.ndarray:
    """addWeighted(image, 0.7, heat, 0.3) overlay
    (stereo_displayer.cpp:167-183); disp_vis is upsampled to the image
    size with nearest-neighbor if needed."""
    img = np.asarray(image_gray, np.float32)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    heat = turbo_colormap(np.asarray(disp_vis, np.float32) / 255.0
                          ).astype(np.float32)
    if heat.shape[:2] != img.shape[:2]:
        ys = (np.arange(img.shape[0]) * heat.shape[0]
              // img.shape[0]).clip(0, heat.shape[0] - 1)
        xs = (np.arange(img.shape[1]) * heat.shape[1]
              // img.shape[1]).clip(0, heat.shape[1] - 1)
        heat = heat[np.ix_(ys, xs)]
    out = w_img * img + w_heat * heat
    return np.clip(out, 0, 255).astype(np.uint8)


def draw_epipolar_lines(image: np.ndarray, spacing: int = 30,
                        color=(0, 255, 0)) -> np.ndarray:
    """Horizontal epipolar guide lines every ``spacing`` px — the
    rectification sanity overlay (StereoRectifier::drawEpipolarLines,
    stereo_rectifier.cpp:44-51: green lines every 30 px). Returns an RGB
    copy."""
    img = np.asarray(image)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    out = img.astype(np.uint8).copy()
    out[::spacing, :, :] = np.asarray(color, np.uint8)
    return out
