"""Undistortion + rectification as precomputed remap grids + device gather.

Counterpart of the reference's ``StereoRectifier``
(stereo_rectifier.cpp:6-14 precomputes ``cv::initUndistortRectifyMap`` tables
once in the constructor; ``rectify`` then calls ``cv::remap`` with
INTER_LINEAR per eye, stereo_rectifier.cpp:39-40).

Design: the map from rectified pixel -> source pixel depends only on the
calibration, so it is computed **once on host** (pure numpy, parity-tested
against cv2.initUndistortRectifyMap) and decomposed into integer corner
indices + bilinear weights. Per frame the device does 4 flat gathers + a
lerp — a bandwidth-bound op XLA fuses well; batching over frames rides the
same constant tables.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..calib.config import StereoRig

__all__ = ["compute_rectify_map", "RemapGrid", "build_remap_grids",
           "remap_bilinear", "rectify_pair"]


def compute_rectify_map(K: np.ndarray, dist: np.ndarray, R: np.ndarray,
                        P: np.ndarray, size: Tuple[int, int]
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Float remap tables (map_x, map_y), each (H, W) float32.

    Same math as cv::initUndistortRectifyMap (Brown-Conrady 5-coefficient
    model k1,k2,p1,p2,k3): for every *rectified* pixel, back-project through
    the new projection ``P``, un-rotate by ``R``, re-distort, and project
    through the original ``K`` — yielding the source-image sampling point.
    """
    w, h = size
    K = np.asarray(K, np.float64)
    dist = np.asarray(dist, np.float64).reshape(-1)
    k1, k2, p1, p2, k3 = (list(dist) + [0.0] * 5)[:5]
    P = np.asarray(P, np.float64)
    A = P[:3, :3]  # new camera matrix
    iR = np.linalg.inv(A @ np.asarray(R, np.float64))

    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    X = iR[0, 0] * u + iR[0, 1] * v + iR[0, 2]
    Y = iR[1, 0] * u + iR[1, 1] * v + iR[1, 2]
    W = iR[2, 0] * u + iR[2, 1] * v + iR[2, 2]
    x = X / W
    y = Y / W
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    s = K[0, 1]
    map_x = (fx * xd + s * yd + cx).astype(np.float32)
    map_y = (fy * yd + cy).astype(np.float32)
    return map_x, map_y


@dataclasses.dataclass(frozen=True)
class RemapGrid:
    """Bilinear remap decomposed for device gathers.

    ``idx00`` is the flat source index of the top-left corner; ``wx, wy``
    the fractional weights; ``valid`` masks samples whose 2x2 support lies
    fully inside the source (outside -> 0, OpenCV BORDER_CONSTANT default).
    """
    idx00: jnp.ndarray  # (H, W) int32 flat index  y0*W + x0
    wx: jnp.ndarray     # (H, W) float32
    wy: jnp.ndarray     # (H, W) float32
    valid: jnp.ndarray  # (H, W) bool
    src_shape: Tuple[int, int]

    @classmethod
    def from_maps(cls, map_x: np.ndarray, map_y: np.ndarray,
                  src_shape: Tuple[int, int]) -> "RemapGrid":
        hs, ws = src_shape
        x0 = np.floor(map_x).astype(np.int64)
        y0 = np.floor(map_y).astype(np.int64)
        wx = (map_x - x0).astype(np.float32)
        wy = (map_y - y0).astype(np.float32)
        valid = (x0 >= 0) & (x0 + 1 <= ws - 1) & (y0 >= 0) & (y0 + 1 <= hs - 1)
        x0c = np.clip(x0, 0, ws - 2)
        y0c = np.clip(y0, 0, hs - 2)
        idx = (y0c * ws + x0c).astype(np.int32)
        return cls(idx00=jnp.asarray(idx), wx=jnp.asarray(wx),
                   wy=jnp.asarray(wy), valid=jnp.asarray(valid),
                   src_shape=(hs, ws))


def build_remap_grids(rig: StereoRig) -> Tuple[RemapGrid, RemapGrid]:
    """Left/right rectification grids for a rig (the ctor work of
    StereoRectifier, stereo_rectifier.cpp:6-14)."""
    size = rig.image_size
    hs, ws = rig.height, rig.width
    mxl, myl = compute_rectify_map(rig.camera_matrix_left,
                                   rig.dist_coeffs_left, rig.R1, rig.P1, size)
    mxr, myr = compute_rectify_map(rig.camera_matrix_right,
                                   rig.dist_coeffs_right, rig.R2, rig.P2, size)
    return (RemapGrid.from_maps(mxl, myl, (hs, ws)),
            RemapGrid.from_maps(mxr, myr, (hs, ws)))


def remap_bilinear(img: jnp.ndarray, grid: RemapGrid,
                   precision: str = "f32") -> jnp.ndarray:
    """Bilinear remap of ``img`` (..., Hs, Ws) -> (..., H, W) float32.

    Leading batch dims are vmapped; out-of-source samples produce 0
    (cv::remap BORDER_CONSTANT semantics).

    ``precision="u8"`` packs the 2x2 bilinear neighborhood into
    one int32 (4 x uint8 lanes, built with three cheap rolls) so each
    output pixel needs ONE flat gather instead of four. The reference
    operates on 8-bit
    imagery end-to-end (cv::remap on CV_8U frames,
    stereo_rectifier.cpp:39-40), so rounding inputs to u8 matches what
    the reference's pipeline sees; StereoPipeline defaults to it. The
    default here stays the 4-gather exact-float path (float inputs pass
    through bit-exactly).
    """
    hs, ws = grid.src_shape

    def one_f32(im):
        flat = im.reshape(-1).astype(jnp.float32)
        i00 = grid.idx00
        v00 = jnp.take(flat, i00)
        v01 = jnp.take(flat, i00 + 1)
        v10 = jnp.take(flat, i00 + ws)
        v11 = jnp.take(flat, i00 + ws + 1)
        wx, wy = grid.wx, grid.wy
        top = v00 * (1 - wx) + v01 * wx
        bot = v10 * (1 - wx) + v11 * wx
        out = top * (1 - wy) + bot * wy
        return jnp.where(grid.valid, out, 0.0)

    def one_u8(im):
        q = jnp.clip(jnp.round(im), 0, 255).astype(jnp.int32)   # (Hs, Ws)
        right = jnp.concatenate([q[:, 1:], q[:, -1:]], axis=1)
        down = jnp.concatenate([q[1:], q[-1:]], axis=0)
        downright = jnp.concatenate([right[1:], right[-1:]], axis=0)
        packed = (q | (right << 8) | (down << 16) | (downright << 24))
        v = jnp.take(packed.reshape(-1), grid.idx00)
        v00 = (v & 0xFF).astype(jnp.float32)
        v01 = ((v >> 8) & 0xFF).astype(jnp.float32)
        v10 = ((v >> 16) & 0xFF).astype(jnp.float32)
        v11 = ((v >> 24) & 0xFF).astype(jnp.float32)
        wx, wy = grid.wx, grid.wy
        top = v00 * (1 - wx) + v01 * wx
        bot = v10 * (1 - wx) + v11 * wx
        out = top * (1 - wy) + bot * wy
        return jnp.where(grid.valid, out, 0.0)

    one = one_u8 if precision == "u8" else one_f32
    batch_shape = img.shape[:-2]
    if batch_shape:
        flat_in = img.reshape((-1,) + img.shape[-2:])
        out = jax.vmap(one)(flat_in)
        return out.reshape(batch_shape + out.shape[-2:])
    return one(img)


def rectify_pair(left: jnp.ndarray, right: jnp.ndarray,
                 grid_l: RemapGrid, grid_r: RemapGrid
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """StereoRectifier::rectify equivalent (stereo_rectifier.cpp:18-41):
    remap both eyes with their precomputed grids."""
    return remap_bilinear(left, grid_l), remap_bilinear(right, grid_r)
