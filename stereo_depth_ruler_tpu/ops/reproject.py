"""Disparity -> metric 3D reprojection via the calibration Q matrix.

Counterpart of StereoDisparity::computeDepth
(stereo_disparity.cpp:76-80, cv::reprojectImageTo3D): closed-form, 4 FMAs
per pixel, trivially batched/jitted.

Reference quirk (SURVEY.md §2.4 ⚠): the reference applies the
*full-resolution* Q to a *half-resolution* disparity map, so both the
disparity values and the principal point are 2x off vs. the true geometry;
its persisted measurements (results/measurements.csv) embed that behavior.
This framework defaults to the geometrically-correct scaling — when the
matcher ran at ``scale`` < 1, Q is adjusted so metric output is unchanged —
and offers ``quirk_compat=True`` to replicate the reference bit-for-bit for
parity testing. The choice is validated in tests/test_measure.py.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

__all__ = ["scale_q", "reproject_to_3d", "depth_from_disparity"]


def scale_q(Q: np.ndarray, scale: float) -> np.ndarray:
    """Adjust a reprojection matrix for a disparity map computed at
    ``scale`` x the calibration resolution.

    At scale s: pixel coords x_s = s*x, disparity d_s = s*d. Reprojection
    must use x = x_s/s, d = d_s/s — equivalent to scaling Q's pixel-space
    columns: Q' = Q @ diag(1/s, 1/s, 1/s, 1).
    """
    Q = np.asarray(Q, np.float64)
    S = np.diag([1.0 / scale, 1.0 / scale, 1.0 / scale, 1.0])
    return Q @ S


def reproject_to_3d(disp: jnp.ndarray, Q,
                    scale: float = 1.0,
                    quirk_compat: bool = False,
                    handle_missing: bool = False,
                    missing_z: float = 10000.0,
                    row_offset=0, col_offset=0,
                    layout: str = "hwc") -> jnp.ndarray:
    """(..., H, W) float disparity -> (..., H, W, 3) XYZ in calibration
    units (mm for the reference rig).

    [X Y Z W]^T = Q [x y d 1]^T, output XYZ/W. Invalid disparities
    (d <= 0, the -1.0 sentinel) produce Z = inf, or Z = ``missing_z``
    when ``handle_missing`` (cv::reprojectImageTo3D handleMissingValues
    analog, pcd_write.cpp:115-116).

    ``layout='chw'`` returns (..., 3, H, W) instead: three contiguous
    planes, written without interleaving; device-resident pipelines use
    it and convert on host (a zero-copy numpy moveaxis view).
    """
    Q = np.asarray(Q, np.float64)
    if scale != 1.0 and not quirk_compat:
        Q = scale_q(Q, scale)
    Qj = jnp.asarray(Q, jnp.float32)
    h, w = disp.shape[-2], disp.shape[-1]
    # row/col offsets support spatially-sharded execution: a tile holding
    # global rows [off, off+h) must reproject with its global pixel coords
    xs = jnp.arange(w, dtype=jnp.float32)[None, :] + col_offset
    ys = jnp.arange(h, dtype=jnp.float32)[:, None] + row_offset
    xs = jnp.broadcast_to(xs, disp.shape)
    ys = jnp.broadcast_to(ys, disp.shape)
    d = disp.astype(jnp.float32)

    def homo(row):
        return (Qj[row, 0] * xs + Qj[row, 1] * ys
                + Qj[row, 2] * d + Qj[row, 3])

    X, Y, Z, W = homo(0), homo(1), homo(2), homo(3)
    invalid = d <= 0
    Wsafe = jnp.where(jnp.abs(W) < 1e-12, 1e-12, W)
    axis = -1 if layout == "hwc" else -3
    expand = (lambda m: m[..., None]) if layout == "hwc" \
        else (lambda m: m[..., None, :, :])
    xyz = jnp.stack([X / Wsafe, Y / Wsafe, Z / Wsafe], axis=axis)
    if handle_missing:
        fill = jnp.stack([X / Wsafe, Y / Wsafe,
                          jnp.full_like(Z, missing_z)], axis=axis)
        xyz = jnp.where(expand(invalid), fill, xyz)
    else:
        xyz = jnp.where(expand(invalid), jnp.inf, xyz)
    return xyz


def depth_from_disparity(disp: jnp.ndarray, Q, scale: float = 1.0,
                         quirk_compat: bool = False) -> jnp.ndarray:
    """Z channel only: Z = Q23 / (Q32 * d) for the canonical rectified Q."""
    return reproject_to_3d(disp, Q, scale=scale,
                           quirk_compat=quirk_compat)[..., 2]
