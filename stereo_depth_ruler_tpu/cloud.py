"""Colored point-cloud generation path.

Framework counterpart of the reference's ``point_cloud`` binary
(point_cloud/src/pcd_write.cpp:53-155): disparity -> reprojectImageTo3D
(handleMissingValues=true) -> colorize from the left image -> VoxelGrid
downsample -> binary PCD per frame. Differences by design:

- the reference's cloud path runs its own full-resolution SGBM with *no
  rectification and no WLS* (pcd_write.cpp:102-112); ``CloudConfig
  .reference_mode=True`` reproduces that (full-res matcher on the raw
  split frames), False reuses the main rectified pipeline;
- reprojection + colorization + voxel reduction run batched on device;
  only the final [:count] slice + file write happen on host;
- the leaf-size unit quirk is explicit (ops/voxel.py docstring): the
  reference passes 0.005 to PCL on mm-unit clouds; default here is the
  documented intent, 5 mm.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from pathlib import Path
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .calib.config import StereoRig
from .io.pcd import write_pcd
from .ops.backend import select_aggregator
from .ops.reproject import reproject_to_3d
from .ops.sgbm import SGBMParams, sgbm
from .ops.voxel import voxel_downsample

__all__ = ["CloudConfig", "PointCloudGenerator"]


@dataclasses.dataclass(frozen=True)
class CloudConfig:
    sgbm: SGBMParams = SGBMParams()
    leaf: float = 5.0                # mm; 0.005 replicates the quirk
    z_clip_mm: float = 10000.0       # drop points at/behind missing-Z fill
    reference_mode: bool = True      # raw full-res SGBM like pcd_write.cpp
    binary: bool = True
    organized: bool = False          # write the pre-voxel organized cloud


class PointCloudGenerator:
    """Builds colored, voxel-downsampled clouds from stereo frames."""

    def __init__(self, rig: StereoRig, config: CloudConfig = CloudConfig(),
                 matcher=None):
        self.rig = rig
        self.config = config
        self._matcher = matcher or partial(
            sgbm, aggregator=select_aggregator())
        self._compute = jax.jit(self._build())

    def _build(self):
        cfg = self.config
        Q = self.rig.Q

        def compute(left_gray, left_color):
            disp = self._matcher(left_gray[0], left_gray[1], cfg.sgbm)
            xyz = reproject_to_3d(disp, Q, handle_missing=True,
                                  missing_z=cfg.z_clip_mm)
            pts = xyz.reshape(-1, 3)
            cols = left_color.reshape(-1, 3).astype(jnp.float32)
            # drop invalid / missing-fill points before voxelization
            keep = (jnp.isfinite(pts).all(axis=1)
                    & (pts[:, 2] > 0) & (pts[:, 2] < cfg.z_clip_mm))
            pts = jnp.where(keep[:, None], pts, jnp.nan)
            vpts, vcols, count = voxel_downsample(pts, cols, cfg.leaf)
            return disp, vpts, vcols, count, pts

        return compute

    def cloud_from_pair(self, left: np.ndarray, right: np.ndarray,
                        left_color: Optional[np.ndarray] = None
                        ) -> Dict[str, np.ndarray]:
        """left/right grayscale (H, W); left_color optional (H, W, 3) BGR
        (the reference colors points from the left BGR image,
        pcd_write.cpp:35-44). Returns dict with points/colors/count/disp."""
        if left_color is None:
            left_color = np.repeat(np.asarray(left)[..., None], 3, axis=2)
        # BGR -> RGB for PCD packing
        rgb = np.ascontiguousarray(np.asarray(left_color)[..., ::-1])
        disp, vpts, vcols, count, opts = self._compute(
            jnp.stack([jnp.asarray(left, jnp.float32),
                       jnp.asarray(right, jnp.float32)]),
            jnp.asarray(rgb, jnp.float32))
        count = int(count)
        out = {
            "disparity": np.asarray(disp),
            "points": np.asarray(vpts)[:count],
            "colors": np.clip(np.asarray(vcols)[:count], 0, 255
                              ).astype(np.uint8),
            "count": count,
        }
        if self.config.organized:
            # pre-voxel organized cloud (convertCVMatToPCL parity:
            # width x height, invalid -> NaN, pcd_write.cpp:17-51)
            out["organized_points"] = np.asarray(opts)
            out["organized_colors"] = np.clip(
                rgb.reshape(-1, 3), 0, 255).astype(np.uint8)
            out["organized_shape"] = disp.shape
        return out

    def write_frame(self, out_dir, frame_index: int, left, right,
                    left_color=None) -> Path:
        """Full reference flow for one frame -> results/frame_%05d.pcd
        naming (pcd_write.cpp:141)."""
        out = self.cloud_from_pair(left, right, left_color)
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / f"frame_{frame_index:05d}.pcd"
        if self.config.organized:
            write_pcd(path, out["organized_points"],
                      out["organized_colors"], binary=self.config.binary,
                      organized_shape=out["organized_shape"])
        else:
            write_pcd(path, out["points"], out["colors"],
                      binary=self.config.binary)
        return path

    def process_sbs_video(self, frames: np.ndarray, out_dir,
                          target_frames=None) -> list:
        """Side-by-side frames (N, H, 2W[,3]) -> one PCD per selected
        frame (the reference exports frame 100 of cam.mp4,
        pcd_write.cpp:54-57)."""
        w = self.rig.width
        paths = []
        idxs = range(len(frames)) if target_frames is None else target_frames
        for i in idxs:
            f = frames[i]
            if f.ndim == 3:
                # OpenCV BGR weights, like every other ingest path
                # (pipeline.bgr_to_gray, io/video._convert; reference
                # cvtColor at pcd_write.cpp:87-89) — a plain channel
                # mean silently diverges the matcher's input
                from .pipeline import bgr_to_gray
                gray = np.asarray(bgr_to_gray(jnp.asarray(
                    f, jnp.float32)))
                color_l = f[:, :w]
            else:
                gray = f
                color_l = None
            paths.append(self.write_frame(out_dir, i, gray[:, :w],
                                          gray[:, w:2 * w], color_l))
        return paths
