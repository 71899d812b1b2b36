"""End-to-end stereo depth pipeline: rectify → SGBM → WLS → reproject.

Framework counterpart of the reference's per-frame hot loop
(stereo_displayer.cpp:145-198 → StereoRectifier::rectify →
StereoDisparity::computeDisparity → computeDepth): one jitted XLA program
per frame pair (or batch of pairs), all stages fused on device.

Mirrored behaviors:
- optional 0.5x downscale before matching (the reference always matches at
  half resolution, stereo_disparity.cpp:22-24; INTER_AREA 0.5 == exact 2x2
  mean);
- BGR→gray conversion with OpenCV weights (stereo_disparity.cpp:19-20);
- WLS left/right-matcher filtering (stereo_disparity.cpp:26-31);
- the half-res-Q reprojection quirk is opt-in via ``quirk_compat``
  (SURVEY.md §2.4 — default is geometrically correct scaling).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .calib.config import StereoRig
from .ops.backend import select_aggregator
from .ops.remap import RemapGrid, build_remap_grids, remap_bilinear
from .ops.reproject import reproject_to_3d
from .ops.sgbm import SGBMParams, sgbm
from .ops.wls import wls_disparity_filter

__all__ = ["PipelineConfig", "StereoPipeline", "bgr_to_gray", "downscale2x"]


def bgr_to_gray(img: jnp.ndarray) -> jnp.ndarray:
    """(..., H, W, 3) BGR -> (..., H, W) gray, OpenCV weights."""
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    return 0.114 * b + 0.587 * g + 0.299 * r


def downscale2x(img: jnp.ndarray) -> jnp.ndarray:
    """INTER_AREA 0.5x == exact 2x2 mean (stereo_disparity.cpp:22-24)."""
    h, w = img.shape[-2] // 2 * 2, img.shape[-1] // 2 * 2
    img = img[..., :h, :w]
    s = img.shape
    return img.reshape(s[:-2] + (h // 2, 2, w // 2, 2)).mean(axis=(-3, -1))


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Typed pipeline configuration (SURVEY.md §5 'config system': one
    config object instead of the reference's hard-coded constants)."""
    sgbm: SGBMParams = SGBMParams()
    downscale: int = 2            # 1 = full res; 2 = reference behavior
    use_wls: bool = True
    lr_mode: str = "right_matcher"  # "right_matcher" | "fast" | "none"
    quirk_compat: bool = False    # replicate full-res-Q-on-half-res-disp
    handle_missing: bool = False
    z_max_mm: float = 12000.0
    with_stats: bool = True       # per-frame stats (valid frac, coverage,
    #                               mean depth) reduced inside the forward
    #                               program: one execute per batch and a
    #                               12 B/frame fetch when nothing needs
    #                               the maps
    remap_precision: str = "u8"   # "u8" (reference-faithful single-gather
    #                               rectify; REQUIRES 0-255 8-bit-range
    #                               inputs — values are rounded/clipped) |
    #                               "f32" (exact, any range)


class StereoPipeline:
    """Precomputes remap grids once (like the StereoRectifier ctor) and
    exposes jitted per-pair / per-batch processing."""

    def __init__(self, rig: StereoRig, config: PipelineConfig = PipelineConfig(),
                 rectify: bool = True, aggregator=None):
        self.rig = rig
        self.config = config
        self.rectify = rectify
        self._aggregator = aggregator
        self._matcher = self._pick_matcher()
        if rectify:
            self.grid_l, self.grid_r = build_remap_grids(rig)
        else:
            self.grid_l = self.grid_r = None
        self._forward = jax.jit(self._build_forward())
        self._forward_batch = jax.jit(jax.vmap(self._build_forward()))

    def _pick_matcher(self):
        """The jnp matcher with the platform's SGM aggregator
        (ops/backend.py), unless one was injected."""
        return partial(sgbm, aggregator=self._aggregator
                       or select_aggregator())

    # -- stage functions ---------------------------------------------------
    def _build_forward(self):
        cfg = self.config
        rig = self.rig
        scale = 1.0 / cfg.downscale

        def forward(left: jnp.ndarray, right: jnp.ndarray) -> Dict[str, jnp.ndarray]:
            left = left.astype(jnp.float32)
            right = right.astype(jnp.float32)
            if left.ndim == 3:  # color input
                left = bgr_to_gray(left)
                right = bgr_to_gray(right)
            if self.rectify:
                left = remap_bilinear(left, self.grid_l,
                                      precision=cfg.remap_precision)
                right = remap_bilinear(right, self.grid_r,
                                       precision=cfg.remap_precision)
            lrect, rrect = left, right
            for _ in range(_log2(cfg.downscale)):
                left = downscale2x(left)
                right = downscale2x(right)

            matcher = self._matcher
            if cfg.use_wls and cfg.lr_mode == "right_matcher":
                # left + right matcher as ONE batched (2, H, W) call, so
                # the two matchers share each launch
                pair_l = jnp.stack([left, right[:, ::-1]])
                pair_r = jnp.stack([right, left[:, ::-1]])
                dd = jax.vmap(lambda a, b: matcher(a, b, cfg.sgbm))(
                    pair_l, pair_r)
                disp_l, disp_r = dd[0], dd[1][:, ::-1]
                disp, conf = wls_disparity_filter(disp_l, disp_r, left)
            else:
                disp = matcher(left, right, cfg.sgbm,
                               apply_lr=cfg.lr_mode != "none")
                conf = (disp >= 0).astype(jnp.float32)

            # chw layout on device (three contiguous planes); convert on
            # host with xyz_hwc (zero-copy view)
            xyz = reproject_to_3d(disp, rig.Q, scale=scale,
                                  quirk_compat=cfg.quirk_compat,
                                  handle_missing=cfg.handle_missing,
                                  layout="chw")
            out = {"disparity": disp, "xyz": xyz, "confidence": conf,
                   "left_rectified": lrect, "right_rectified": rrect}
            if cfg.with_stats:
                from .metrics import batch_frame_stats
                out["frame_stats"] = batch_frame_stats(
                    disp, xyz[..., 2, :, :],
                    skip_cols=cfg.sgbm.num_disparities)
            return out

        return forward

    # -- public API --------------------------------------------------------
    @staticmethod
    def xyz_hwc(xyz_chw) -> np.ndarray:
        """Device (..., 3, H, W) xyz -> host (..., H, W, 3) numpy view."""
        return np.moveaxis(np.asarray(xyz_chw), -3, -1)

    def process_pair(self, left, right) -> Dict[str, jnp.ndarray]:
        """One frame pair -> disparity (matcher res), xyz (mm, shape
        (3, H, W) on device — use xyz_hwc for the (H, W, 3) numpy view),
        confidence, rectified eyes (full res)."""
        self._check_input_range(left)
        return self._forward(jnp.asarray(left), jnp.asarray(right))

    def process_batch(self, lefts, rights) -> Dict[str, jnp.ndarray]:
        """(N, H, W[,3]) batches, vmapped on device."""
        self._check_input_range(lefts)
        return self._forward_batch(jnp.asarray(lefts), jnp.asarray(rights))

    def _check_input_range(self, arr) -> None:
        """remap_precision='u8' rounds/clips rectified samples to 0-255;
        normalized (0..1) float input would be silently destroyed. Cheap
        host-side check on numpy inputs, warns once."""
        if (self.config.remap_precision != "u8" or not self.rectify
                or getattr(self, "_range_warned", False)):
            return
        if isinstance(arr, np.ndarray) and arr.dtype.kind == "f" \
                and arr.size and float(arr.max()) <= 1.0:
            import warnings
            warnings.warn(
                "remap_precision='u8' expects 0-255 inputs but got float "
                "data with max <= 1.0 — values will be quantized to "
                "{0, 1}. Scale to 0-255 or set remap_precision='f32'.",
                stacklevel=3)
            self._range_warned = True

    def process_sbs(self, frame) -> Dict[str, jnp.ndarray]:
        """Side-by-side frame (H, 2W[,3]) -> split at W then process (the
        reference's split via cv::Rect views, stereo_displayer.cpp:155-156)."""
        w = self.rig.width
        return self.process_pair(frame[:, :w], frame[:, w:2 * w])


def _log2(n: int) -> int:
    k = 0
    while (1 << k) < n:
        k += 1
    assert (1 << k) == n, f"downscale must be a power of 2, got {n}"
    return k
