"""Data-capture & developer utilities.

Framework counterparts of the reference's ``utils`` library
(utils/src/helper.cpp): calibration-frame capture, stills from video,
calibration-directory renaming, single-image disparity, and per-pixel
depth dumps. These are host-side dev tools; camera/GUI paths require
OpenCV and degrade gracefully without it (accelerator hosts are headless — the
capture loops also accept video files instead of live cameras, replacing
the reference's ZED SDK live path, helper.cpp:166-205).
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

__all__ = ["save_calibration_frames", "capture_frame", "change_filename",
           "image_disparity", "specific_depth_pixel", "split_sbs"]


def _cv2():
    import cv2
    return cv2


def split_sbs(frame: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Split a side-by-side frame into (left, right)
    (stereo_displayer.cpp:155-156)."""
    w = frame.shape[1] // 2
    return frame[:, :w], frame[:, w:]


def save_calibration_frames(source, out_left: str, out_right: str,
                            board=(8, 6), max_pairs: int = 50,
                            every_n: int = 10) -> int:
    """Harvest chessboard calibration pairs from a side-by-side video or
    camera index (``save_frames``, helper.cpp:20-80: the reference saves
    on SPACE when both eyes see the board; headless here — every
    ``every_n``-th frame where both eyes detect the 8x6 board is saved).
    Returns the number of pairs written."""
    cv2 = _cv2()
    cap = cv2.VideoCapture(source)
    Path(out_left).mkdir(parents=True, exist_ok=True)
    Path(out_right).mkdir(parents=True, exist_ok=True)
    saved = frame_i = 0
    while saved < max_pairs:
        ok, frame = cap.read()
        if not ok:
            break
        frame_i += 1
        if frame_i % every_n:
            continue
        left, right = split_sbs(frame)
        found_l, _ = cv2.findChessboardCorners(
            cv2.cvtColor(left, cv2.COLOR_BGR2GRAY), board,
            flags=cv2.CALIB_CB_FAST_CHECK)
        found_r, _ = cv2.findChessboardCorners(
            cv2.cvtColor(right, cv2.COLOR_BGR2GRAY), board,
            flags=cv2.CALIB_CB_FAST_CHECK)
        if found_l and found_r:
            cv2.imwrite(str(Path(out_left) / f"left_{saved:03d}.png"), left)
            cv2.imwrite(str(Path(out_right) / f"right_{saved:03d}.png"),
                        right)
            saved += 1
    cap.release()
    return saved


def capture_frame(video: str, frame_index: int,
                  out_path: Optional[str] = None) -> np.ndarray:
    """Grab one still from a video (``capture_frame``, helper.cpp:107-131
    — SPACE-triggered there, frame-indexed here)."""
    cv2 = _cv2()
    cap = cv2.VideoCapture(video)
    cap.set(cv2.CAP_PROP_POS_FRAMES, frame_index)
    ok, frame = cap.read()
    cap.release()
    if not ok:
        raise IOError(f"cannot read frame {frame_index} from {video}")
    if out_path:
        cv2.imwrite(out_path, frame)
    return frame


def change_filename(src_dir: str, left_dir: str, right_dir: str,
                    n_left: int = 27) -> Tuple[int, int]:
    """Split a flat capture directory into left_NN/right_NN sequences
    (``change_filename``, helper.cpp:82-104: first ``n_left`` files are
    the left eye). Returns (#left, #right)."""
    files = sorted(p for p in Path(src_dir).iterdir() if p.is_file())
    Path(left_dir).mkdir(parents=True, exist_ok=True)
    Path(right_dir).mkdir(parents=True, exist_ok=True)
    nl = nr = 0
    for i, p in enumerate(files):
        if i < n_left:
            shutil.copy2(p, Path(left_dir) / f"left_{nl:03d}{p.suffix}")
            nl += 1
        else:
            shutil.copy2(p, Path(right_dir) / f"right_{nr:03d}{p.suffix}")
            nr += 1
    return nl, nr


def image_disparity(sbs_image: np.ndarray, rig=None, params=None,
                    rectify: bool = True) -> np.ndarray:
    """Single side-by-side image -> float disparity map
    (``image_desparity``, helper.cpp:134-164: split, rectify, match).
    Returns (H, W) float32, invalid = -1."""
    import jax.numpy as jnp

    from ..calib.config import StereoRig
    from ..ops.remap import build_remap_grids, rectify_pair
    from ..ops.sgbm import SGBMParams
    from ..ops.sgbm import sgbm as sgbm_fn

    left, right = split_sbs(np.asarray(sbs_image))
    if left.ndim == 3:
        left = left.mean(axis=2)
        right = right.mean(axis=2)
    left = left.astype(np.float32)
    right = right.astype(np.float32)
    params = params or SGBMParams()
    if rectify and rig is not None:
        grids = build_remap_grids(rig)
        left, right = rectify_pair(jnp.asarray(left), jnp.asarray(right),
                                   grids)
    return np.asarray(sgbm_fn(jnp.asarray(left), jnp.asarray(right), params))


def specific_depth_pixel(xyz: np.ndarray) -> Iterator[Tuple[int, int, float]]:
    """Yield (y, x, Z) for every finite-depth pixel
    (``specific_depth_pixel``, helper.cpp:262-269)."""
    z = np.asarray(xyz)[..., 2]
    for y, x in np.argwhere(np.isfinite(z)):
        yield int(y), int(x), float(z[y, x])
