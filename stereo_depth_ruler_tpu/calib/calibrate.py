"""Offline chessboard stereo calibration — host-side tool.

Counterpart of the reference's ``StereoCalibrator``
(stereo_vision/src/stereo_calibrator.cpp:12-125): detect 8x6 inner-corner
chessboards (19 mm squares) in left/right frame directories, calibrate
each eye, stereo-calibrate, rectify (CALIB_ZERO_DISPARITY, alpha=0), and
emit the same YAML schema as config/stereo.yaml. Runs once on host —
not a device workload (SURVEY.md §2.2) — using OpenCV's calib3d (cv2 is the
host-side solver; the device pipeline never depends on it).

Also provides ``stereo_rectify_np``, a pure-NumPy reimplementation of
cv::stereoRectify's geometry (used when cv2 is unavailable and to
cross-check the OpenCV result in tests).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .config import StereoRig

__all__ = ["CalibrationSettings", "StereoCalibrator", "stereo_rectify_np"]


@dataclasses.dataclass
class CalibrationSettings:
    """Defaults mirror the reference constants
    (stereo_calibrator.hpp:9-12, stereo_calibrator.cpp:57-111)."""
    board_cols: int = 8          # inner corners per row
    board_rows: int = 6          # inner corners per column
    square_size_mm: float = 19.0
    min_valid_pairs: int = 20
    subpix_window: int = 11
    subpix_iters: int = 30
    subpix_eps: float = 1e-3
    stereo_iters: int = 100
    stereo_eps: float = 1e-5
    rectify_alpha: float = 0.0   # alpha=0 (crop to valid region)


def _object_points(s: CalibrationSettings) -> np.ndarray:
    """Planar chessboard grid (stereo_calibrator.cpp:16-21)."""
    pts = np.zeros((s.board_rows * s.board_cols, 3), np.float32)
    grid = np.mgrid[0:s.board_cols, 0:s.board_rows].T.reshape(-1, 2)
    pts[:, :2] = grid * s.square_size_mm
    return pts


def stereo_rectify_np(K1, d1, K2, d2, size, R, T, alpha=0.0
                      ) -> Tuple[np.ndarray, ...]:
    """cv::stereoRectify geometry (CALIB_ZERO_DISPARITY), pure NumPy.

    Returns (R1, R2, P1, P2, Q). Matches OpenCV's construction: split the
    inter-camera rotation between eyes, rotate so the baseline is the new
    x-axis, shared focal/principal point, Q from the rectified geometry.
    The alpha-scaling search is omitted (alpha=0 uses the average focal
    like OpenCV's initial estimate), so P differs from cv2 in the exact
    focal choice; R1/R2 match closely.
    """
    K1, K2 = np.asarray(K1, float), np.asarray(K2, float)
    R = np.asarray(R, float)
    T = np.asarray(T, float).reshape(3)
    w, h = size

    # split rotation: each camera rotates halfway
    angle_axis = _rotation_to_rodrigues(R)
    r_half = _rodrigues_to_rotation(-0.5 * angle_axis)
    t = r_half @ T

    # new x axis along the baseline
    e1 = t / np.linalg.norm(t)
    if t[0] < 0:
        e1 = -e1
    e2 = np.array([-t[1], t[0], 0.0])
    n2 = np.linalg.norm(e2)
    e2 = np.array([0.0, 1.0, 0.0]) if n2 < 1e-12 else e2 / n2
    e3 = np.cross(e1, e2)
    Rw = np.stack([e1, e2, e3], axis=0)
    if t[0] < 0:
        Rw = np.diag([-1.0, -1.0, 1.0]) @ Rw

    R1 = Rw @ r_half
    R2 = Rw @ _rodrigues_to_rotation(0.5 * angle_axis)

    f = 0.5 * (K1[1, 1] + K2[1, 1])
    cx = w / 2.0
    cy = h / 2.0
    tx = float((R2 @ T)[0]) if T[0] > 0 else -np.linalg.norm(T)
    P1 = np.array([[f, 0, cx, 0], [0, f, cy, 0], [0, 0, 1, 0]], float)
    P2 = P1.copy()
    P2[0, 3] = tx * f
    Q = np.array([
        [1, 0, 0, -cx],
        [0, 1, 0, -cy],
        [0, 0, 0, f],
        [0, 0, -1.0 / tx, 0],
    ], float)
    return R1, R2, P1, P2, Q


def _rotation_to_rodrigues(R: np.ndarray) -> np.ndarray:
    cos_t = np.clip((np.trace(R) - 1) / 2, -1, 1)
    theta = np.arccos(cos_t)
    if theta < 1e-12:
        return np.zeros(3)
    axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                     R[1, 0] - R[0, 1]]) / (2 * np.sin(theta))
    return axis * theta


def _rodrigues_to_rotation(r: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(r)
    if theta < 1e-12:
        return np.eye(3)
    k = r / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


class StereoCalibrator:
    """run_calibration-style workflow over frame directories or arrays."""

    def __init__(self, settings: CalibrationSettings = CalibrationSettings()):
        self.settings = settings
        self.rms_left: Optional[float] = None
        self.rms_right: Optional[float] = None
        self.rms_stereo: Optional[float] = None

    # -- detection --------------------------------------------------------
    def find_corners(self, image: np.ndarray) -> Optional[np.ndarray]:
        """Chessboard corners with subpixel refinement
        (stereo_calibrator.cpp:57-66). Returns (N, 2) or None."""
        import cv2
        s = self.settings
        img = np.asarray(image)
        if img.ndim == 3:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        flags = (cv2.CALIB_CB_ADAPTIVE_THRESH | cv2.CALIB_CB_NORMALIZE_IMAGE
                 | cv2.CALIB_CB_FAST_CHECK)
        found, corners = cv2.findChessboardCorners(
            img, (s.board_cols, s.board_rows), flags=flags)
        if not found:
            return None
        crit = (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER,
                s.subpix_iters, s.subpix_eps)
        corners = cv2.cornerSubPix(
            img, corners, (s.subpix_window, s.subpix_window), (-1, -1), crit)
        return corners.reshape(-1, 2)

    # -- calibration ------------------------------------------------------
    def calibrate_pairs(self, lefts: Sequence[np.ndarray],
                        rights: Sequence[np.ndarray]) -> StereoRig:
        """Full stereo calibration from image pairs
        (stereo_calibrator.cpp:12-125)."""
        import cv2
        s = self.settings
        obj = _object_points(s)
        objpoints, imgl, imgr = [], [], []
        for li, ri in zip(lefts, rights):
            cl = self.find_corners(li)
            cr = self.find_corners(ri)
            if cl is not None and cr is not None:
                objpoints.append(obj)
                imgl.append(cl.astype(np.float32))
                imgr.append(cr.astype(np.float32))
        if len(objpoints) < s.min_valid_pairs:
            raise ValueError(
                f"only {len(objpoints)} valid pairs, need "
                f"{s.min_valid_pairs} (stereo_calibrator.cpp:88-91)")
        h, w = np.asarray(lefts[0]).shape[:2]
        size = (w, h)
        self.rms_left, K1, d1, _, _ = cv2.calibrateCamera(
            objpoints, imgl, size, None, None)
        self.rms_right, K2, d2, _, _ = cv2.calibrateCamera(
            objpoints, imgr, size, None, None)
        crit = (cv2.TERM_CRITERIA_MAX_ITER + cv2.TERM_CRITERIA_EPS,
                s.stereo_iters, s.stereo_eps)
        self.rms_stereo, K1, d1, K2, d2, R, T, E, F = cv2.stereoCalibrate(
            objpoints, imgl, imgr, K1, d1, K2, d2, size,
            criteria=crit, flags=0)
        R1, R2, P1, P2, Q, _, _ = cv2.stereoRectify(
            K1, d1, K2, d2, size, R, T,
            flags=cv2.CALIB_ZERO_DISPARITY, alpha=s.rectify_alpha)
        return StereoRig(
            image_size=size,
            camera_matrix_left=K1, dist_coeffs_left=d1.reshape(1, -1),
            camera_matrix_right=K2, dist_coeffs_right=d2.reshape(1, -1),
            R=R, T=T.reshape(3, 1), E=E, F=F,
            R1=R1, R2=R2, P1=P1, P2=P2, Q=Q)

    def calibrate_dirs(self, left_dir, right_dir, output_yaml=None
                       ) -> StereoRig:
        """Directory workflow: sorted glob of both dirs
        (stereo_calibrator.cpp:29-38), calibrate, optionally save."""
        import cv2
        lf = sorted(Path(left_dir).glob("*"))
        rf = sorted(Path(right_dir).glob("*"))
        lefts = [cv2.imread(str(p)) for p in lf]
        rights = [cv2.imread(str(p)) for p in rf]
        rig = self.calibrate_pairs([x for x in lefts if x is not None],
                                   [x for x in rights if x is not None])
        if output_yaml:
            rig.to_yaml(output_yaml)
        return rig

    def print_results(self) -> str:
        """printCalibrationResults analog (stereo_calibrator.cpp:156-166)."""
        txt = (f"RMS left: {self.rms_left}\nRMS right: {self.rms_right}\n"
               f"RMS stereo: {self.rms_stereo}")
        print(txt)
        return txt
