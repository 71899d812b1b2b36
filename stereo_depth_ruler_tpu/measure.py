"""Two-point metric measurement engine — "the ruler".

Framework counterpart of the reference's interactive ``StereoDisplayer``
measurement mode (stereo_displayer.cpp:24-63, 202-250): pick two pixels on
a frozen frame, read their reprojected XYZ, record ‖xyz1 − xyz2‖ in a
session with CSV persistence (schema of save_csvFile,
stereo_displayer.cpp:74-102). Accelerator hosts are headless, so point picking is
an API/CLI concern; the engine itself is pure data — pass pixel pairs, get
records.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["MeasurementRecord", "MeasurementSession", "measure_distance",
           "depth_coverage"]


@dataclasses.dataclass(frozen=True)
class MeasurementRecord:
    """One measurement (mirrors the reference's MeasurementRecord struct,
    stereo_displayer.hpp:13-18). ``distance_mm`` in calibration units."""
    image_index: int
    point1: Tuple[int, int]   # (x, y)
    point2: Tuple[int, int]
    distance_mm: float

    @property
    def distance_cm(self) -> float:
        """The reference prints/persists dist/10 as cm
        (stereo_displayer.cpp:47-57, 91-93)."""
        return self.distance_mm / 10.0


def measure_distance(xyz: np.ndarray, p1: Tuple[int, int],
                     p2: Tuple[int, int]) -> float:
    """Euclidean distance between the reprojected 3D points under two
    pixels; (x, y) pixel coords, xyz is (H, W, 3). NaN/inf XYZ -> nan."""
    a = np.asarray(xyz[p1[1], p1[0]], np.float64)
    b = np.asarray(xyz[p2[1], p2[0]], np.float64)
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        return float("nan")
    return float(np.linalg.norm(a - b))


class MeasurementSession:
    """Session state machine: collect two-point measurements per image
    index, persist to CSV, reset, advance sessions — the keyboard workflow
    of test_mouse ('s' save, 'r' reset+truncate, 'n' next image index;
    stereo_displayer.cpp:217-248) as an API."""

    CSV_HEADER = "Image, First_point,   Second_point, Distance"

    def __init__(self, csv_path=None):
        self.records: List[MeasurementRecord] = []
        self.current_image_index = 0
        self.csv_path = Path(csv_path) if csv_path else None
        self._pending: Optional[Tuple[int, int]] = None

    # -- interactive-style API -------------------------------------------
    def click(self, x: int, y: int, xyz: np.ndarray
              ) -> Optional[MeasurementRecord]:
        """Register one picked point; on the second pick, produce a record
        (onMouseMeasure collects clicks in pairs,
        stereo_displayer.cpp:40-57)."""
        h, w = xyz.shape[:2]
        if not (0 <= x < w and 0 <= y < h):
            raise ValueError(f"point ({x},{y}) outside image {w}x{h}")
        if self._pending is None:
            self._pending = (x, y)
            return None
        p1, self._pending = self._pending, None
        return self.measure(p1, (x, y), xyz)

    def measure(self, p1: Tuple[int, int], p2: Tuple[int, int],
                xyz: np.ndarray) -> MeasurementRecord:
        rec = MeasurementRecord(self.current_image_index, tuple(p1),
                                tuple(p2), measure_distance(xyz, p1, p2))
        self.records.append(rec)
        return rec

    def new_session(self) -> None:
        """'n': advance the image index (stereo_displayer.cpp:236-246)."""
        self.current_image_index += 1

    def reset(self) -> None:
        """'r': clear records and truncate the CSV
        (stereo_displayer.cpp:225-235)."""
        self.records.clear()
        self._pending = None
        if self.csv_path and self.csv_path.exists():
            self.csv_path.write_text("")

    # -- persistence ------------------------------------------------------
    def save_csv(self, path=None) -> Path:
        """Append records in the reference's CSV schema
        (results/measurements.csv):
        ``Image, First_point,   Second_point, Distance`` then rows
        ``3, [434, 117],    [440, 189], 240.02902 cm``."""
        path = Path(path) if path else self.csv_path
        if path is None:
            raise ValueError("no CSV path configured")
        new_file = not path.exists() or path.stat().st_size == 0
        with open(path, "a") as f:
            if new_file:
                f.write(self.CSV_HEADER + "\n")
            for r in self.records:
                f.write(f"{r.image_index}, [{r.point1[0]}, {r.point1[1]}],"
                        f"    [{r.point2[0]}, {r.point2[1]}],"
                        f" {r.distance_cm:.5f} cm   \n")
        return path

    @staticmethod
    def load_csv(path) -> List[MeasurementRecord]:
        recs = []
        for line in Path(path).read_text().splitlines()[1:]:
            if not line.strip():
                continue
            import re
            m = re.match(r"\s*(\d+),\s*\[(\d+),\s*(\d+)\],\s*\[(\d+),\s*(\d+)\],"
                         r"\s*([0-9.]+)\s*cm", line)
            if m:
                g = m.groups()
                recs.append(MeasurementRecord(
                    int(g[0]), (int(g[1]), int(g[2])),
                    (int(g[3]), int(g[4])), float(g[5]) * 10.0))
        return recs


def depth_coverage(depth_z: np.ndarray, skip_cols: int = 0,
                   z_max: float = 12000.0) -> float:
    """Fraction of pixels with finite 0 <= Z <= z_max, counting columns
    from ``skip_cols`` (the reference skips the unreliable left band of
    width numDisparities) but denominated over ALL pixels — faithfully
    reproducing depth_coverage's quirk (stereo_displayer.cpp:105-118)."""
    z = np.asarray(depth_z)[..., skip_cols:]
    good = np.isfinite(z) & (z >= 0.0) & (z <= z_max)
    total = np.asarray(depth_z).size
    return float(good.sum()) / float(total)
