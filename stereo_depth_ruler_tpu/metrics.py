"""Structured per-frame metrics & observability (SURVEY.md §5).

The reference's only quantitative signals are console prints: calibration
RMS (stereo_calibrator.cpp:101-113), depth coverage %
(stereo_displayer.cpp:105-118), and point-cloud counts
(pcd_write.cpp:120,132). This module makes them structured, aggregatable
records; cross-host aggregation uses `psum` in parallel/sharded.py.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

__all__ = ["FrameMetrics", "MetricsLog", "frame_metrics",
           "batch_frame_stats", "StageTimer"]


@dataclasses.dataclass
class FrameMetrics:
    frame_index: int
    valid_disparity_frac: float     # fraction of matcher pixels with d >= 0
    #                                 right of the skip_cols band
    depth_coverage: float           # reference's coverage metric
    mean_depth_mm: float
    disparity_mae_vs_ref: Optional[float] = None  # when an oracle is given
    wall_ms: Optional[float] = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def frame_metrics(frame_index: int, disp: np.ndarray, depth_z: np.ndarray,
                  skip_cols: int = 0, z_max: float = 12000.0,
                  ref_disp: Optional[np.ndarray] = None,
                  wall_ms: Optional[float] = None) -> FrameMetrics:
    disp = np.asarray(disp)
    z = np.asarray(depth_z)
    valid = disp >= 0
    zsel = z[..., skip_cols:]
    good = np.isfinite(zsel) & (zsel >= 0) & (zsel <= z_max)
    mae = None
    if ref_disp is not None:
        ref_disp = np.asarray(ref_disp)
        both = valid & (ref_disp >= 0)
        both[..., :skip_cols] = False
        if both.any():
            mae = float(np.abs(disp[both] - ref_disp[both]).mean())
    zg = z[np.isfinite(z) & (z > 0) & (z <= z_max)]
    return FrameMetrics(
        frame_index=frame_index,
        valid_disparity_frac=float(valid[..., skip_cols:].mean()),
        depth_coverage=float(good.sum()) / float(z.size),
        mean_depth_mm=float(zg.mean()) if zg.size else float("nan"),
        disparity_mae_vs_ref=mae,
        wall_ms=wall_ms,
    )


def batch_frame_stats(disp, z, skip_cols: int = 0,
                      z_max: float = 12000.0):
    """Device-side per-frame stats: (N, H, W) disp + z -> (N, 3)
    [valid_frac, depth_coverage, mean_depth_mm]; the valid fraction and
    the coverage leave out the unreliable left ``skip_cols`` band.

    The same quantities frame_metrics computes on host, reduced ON
    DEVICE so the runner fetches 12 bytes/frame instead of the full
    disparity + depth maps (~15 MB/frame). Use with jax.jit;
    frame_metrics stays for host-side arrays / oracle MAE.
    """
    import jax.numpy as jnp
    vfrac = (disp[..., skip_cols:] >= 0).mean(axis=(-2, -1))
    zs = z[..., skip_cols:]
    good = jnp.isfinite(zs) & (zs >= 0) & (zs <= z_max)
    cov = good.sum(axis=(-2, -1)) / (z.shape[-2] * z.shape[-1])
    zok = jnp.isfinite(z) & (z > 0) & (z <= z_max)
    zsum = jnp.where(zok, z, 0.0).sum(axis=(-2, -1))
    zcnt = zok.sum(axis=(-2, -1))
    meanz = jnp.where(zcnt > 0, zsum / jnp.maximum(zcnt, 1), jnp.nan)
    return jnp.stack([vfrac, cov, meanz], axis=-1)


class MetricsLog:
    """Append-only JSONL metrics sink + summary aggregation."""

    def __init__(self, path=None):
        self.path = Path(path) if path else None
        self.records: List[FrameMetrics] = []

    def append(self, m: FrameMetrics) -> None:
        self.records.append(m)
        if self.path:
            with open(self.path, "a") as f:
                f.write(m.to_json() + "\n")

    def summary(self) -> Dict[str, float]:
        if not self.records:
            return {}
        out = {
            "frames": len(self.records),
            "valid_disparity_frac": float(np.mean(
                [m.valid_disparity_frac for m in self.records])),
            "depth_coverage": float(np.mean(
                [m.depth_coverage for m in self.records])),
        }
        walls = [m.wall_ms for m in self.records if m.wall_ms is not None]
        if walls:
            out["mean_wall_ms"] = float(np.mean(walls))
            out["fps"] = 1000.0 / float(np.mean(walls))
        maes = [m.disparity_mae_vs_ref for m in self.records
                if m.disparity_mae_vs_ref is not None]
        if maes:
            out["disparity_mae_vs_ref"] = float(np.mean(maes))
        return out


class StageTimer:
    """Per-stage wall-clock tracker (SURVEY.md §5 tracing). Use around
    device calls with block_until_ready for honest timings."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def __call__(self, name: str):
        timer = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                dt = (time.perf_counter() - self.t0) * 1000.0
                timer.totals[name] = timer.totals.get(name, 0.0) + dt
                timer.counts[name] = timer.counts.get(name, 0) + 1
                return False

        return _Ctx()

    def report(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_ms": v, "count": self.counts[k],
                    "mean_ms": v / self.counts[k]}
                for k, v in self.totals.items()}
