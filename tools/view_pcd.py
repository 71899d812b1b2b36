"""Local point-cloud viewer for PCD files written by the cloud path.

The reference ends its point-cloud flow in a PCLVisualizer spin loop
(point_cloud/src/pcd_write.cpp:149-154); accelerator hosts are
headless, so this optional script renders a .pcd to an interactive
window when a display + open3d are available and otherwise to a PNG
(matplotlib 3D scatter, headless-safe Agg backend).

Usage:
    python tools/view_pcd.py results/frame_00100.pcd [--out view.png]
        [--max-points 200000] [--elev 20] [--azim -60]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from stereo_depth_ruler_tpu.io.pcd import read_pcd  # noqa: E402


def _subsample(xyz, rgb, max_points, seed=0):
    finite = np.isfinite(xyz).all(axis=1)
    xyz = xyz[finite]
    rgb = rgb[finite] if rgb is not None else None
    if len(xyz) > max_points:
        idx = np.random.default_rng(seed).choice(len(xyz), max_points,
                                                 replace=False)
        xyz = xyz[idx]
        rgb = rgb[idx] if rgb is not None else None
    return xyz, rgb


def view_open3d(xyz, rgb) -> bool:
    """Interactive window (PCLVisualizer-style); False if unavailable."""
    try:
        import open3d as o3d
    except ImportError:
        return False
    pc = o3d.geometry.PointCloud()
    pc.points = o3d.utility.Vector3dVector(xyz.astype(np.float64))
    if rgb is not None:
        pc.colors = o3d.utility.Vector3dVector(rgb.astype(np.float64) / 255)
    try:
        o3d.visualization.draw_geometries([pc])
    except Exception as e:  # no display
        print(f"open3d window failed ({e}); falling back to PNG",
              file=sys.stderr)
        return False
    return True


def render_png(xyz, rgb, out: Path, elev: float, azim: float) -> Path:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(10, 8), dpi=110)
    ax = fig.add_subplot(projection="3d")
    colors = rgb / 255.0 if rgb is not None else xyz[:, 2]
    # image convention: +y down, +z forward -> plot z forward, -y up
    ax.scatter(xyz[:, 0], xyz[:, 2], -xyz[:, 1], s=0.3, c=colors,
               linewidths=0, rasterized=True)
    ax.set_xlabel("x (mm)")
    ax.set_ylabel("z (mm)")
    ax.set_zlabel("-y (mm)")
    ax.view_init(elev=elev, azim=azim)
    ax.set_title(out.stem)
    fig.tight_layout()
    fig.savefig(out)
    plt.close(fig)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("pcd", help=".pcd file (write_pcd / PCL schema)")
    ap.add_argument("--out", help="PNG output (default <pcd>.png)")
    ap.add_argument("--max-points", type=int, default=200_000)
    ap.add_argument("--elev", type=float, default=20.0)
    ap.add_argument("--azim", type=float, default=-60.0)
    ap.add_argument("--png", action="store_true",
                    help="always render PNG (skip the open3d window)")
    args = ap.parse_args(argv)

    xyz, rgb, (h, w) = read_pcd(args.pcd)
    print(f"{args.pcd}: {len(xyz)} points ({h}x{w})", file=sys.stderr)
    xyz, rgb = _subsample(xyz, rgb, args.max_points)
    if not len(xyz):
        print("no finite points to render", file=sys.stderr)
        return 1
    if not args.png and view_open3d(xyz, rgb):
        return 0
    out = Path(args.out) if args.out else Path(args.pcd).with_suffix(".png")
    print(f"wrote {render_png(xyz, rgb, out, args.elev, args.azim)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
