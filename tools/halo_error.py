"""Characterize halo-mode error at a real operating point (the
97%-agreement assertion in tests/test_parallel.py runs on a 32-row toy).

Compares sgbm_sharded halo mode against exact wavefront mode on the same
mesh for a sweep of halo sizes, reporting disagreement rate and the
disagreeing pixels' magnitude. Runs on the 8-virtual-device CPU mesh by
default (no accelerator needed — the comparison is mode-vs-mode, same
scans);
use --height/--width/--num-disp to scale toward 720p/128 as time allows.

    python tools/halo_error.py --height 240 --width 320 --num-disp 64
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--num-disp", type=int, default=64)
    ap.add_argument("--tiles", type=int, default=4)
    ap.add_argument("--halos", type=int, nargs="+",
                    default=[8, 16, 32, 64])
    args = ap.parse_args()

    import os
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")

    from stereo_depth_ruler_tpu.calib.config import StereoRig
    from stereo_depth_ruler_tpu.io.synthetic import (make_scene,
                                                     render_stereo_pair)
    from stereo_depth_ruler_tpu.ops.sgbm import SGBMParams
    from stereo_depth_ruler_tpu.parallel.mesh import make_mesh
    from stereo_depth_ruler_tpu.parallel.sharded import sgbm_sharded

    H, W, D = args.height, args.width, args.num_disp
    rig = StereoRig.synthetic(width=W, height=H)
    scene = make_scene(rig, n_boxes=6, z_range_mm=(600.0, 3000.0),
                       background_z_mm=5000.0, seed=11)
    left, right, _ = render_stereo_pair(scene, seed=11)
    params = SGBMParams(num_disparities=D, block_size=5,
                        speckle_window_size=0)
    mesh = make_mesh(tile=args.tiles)

    exact = np.asarray(sgbm_sharded(np.float32(left), np.float32(right),
                                    params, mesh, exact=True))
    for halo in args.halos:
        t0 = time.time()
        out = np.asarray(sgbm_sharded(np.float32(left), np.float32(right),
                                      params, mesh, halo=halo))
        both = (out >= 0) & (exact >= 0)
        diff = np.abs(out[both] - exact[both])
        mismatch_valid = float((out >= 0).mean() - (exact >= 0).mean())
        print(json.dumps({
            # full operating point in every line
            "height": H, "width": W, "num_disp": D,
            "tiles": args.tiles, "halo": halo,
            "h_local": H // args.tiles,
            "agree_exact_frac": float((diff == 0).mean()),
            "agree_1px_frac": float((diff <= 1.0).mean()),
            "max_abs_diff_px": float(diff.max()) if diff.size else 0.0,
            "valid_frac_delta": mismatch_valid,
            "wall_s": round(time.time() - t0, 1),
        }), flush=True)


if __name__ == "__main__":
    main()
