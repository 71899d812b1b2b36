"""Scaling-efficiency harness: 1-chip / 1-host / N-host throughput table.

BASELINE.md asks for >=80% scaling efficiency at 2+ hosts, reported as a
1-chip / 1-host / N-host table. This harness produces that table on
whatever devices exist:

- on the default backend (the GPUs of one host, or several hosts after
  ``initialize_distributed``) it measures real frame-parallel throughput
  over the global mesh;
- with ``--dryrun`` it runs on the 8-virtual-device CPU mesh
  (JAX_PLATFORMS=cpu + --xla_force_host_platform_device_count) —
  validating the harness, sharding, and collectives; the printed
  efficiencies are CPU-mesh numbers, *not* device numbers.

Usage:
    python tools/scaling_harness.py              # on the default backend
    python tools/scaling_harness.py --dryrun     # on 8 virtual CPU devices
Emits one JSON line per mesh size plus a markdown table on stderr.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", action="store_true",
                    help="run on the 8-virtual-device CPU mesh instead of "
                         "the default backend")
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--num-disp", type=int, default=None)
    ap.add_argument("--frames-per-device", type=int, default=2)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()

    import os
    if args.dryrun:
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
    import jax
    if args.dryrun:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from stereo_depth_ruler_tpu.calib.config import StereoRig
    from stereo_depth_ruler_tpu.ops.sgbm import SGBMParams
    from stereo_depth_ruler_tpu.parallel.mesh import (initialize_distributed,
                                                      make_mesh)
    from stereo_depth_ruler_tpu.parallel.sharded import pipeline_step_sharded

    initialize_distributed()
    devs = jax.devices()
    n_dev = len(devs)
    d_local = jax.local_device_count()
    n_hosts = jax.process_count()
    log(f"{n_dev} devices, {n_hosts} host(s), {d_local} local")

    # dryrun mode shrinks shapes so the CPU mesh finishes fast; the
    # default backend runs the headline config
    if not args.dryrun:
        H, W, D = 720, 1280, 128
        params = SGBMParams(num_disparities=D, block_size=5,
                            speckle_window_size=0)
    else:
        H, W, D = 64, 96, 16
        params = SGBMParams(num_disparities=D, block_size=3, p1=72, p2=288,
                            speckle_window_size=0)
    H = args.height or H
    W = args.width or W
    D = args.num_disp or D

    rig = StereoRig.synthetic(width=W, height=H)
    rng = np.random.default_rng(0)

    # mesh sizes: 1 chip, 1 host (all local devices), N hosts (all devices)
    sizes = sorted({1, d_local, n_dev})
    results = {}
    for n in sizes:
        mesh = make_mesh(frame=n, tile=1, disp=1, devices=devs[:n])
        nf = n * args.frames_per_device
        lefts = rng.uniform(0, 255, (nf, H, W)).astype(np.float32)
        rights = np.roll(lefts, -4, axis=2)

        def step():
            out = pipeline_step_sharded(lefts, rights, rig.Q, params, mesh)
            jax.block_until_ready(out)
            return out

        step()                                     # compile
        t0 = time.perf_counter()
        for _ in range(args.iters):
            step()
        dt = (time.perf_counter() - t0) / args.iters
        fps = nf / dt
        results[n] = fps
        eff = fps / (results[1] * n) if 1 in results and n > 1 else 1.0
        label = ("1 device" if n == 1 else
                 f"1 host ({n} devices)" if n == d_local else
                 f"{n_hosts} hosts ({n} devices)")
        print(json.dumps({"mesh_devices": n, "label": label,
                          "fps": round(fps, 3),
                          "scaling_efficiency": round(eff, 3),
                          "shape": [H, W, D],
                          "backend": jax.default_backend(),
                          "dryrun": args.dryrun}))

    log("\n| mesh | fps | efficiency |\n|---|---|---|")
    for n in sizes:
        eff = results[n] / (results[1] * n)
        log(f"| {n} dev | {results[n]:.2f} | {eff * 100:.0f}% |")
    if args.dryrun:
        log("(dryrun on a CPU mesh — validates sharding + harness; "
            "device efficiencies require real multi-device hardware)")


if __name__ == "__main__":
    main()
