"""Device mesh construction for the stereo engine.

The reference is single-process, single-thread (SURVEY.md §2.10); this
module defines the scale-out axes the framework shards over:

- ``frame`` — data parallelism over video frames (the batch axis of the
  pipeline; maps the reference's frame loop, stereo_displayer.cpp:145-198);
- ``tile`` — spatial parallelism over image rows of the cost volume
  (TP/SP-analog; SGBM path aggregation needs halo exchange across tiles);
- ``disp`` — disparity-range parallelism over the D axis (EP-analog;
  WTA needs an argmin reduction across shards).

Meshes are created over the devices of one host (all to all joined, so
the mesh shape follows the algorithm alone); across hosts,
``jax.distributed.initialize`` + the same helpers apply unchanged.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

__all__ = ["make_mesh", "make_global_mesh", "initialize_distributed",
           "FRAME_AXIS", "TILE_AXIS", "DISP_AXIS"]

FRAME_AXIS = "frame"
TILE_AXIS = "tile"
DISP_AXIS = "disp"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> bool:
    """Multi-host runtime bootstrap (SURVEY.md §2.10 'Device mesh &
    runtime').

    Calls ``jax.distributed.initialize`` with SDR_COORDINATOR /
    SDR_NUM_PROCESSES / SDR_PROCESS_ID from the environment (the launcher
    the reference never had, app/stereo_ruler.cpp:16 is single-process).
    Returns True when a multi-process runtime was initialized, False for
    the single-process (or already-initialized) case. Safe to call
    unconditionally from the CLI.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "SDR_COORDINATOR")
    if num_processes is None and "SDR_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["SDR_NUM_PROCESSES"])
    if process_id is None and "SDR_PROCESS_ID" in os.environ:
        process_id = int(os.environ["SDR_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        # single-process
        return False
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
        return True
    except RuntimeError:
        return False  # already initialized


def make_mesh(frame: int = 1, tile: int = 1, disp: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Mesh with axes (frame, tile, disp); total must divide the device
    count. Axis order puts ``frame`` outermost (frames are independent,
    so it is the axis to span hosts) and ``disp`` innermost (the per-step
    argmin reductions)."""
    devices = list(devices if devices is not None else jax.devices())
    n = frame * tile * disp
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    dev = np.asarray(devices[:n]).reshape(frame, tile, disp)
    return Mesh(dev, (FRAME_AXIS, TILE_AXIS, DISP_AXIS))


def make_global_mesh(tile: int = 1, disp: int = 1) -> Mesh:
    """Multi-host mesh over *all* processes' devices: the frame axis spans
    hosts (frames are independent — only the final metric psum crosses
    it) and (tile, disp) stay within one host.

    Device order from ``jax.devices()`` groups each process's devices
    contiguously, so reshaping (frame, tile, disp) with frame outermost
    puts every (tile, disp) block on one host whenever
    tile*disp <= devices-per-host.
    """
    devices = jax.devices()
    per = tile * disp
    if len(devices) % per:
        raise ValueError(f"device count {len(devices)} not divisible by "
                         f"tile*disp={per}")
    d_local = jax.local_device_count()
    if per > d_local and len(devices) > d_local:
        raise ValueError(
            f"tile*disp={per} spans hosts ({d_local} local devices); keep "
            "the per-step halo/argmin collectives within a host by "
            "sharding frames across hosts instead")
    return make_mesh(frame=len(devices) // per, tile=tile, disp=disp,
                     devices=devices)
