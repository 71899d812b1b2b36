"""stereo_depth_ruler_tpu — a stereo depth engine in JAX.

A JAX/XLA framework with the capabilities of the reference C++/OpenCV/PCL
tool `Amar-Aliaga/Stereo_Depth_Ruler`: calibration-driven rectification,
semi-global disparity matching, WLS post-filtering, Q-matrix reprojection
to metric 3D, two-point measurement with CSV records, and colored point
clouds with voxel-grid downsampling — on a GPU (or the CPU), and scaled
over device meshes via shard_map with halo exchange.
"""

__version__ = "0.1.0"

from .calib.config import StereoRig  # noqa: F401
from .ops.sgbm_ref import SGBMParams  # noqa: F401
