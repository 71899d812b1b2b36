"""The one place that picks the SGM aggregator for the platform.

Every matcher in the package (`StereoPipeline`, `PointCloudGenerator`,
the sharded pipeline, `bench.py`) asks `select_aggregator` which
implementation of `aggregate_paths` to run:

- ``"cpu"``: the jnp `lax.scan` aggregation (`ops.sgbm.aggregate_paths`);
- ``"gpu"``: the Triton path-traversal kernel (`ops.sgm_gpu`), bitwise
  equal to the jnp one;
- any other platform is an error — nothing falls back silently.

The rest of the matcher (cost volume, WTA, LR check, speckle, WLS) is
plain jnp on both platforms and is left to XLA.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax

__all__ = ["SUPPORTED_PLATFORMS", "platform", "select_aggregator"]

SUPPORTED_PLATFORMS = ("cpu", "gpu")


def platform(name: Optional[str] = None) -> str:
    """The platform a matcher runs on (``jax.default_backend()`` unless
    given), checked against `SUPPORTED_PLATFORMS`."""
    name = name or jax.default_backend()
    if name not in SUPPORTED_PLATFORMS:
        raise ValueError(
            f"no SGM aggregator for platform {name!r}; supported: "
            f"{', '.join(SUPPORTED_PLATFORMS)}")
    return name


def select_aggregator(name: Optional[str] = None) -> Callable:
    """``aggregator(cost, P1, P2, num_paths) -> S`` for the platform, as
    `ops.sgbm.sgbm(..., aggregator=)` takes it."""
    if platform(name) == "gpu":
        from .sgm_gpu import aggregate_paths_gpu
        return aggregate_paths_gpu
    from .sgbm import aggregate_paths
    return aggregate_paths
