"""Device-mesh construction and sharding helpers.

The reference's only parallelism is N processes over a shared filesystem
(SURVEY.md §2.5).  Here frames are a sharded array axis: a 1-D ("frame",)
mesh shards the frame-batch dimension of every per-frame array, and the
sequence-wide reductions (autocalibration match pooling, plane statistics)
become jax.lax collectives over that axis.

On several hosts, jax.distributed.initialize() + the same mesh spans all
of them; frames ride the data-parallel axis so no per-frame communication
crosses the interconnect at all, and only the autocalibrate gather /
plane statistics use collectives.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_frame_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over the frame axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), ("frame",))


def frame_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (frame) axis; replicate everything else."""
    return NamedSharding(mesh, P("frame"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
