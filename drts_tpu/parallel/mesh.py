"""Mesh construction and frame-state sharding rules.

The recipe (SURVEY.md §5.8): pick a 1-D mesh over all chips, annotate the
frame buffers with row sharding, replicate scene/physics state, jit the
whole frame function with those shardings, and let XLA insert the
collectives (ppermute halos for the à-trous/bloom footprints, all-gathers
at image assembly). No hand-written NCCL analogue exists or is needed.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ROW_AXIS = "rows"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (ROW_AXIS,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def row_sharded(mesh: Mesh, ndim: int) -> NamedSharding:
    return NamedSharding(mesh, P(ROW_AXIS, *([None] * (ndim - 1))))


def frame_state_sharding(state, mesh: Mesh, image_heights: tuple[int, ...],
                         slot_table_sizes: tuple[int, ...] = ()):
    """Sharding pytree for a FrameState: (H, W, ...) frame buffers shard
    over rows (H must be in `image_heights` and divisible by the mesh
    size); everything else (scene, physics, scalars) replicates.

    `slot_table_sizes` additionally shards capacity-sized tables (the
    SHARC cache: fingerprint/radiance/sample_count/stale/query mirror)
    over slot ranges — the resolve's dense per-slot blend then runs
    split across chips with a reduce-scatter of the frame splats, and
    GSPMD all-gathers the query mirror where pixels read arbitrary slots
    (Source/SHARC.ixx:59-102 analogue; round-3 VERDICT #10)."""
    n = mesh.devices.size

    def rule(leaf):
        if not hasattr(leaf, "ndim"):
            return replicated(mesh)
        if (leaf.ndim >= 2 and leaf.shape[0] in image_heights
                and leaf.shape[0] % n == 0):
            return row_sharded(mesh, leaf.ndim)
        if (leaf.ndim >= 1 and leaf.shape[0] in slot_table_sizes
                and leaf.shape[0] % n == 0):
            return row_sharded(mesh, leaf.ndim)
        return replicated(mesh)

    return jax.tree.map(rule, state)


def image_sharding(mesh: Mesh, ndim: int = 3) -> NamedSharding:
    return row_sharded(mesh, ndim)
