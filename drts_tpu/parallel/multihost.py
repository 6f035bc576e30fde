"""Multi-host (DCN) initialization for the frame-graph mesh.

SURVEY.md §5.8: the reference is single-process/single-GPU; this
framework's distributed story is a first-class NEW component. Within one
host, `parallel/mesh.py` shards image rows (and SHARC slot ranges) over
the host's devices. Across hosts this module adds the standard JAX
multi-controller bootstrap: every process calls `initialize()`
(jax.distributed), sees the GLOBAL device set, and builds the same 1-D row
mesh over it — cross-host traffic only where XLA must cross hosts (image
assembly all-gather at the very end of the frame; annotate shardings, let
XLA place collectives).

Single-host processes can call these helpers unconditionally: with no
coordinator configured they are no-ops that fall back to the local mesh.
"""

from __future__ import annotations

import os

import jax

from . import mesh as mesh_mod


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """jax.distributed.initialize from args or the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).
    Returns True when a multi-process runtime
    was actually set up; False for plain single-process operation."""
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "0") or 0)
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "-1"))
    if not coordinator_address or num_processes <= 1:
        return False
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def global_mesh():
    """Row mesh over ALL processes' devices (identical on every process —
    the multi-controller contract). Equivalent to mesh.make_mesh() after
    initialize()."""
    return mesh_mod.make_mesh()


def process_local_rows(height: int) -> tuple[int, int]:
    """The [start, end) image-row range whose shards live on THIS
    process's devices under the global row sharding — what a multi-host
    driver renders/saves locally (addressable-shard bookkeeping)."""
    order = list(jax.devices())  # the order make_mesh() lays rows out in
    n = len(order)
    rows_per_dev = height // n
    # Positions in mesh order, NOT raw device ids: multi-process backends
    # assign non-contiguous ids (process 1's CPU devices start at 2^k).
    pos = sorted(order.index(d) for d in jax.local_devices())
    return pos[0] * rows_per_dev, (pos[-1] + 1) * rows_per_dev
