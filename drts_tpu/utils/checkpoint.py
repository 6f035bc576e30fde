"""Checkpoint / resume for the full frame state.

The reference persists only settings JSON (SURVEY.md §5.4); the temporal
state that *functions* like a checkpoint (history textures, SHARC cache,
reservoirs, physics world, frame counter) is exactly our FrameState pytree.
A long render must survive preemption (SURVEY.md §5.3 "elastic recovery"
mapping), so the framework writes the whole pytree's leaves to one .npz
file and can resume mid-flight: the device-lost recovery analogue is
``restore() if exists else init_state()``.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np


def save(state, path: str) -> None:
    """Write the leaves of a pytree (a FrameState or any other) to
    `path` + ".npz"."""
    np.savez(path + ".npz", *[np.asarray(x) for x in jax.tree.leaves(state)])


def restore(state_like, path: str):
    """Restore a pytree with the structure/dtypes of `state_like` from
    `path` + ".npz". Returns None if no checkpoint exists."""
    if not os.path.exists(path + ".npz"):
        return None
    flat, treedef = jax.tree.flatten(state_like)
    with np.load(path + ".npz") as data:
        restored = [jnp.asarray(data[f"arr_{i}"]).astype(x.dtype)
                    for i, x in enumerate(flat)]
    return jax.tree.unflatten(treedef, restored)


def save_rotating(state, dirpath: str) -> str:
    """Crash-safe periodic checkpoint (SURVEY §5.3: preemption can strike
    MID-SAVE, so overwriting the only copy in place is not recovery).
    Two slots under `dirpath` alternate; a LATEST marker file is atomically
    replaced only after the slot write completes, so a kill at any instant
    leaves at least one complete checkpoint reachable. Returns the slot
    written."""
    os.makedirs(dirpath, exist_ok=True)
    prev = _read_latest(dirpath)
    slot = "s1" if prev == "s0" else "s0"
    save(state, os.path.join(dirpath, slot))
    tmp = os.path.join(dirpath, "LATEST.tmp")
    with open(tmp, "w") as f:
        f.write(slot)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(dirpath, "LATEST"))
    return slot


def _read_latest(dirpath: str) -> str | None:
    try:
        with open(os.path.join(dirpath, "LATEST")) as f:
            slot = f.read().strip()
        return slot if slot in ("s0", "s1") else None
    except OSError:
        return None


def restore_rotating(state_like, dirpath: str):
    """Restore the newest complete rotating checkpoint; falls back to the
    other slot if the marked one is unreadable, then to the legacy
    single-path layout. Returns None if nothing restorable exists."""
    latest = _read_latest(dirpath)
    order = [latest, "s1" if latest == "s0" else "s0"] if latest \
        else ["s0", "s1"]
    for slot in order:
        try:
            restored = restore(state_like, os.path.join(dirpath, slot))
        except Exception:
            restored = None
        if restored is not None:
            return restored
    return restore(state_like, dirpath)  # legacy single-slot layout


def resume_or_init(pipeline, path: str, host=None):
    """Elastic-recovery entry: restore a previous run's state or build a
    fresh one (DeviceResources::OnDeviceLost -> OnDeviceRestored analogue,
    DeviceResources.cpp:552-602)."""
    fresh = pipeline.init_state(host)
    restored = restore_rotating(fresh, path)
    return (restored, True) if restored is not None else (fresh, False)
