"""Stateless per-pixel RNG + low-discrepancy sequences.

Replacement for MathLib ``Rng::Hash`` (seeded per pixel+frame in
/root/reference/Shaders/Raytracing.hlsl:108 via ``Rng::Hash::Initialize``)
and ``Sequence::Halton`` (/root/reference/Source/HaltonSampler.ixx:32-34).

Design: a PCG-family hash over uint32 lanes. The "state" is a plain uint32
array of any shape, advanced functionally: ``u, state = next_float(state)``.
This is branch-free, vectorizes over the whole frame, and gives decorrelated
per-pixel streams without threading jax.random keys through the hot loop.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_U32 = jnp.uint32


def _pcg_permute(s):
    """PCG-RXS-M-XS output permutation on uint32."""
    word = ((s >> ((s >> jnp.uint32(28)) + jnp.uint32(4))) ^ s) \
        * jnp.uint32(277803737)
    return (word >> jnp.uint32(22)) ^ word


def hash_u32(x):
    """One-shot integer hash (lowbias32-style avalanche)."""
    x = jnp.asarray(x).astype(_U32)
    x = x ^ (x >> jnp.uint32(16))
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> jnp.uint32(15))
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> jnp.uint32(16))
    return x


def init(pixel_x, pixel_y, frame_index):
    """Per-pixel stream seed (Rng::Hash::Initialize semantics)."""
    px = jnp.asarray(pixel_x).astype(_U32)
    py = jnp.asarray(pixel_y).astype(_U32)
    f = jnp.asarray(frame_index).astype(_U32)
    return hash_u32(hash_u32(px + (py << jnp.uint32(16))) + f * jnp.uint32(0x9E3779B9))


def _advance(state):
    return state * jnp.uint32(747796405) + jnp.uint32(2891336453)


def next_u32(state):
    """Returns (random_u32, new_state)."""
    state = _advance(state)
    return _pcg_permute(state), state


def next_float(state):
    """Uniform in [0, 1). Returns (float32, new_state)."""
    bits, state = next_u32(state)
    return (bits >> jnp.uint32(8)).astype(jnp.float32) * np.float32(1.0 / (1 << 24)), state


def next_floats(state, n: int):
    """n sequential uniforms, stacked on a new trailing axis."""
    outs = []
    for _ in range(n):
        u, state = next_float(state)
        outs.append(u)
    return jnp.stack(outs, axis=-1), state


# ----------------------------------------------------------------------------
# Halton (camera jitter sequence; period set by the app like App.cpp:651)


def _radical_inverse(index: np.ndarray, base: int) -> np.ndarray:
    index = np.asarray(index, np.uint64).copy()
    result = np.zeros(index.shape, np.float64)
    f = 1.0 / base
    while index.max(initial=0) > 0:
        result += f * (index % base)
        index //= base
        f /= base
    return result


def halton_sequence(count: int, start: int = 0) -> np.ndarray:
    """(count, 2) float32 Halton(2,3) points in [0,1)^2 (host-side)."""
    idx = np.arange(start + 1, start + count + 1)
    return np.stack([_radical_inverse(idx, 2),
                     _radical_inverse(idx, 3)], axis=-1).astype(np.float32)


def halton_jitter(count: int) -> np.ndarray:
    """Camera jitter offsets in [-0.5, 0.5)^2 (HaltonSampler.ixx:37 usage)."""
    return halton_sequence(count) - 0.5
