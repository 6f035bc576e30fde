"""On-device rigid-body dynamics for sphere scenes.

Replacement for the PhysX layer (SURVEY.md §2.3 "PhysX" row):
the force model ports the physics formulas from
/root/reference/Source/PhysX.h:13-35 (universal gravitation, simple harmonic
motion) and the per-frame force application from
/root/reference/Source/MyScene.ixx:351-396 (spring restoring force on the
oscillator field, earth gravity on the moon — and on everything when
toggled — and a fixed 10 m/s² star pull when toggled). Contact response is
an impulse solver over all sphere pairs — a dense (K, K) masked computation,
which for K≈450 is small dense work; PhysX's broadphase trees would be
slower here than the brute-force vector form.

Everything is jitted; the step never leaves the chip, so
step → TLAS-refit → trace stays a single XLA program.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from ..utils import struct

from ..utils import math as m

GRAVITATIONAL_CONSTANT = 6.674e-11  # PhysX.h:14
STAR_PULL = 10.0                    # MyScene.ixx:391 (eACCELERATION)
RESTITUTION = 0.6                   # MyScene.ixx:99 material
MAX_TIMESTEP = 1.0 / 60.0           # MyScene.ixx:395


def gravitational_mass(r, t):
    """UniversalGravitation::CalculateMass (PhysX.h:17):
    M = 4 pi^2 r^3 / (G t^2)."""
    import numpy as np
    return 4.0 * np.pi ** 2 * r ** 3 / (GRAVITATIONAL_CONSTANT * t * t)


def gravitational_acceleration(mass, r):
    """UniversalGravitation::CalculateAccelerationMagnitude (PhysX.h:20)."""
    return GRAVITATIONAL_CONSTANT * mass / (r * r)


def first_cosmic_speed(mass, r):
    """UniversalGravitation::CalculateFirstCosmicSpeed (PhysX.h:23)."""
    import numpy as np
    return np.sqrt(GRAVITATIONAL_CONSTANT * mass / r)


def spring_constant(mass, period):
    """SimpleHarmonicMotion::Spring::CalculateConstant (PhysX.h:28)."""
    return 4.0 * jnp.pi ** 2 * mass / (period * period)


@struct.dataclass
class RigidBodies:
    """SoA rigid-body state over K spheres."""
    position: jnp.ndarray          # (K, 3)
    velocity: jnp.ndarray          # (K, 3)
    rotation: jnp.ndarray          # (K, 4) quaternion
    angular_velocity: jnp.ndarray  # (K, 3) world-frame rad/s
    mass: jnp.ndarray              # (K,); 0 = static collider
    inv_mass: jnp.ndarray          # (K,)
    radius: jnp.ndarray            # (K,)
    is_oscillator: jnp.ndarray     # (K,) bool — spring force applies
    spring_rest_y: jnp.ndarray     # scalar rest height (Spring::PositionY)
    attracted_to_earth: jnp.ndarray  # (K,) bool — always-on earth gravity
    earth_index: jnp.ndarray       # scalar int32
    star_index: jnp.ndarray        # scalar int32


def _accelerations(b: RigidBodies, earth_gravity: jnp.ndarray,
                   star_gravity: jnp.ndarray):
    """Force model of MyScene::Tick (MyScene.ixx:351-396), as accelerations."""
    k = b.position.shape[0]
    dynamic = b.inv_mass > 0

    # Spring: F = -k x with k = 4 pi^2 m / T^2 -> a = -(2 pi / T)^2 * x.
    from ..models.myscene import SPRING_PERIOD  # shared constant
    omega_sq = (2.0 * jnp.pi / SPRING_PERIOD) ** 2
    disp_y = b.position[:, 1] - b.spring_rest_y
    a_spring = jnp.where(
        (b.is_oscillator & dynamic)[:, None],
        jnp.stack([jnp.zeros(k), -omega_sq * disp_y, jnp.zeros(k)], axis=-1),
        0.0)

    # Earth gravity: on the moon always; on everything (except earth) when
    # toggled (MyScene.ixx:378-385).
    earth_pos = b.position[b.earth_index]
    earth_mass = b.mass[b.earth_index]
    to_earth = earth_pos[None, :] - b.position
    r = jnp.maximum(m.length(to_earth), 1e-6)
    g_mag = gravitational_acceleration(earth_mass, r)
    is_earth = jnp.arange(k) == b.earth_index
    earth_on = (b.attracted_to_earth | (earth_gravity & ~is_earth)) & dynamic
    a_earth = jnp.where(earth_on[:, None], (g_mag / r)[:, None] * to_earth,
                        0.0)

    # Star pull: constant 10 m/s^2 toward the star when toggled
    # (MyScene.ixx:387-392).
    star_pos = b.position[b.star_index]
    to_star = star_pos[None, :] - b.position
    is_star = jnp.arange(k) == b.star_index
    star_on = star_gravity & ~is_star & dynamic
    a_star = jnp.where(star_on[:, None],
                       STAR_PULL * m.normalize(to_star), 0.0)

    return a_spring + a_earth + a_star


def _resolve_contacts(b: RigidBodies, position, velocity,
                      iterations: int = 4):
    """Impulse contact solver over all sphere pairs (dense, masked).

    Jacobi iterations of the standard restitution impulse
    j = -(1+e) (v_rel·n) / (w_i + w_j), followed by mass-weighted
    penetration projection — the role PhysX's PGS solver plays for the
    reference's sphere-only scene.
    """
    k = position.shape[0]
    w = b.inv_mass
    eye = jnp.eye(k, dtype=bool)

    def body(_, state):
        pos, vel = state
        diff = pos[:, None, :] - pos[None, :, :]          # (K, K, 3)
        dist = jnp.maximum(m.length(diff), 1e-9)          # (K, K)
        n = diff / dist[..., None]
        overlap = (b.radius[:, None] + b.radius[None, :]) - dist
        touching = (overlap > 0.0) & ~eye
        # Pairs where at least one body is dynamic.
        w_sum = w[:, None] + w[None, :]
        active = touching & (w_sum > 0)

        rel_v = vel[:, None, :] - vel[None, :, :]
        vn = m.dot(rel_v, n)
        approaching = active & (vn < 0.0)
        j_imp = jnp.where(approaching,
                          -(1.0 + RESTITUTION) * vn /
                          jnp.maximum(w_sum, 1e-12), 0.0)
        dv = jnp.sum((j_imp * w[:, None])[..., None] * n, axis=1)
        vel = vel + dv

        # Penetration projection (split by inverse-mass ratio).
        corr = jnp.where(active, overlap / jnp.maximum(w_sum, 1e-12), 0.0)
        dp = jnp.sum((corr * w[:, None])[..., None] * n, axis=1) * 0.5
        pos = pos + dp
        return pos, vel

    position, velocity = jax.lax.fori_loop(0, iterations, body,
                                           (position, velocity))
    return position, velocity


def step(b: RigidBodies, dt, earth_gravity=False, star_gravity=False,
         contact_iterations: int = 4) -> RigidBodies:
    """One physics step (PhysX::Tick + MyScene::Tick force pass).

    dt is clamped to MAX_TIMESTEP like the reference (MyScene.ixx:395).
    Returns the new state; jit-safe (all control flow static).
    """
    dt = jnp.minimum(jnp.asarray(dt, jnp.float32), MAX_TIMESTEP)
    earth_gravity = jnp.asarray(earth_gravity)
    star_gravity = jnp.asarray(star_gravity)

    accel = _accelerations(b, earth_gravity, star_gravity)
    dynamic = (b.inv_mass > 0)[:, None]
    velocity = jnp.where(dynamic, b.velocity + accel * dt, b.velocity)
    position = jnp.where(dynamic, b.position + velocity * dt, b.position)
    position, velocity = _resolve_contacts(b, position, velocity,
                                           contact_iterations)
    rotation = m.quat_integrate(b.rotation, b.angular_velocity, dt)
    return b.replace(position=position, velocity=velocity, rotation=rotation)
