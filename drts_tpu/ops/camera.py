"""Camera: GPU constants pytree, ray generation, and reprojection.

Reimplementation of the reference's Source/Camera.ixx (host
camera + controller) and /root/reference/Shaders/Camera.hlsli (ray
generation, world-position reconstruction). The scaled right/up/forward
frame convention matches the reference: |forward| = focus distance,
|right| = tan(hfov/2)*|forward|, |up| = |right| / aspect
(Camera.ixx:138-153), and rays are
``normalize(NDC.x * right + NDC.y * up + forward)`` (Camera.hlsli:27-41).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from ..utils import struct

from ..utils import math as m
from ..ops import brdf


@struct.dataclass
class Camera:
    """Device camera constants (Camera.hlsli:5-26), current + previous."""
    position: jnp.ndarray            # (3,)
    right: jnp.ndarray               # (3,) scaled
    up: jnp.ndarray                  # (3,) scaled
    forward: jnp.ndarray             # (3,) scaled
    prev_position: jnp.ndarray       # (3,)
    prev_right: jnp.ndarray
    prev_up: jnp.ndarray
    prev_forward: jnp.ndarray
    jitter: jnp.ndarray              # (2,) pixel-fraction jitter
    aperture_radius: jnp.ndarray     # scalar
    near_depth: jnp.ndarray          # scalar
    far_depth: jnp.ndarray           # scalar


def make_camera(position, forward=(0.0, 0.0, 1.0), up=(0.0, 1.0, 0.0),
                horizontal_fov_deg: float = 90.0, aspect: float = 16 / 9,
                jitter=(0.0, 0.0), aperture_radius: float = 0.0,
                near_depth: float = 1e-3, far_depth: float = 1e8,
                focus_distance: float = 1.0,
                prev: "Camera | None" = None) -> Camera:
    """Build camera constants. ``aspect`` = width / height.

    Matches CameraController::SetLens (Camera.ixx:138-153): right/up are
    scaled by tan(hfov/2) and 1/aspect. ``focus_distance`` scales the whole
    frame (|forward| = focus distance, the Camera.ixx convention) — the
    thin-lens ray generator's focal plane; pinhole rays are unaffected
    (directions are normalized). If ``prev`` is given its current frame
    becomes this camera's previous frame (App.cpp:531-554 save).
    """
    position = jnp.asarray(position, jnp.float32)
    f = m.normalize(jnp.asarray(forward, jnp.float32)) * focus_distance
    r = m.normalize(m.cross(jnp.asarray(up, jnp.float32), f))
    u = m.cross(m.normalize(f), r)
    tan_half = np.tan(np.radians(horizontal_fov_deg) / 2).astype(np.float32)
    r = r * (tan_half * focus_distance)
    u = u * (tan_half * focus_distance / aspect)
    if prev is None:
        prev_pos, prev_r, prev_u, prev_f = position, r, u, f
    else:
        prev_pos, prev_r, prev_u, prev_f = (prev.position, prev.right,
                                            prev.up, prev.forward)
    return Camera(position=position, right=r, up=u, forward=f,
                  prev_position=prev_pos, prev_right=prev_r, prev_up=prev_u,
                  prev_forward=prev_f,
                  jitter=jnp.asarray(jitter, jnp.float32),
                  aperture_radius=jnp.float32(aperture_radius),
                  near_depth=jnp.float32(near_depth),
                  far_depth=jnp.float32(far_depth))


def pixel_ndc(width: int, height: int, jitter):
    """Per-pixel NDC grid with camera jitter (Math::CalculateUV/NDC)."""
    px = jnp.arange(width, dtype=jnp.float32)
    py = jnp.arange(height, dtype=jnp.float32)
    xy = jnp.stack(jnp.meshgrid(px, py, indexing="xy"), axis=-1)  # (H, W, 2)
    uv = m.calculate_uv(xy, jnp.array([width, height], jnp.float32), jitter)
    return m.calculate_ndc(uv)


def generate_pinhole_rays(cam: Camera, ndc):
    """Camera.hlsli:32-41 GeneratePinholeRay, vectorized over (..., 2) NDC.

    Returns (origin, direction, t_min, t_max)."""
    d = (ndc[..., 0:1] * cam.right + ndc[..., 1:2] * cam.up + cam.forward)
    d = m.normalize(d)
    inv_cos = 1.0 / m.dot(m.normalize(cam.forward), d)
    origin = jnp.broadcast_to(cam.position, d.shape)
    return origin, d, cam.near_depth * inv_cos, cam.far_depth * inv_cos


def generate_thin_lens_rays(cam: Camera, ndc, random2):
    """Camera.hlsli:43-54 GenerateThinLensRay (depth of field)."""
    disk = brdf.sample_uniform_disk(random2)
    r_n = m.normalize(cam.right)
    u_n = m.normalize(cam.up)
    offset = (r_n * disk[..., 0:1] + u_n * disk[..., 1:2]) \
        * cam.aperture_radius
    target = ndc[..., 0:1] * cam.right + ndc[..., 1:2] * cam.up + cam.forward
    d = m.normalize(target - offset)
    inv_cos = 1.0 / m.dot(m.normalize(cam.forward), d)
    origin = cam.position + offset
    return origin, d, cam.near_depth * inv_cos, cam.far_depth * inv_cos


def project_to_ndc(cam: Camera, world_pos, previous: bool = False):
    """World position -> (NDC xy, view depth) under this (or the previous)
    camera — used for motion vectors (GBufferGeneration.hlsl:62-91).

    Inverts the ray-generation frame: with p = world - position decomposed
    in the (right, up, forward) frame, NDC = (p·r̂ / (|r| z), p·û / (|u| z))
    where z = p·f̂ / |f| is the normalized forward depth.
    """
    pos = cam.prev_position if previous else cam.position
    r = cam.prev_right if previous else cam.right
    u = cam.prev_up if previous else cam.up
    f = cam.prev_forward if previous else cam.forward
    p = world_pos - pos
    # Orthogonalize: u ⟂ f by construction; r ⟂ u,f by construction.
    rr, uu, ff = m.dot(r, r), m.dot(u, u), m.dot(f, f)
    z = m.dot(p, f) / ff                       # multiples of |f| along f̂
    x = m.dot(p, r) / rr
    y = m.dot(p, u) / uu
    z_safe = jnp.where(jnp.abs(z) < 1e-8, 1e-8, z)
    return jnp.stack([x / z_safe, y / z_safe], axis=-1), z * jnp.sqrt(ff)


def ndc_to_pixel(ndc, width: int, height: int):
    """Inverse of Math::CalculateNDC -> pixel coordinates (float)."""
    uv = (ndc - jnp.array([-1.0, 1.0])) / jnp.array([2.0, -2.0])
    return uv * jnp.array([width, height], jnp.float32) - 0.5


class CameraController:
    """Quaternion fly-camera — host-side port of the reference's
    CameraController (Source/Camera.ixx:38-178): translate in the local
    frame, yaw around world-up / pitch around local-right / roll around
    forward (Camera.ixx:109), lens setup by horizontal FOV
    (SetLens:138-153), focus-distance scaling. Produces the CameraPose the
    pipeline consumes; numpy state (input handling is host-side, like the
    reference's ProcessInput, App.cpp:812-970)."""

    def __init__(self, position=(0.0, 0.0, -15.0), forward=(0.0, 0.0, 1.0),
                 up=(0.0, 1.0, 0.0)):
        self.position = np.asarray(position, np.float64)
        f = np.asarray(forward, np.float64)
        self._forward = f / np.linalg.norm(f)
        u = np.asarray(up, np.float64)
        r = np.cross(u, self._forward)
        self._right = r / np.linalg.norm(r)
        self._up = np.cross(self._forward, self._right)

    @property
    def forward(self):
        return self._forward.copy()

    @property
    def right(self):
        return self._right.copy()

    @property
    def up(self):
        return self._up.copy()

    def translate(self, displacement) -> None:
        """Move in the local frame (right, up, forward) — Camera.ixx:105."""
        d = np.asarray(displacement, np.float64)
        self.position = (self.position + d[0] * self._right
                         + d[1] * self._up + d[2] * self._forward)

    @staticmethod
    def _rotate(v, axis, angle):
        axis = axis / np.linalg.norm(axis)
        c, s = np.cos(angle), np.sin(angle)
        return (v * c + np.cross(axis, v) * s
                + axis * np.dot(axis, v) * (1.0 - c))

    def rotate(self, yaw: float = 0.0, pitch: float = 0.0,
               roll: float = 0.0) -> None:
        """Camera.ixx:109: yaw about world +Y, pitch about local right,
        roll about local forward (signs match the reference)."""
        for axis, angle in (((0.0, 1.0, 0.0), yaw),
                            (self._right, -pitch),
                            (self._forward, -roll)):
            if angle:
                axis = np.asarray(axis, np.float64)
                self._forward = self._rotate(self._forward, axis, angle)
                self._right = self._rotate(self._right, axis, angle)
        self._forward /= np.linalg.norm(self._forward)
        self._right -= self._forward * np.dot(self._right, self._forward)
        self._right /= np.linalg.norm(self._right)
        self._up = np.cross(self._forward, self._right)

    def look_at(self, target) -> None:
        f = np.asarray(target, np.float64) - self.position
        self._forward = f / np.linalg.norm(f)
        r = np.cross((0.0, 1.0, 0.0), self._forward)
        if np.linalg.norm(r) < 1e-6:
            r = np.array([1.0, 0.0, 0.0])
        self._right = r / np.linalg.norm(r)
        self._up = np.cross(self._forward, self._right)

    def pose(self):
        """CameraPose pytree for RenderPipeline.render_frame."""
        from ..models.pipeline import CameraPose
        return CameraPose(
            position=jnp.asarray(self.position, jnp.float32),
            forward=jnp.asarray(self._forward, jnp.float32),
            up=jnp.asarray(self._up, jnp.float32))


# Key bindings for the CLI fly-camera (the terminal stand-in for the
# reference's ProcessInput WASD+mouse handling, App.cpp:812-970):
# translation in the local frame, ijkl/uo look, r reset, p screenshot,
# x quit.
KEY_HELP = ("w/s fwd/back  a/d left/right  q/e down/up  "
            "j/l yaw  i/k pitch  u/o roll  r reset  p screenshot  x quit")


def apply_input_key(controller: CameraController, key: str,
                    move_step: float = 1.0,
                    turn_step: float = np.deg2rad(5.0)) -> str:
    """Apply one key to the controller. Returns the action taken:
    'move' | 'turn' | 'reset' | 'screenshot' | 'quit' | '' (ignored)."""
    moves = {"w": (0, 0, 1), "s": (0, 0, -1), "a": (-1, 0, 0),
             "d": (1, 0, 0), "q": (0, -1, 0), "e": (0, 1, 0)}
    turns = {"j": (-1, 0, 0), "l": (1, 0, 0), "i": (0, 1, 0),
             "k": (0, -1, 0), "u": (0, 0, -1), "o": (0, 0, 1)}
    k = key.lower()
    if k in moves:
        controller.translate(np.asarray(moves[k], np.float64) * move_step)
        return "move"
    if k in turns:
        yaw, pitch, roll = (np.asarray(turns[k], np.float64) * turn_step)
        controller.rotate(yaw=yaw, pitch=pitch, roll=roll)
        return "turn"
    if k == "r":
        return "reset"
    if k == "p":
        return "screenshot"
    if k == "x":
        return "quit"
    return ""
