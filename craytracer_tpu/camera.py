"""Camera + film: batched primary-ray generation.

Re-designs the reference's per-pixel `calcImageCoord`/`calcCameraRay`
(camera.cpp:80-157) as one vectorized raygen over `[N]` pixel indices — the
first wavefront stage. Conventions preserved for image parity:

* lookAt basis: z = -normalize(look - pos); x = normalize(up x z);
  y = z x x  (cameraLookAt, camera.cpp:53-68).
* film physical size: frame_length = 2 sin(fov/2) * focal_dist — the
  reference uses sin, not tan (calcFilmDimension, camera.cpp:144-149).
* image-plane coords: x = -L/2 + px_len (col + jitter_x),
  y =  H/2 - px_len (row + jitter_y)  (calcImageCoord, camera.cpp:151-157).
* pinhole ray: origin on the view plane, direction from the focal point
  through the view-plane sample (calcRayPinhole, camera.cpp:80-92).
* thin lens: origin jittered on the lens disk, aimed at the focal-plane
  point (calcRayThinLens, camera.cpp:94-127).
"""

from __future__ import annotations

from craytracer_tpu.core import struct
import jax.numpy as jnp
import numpy as np

from craytracer_tpu.core import math as vm
from craytracer_tpu.sampling.mappings import map_to_disk_polar

PINHOLE = 0
THINLENS = 1


@struct.dataclass
class Camera:
    """Differentiable camera parameters (a pytree leaf set).

    `camera_type` is static metadata (pytree aux) so jit specializes on it.
    """

    position: jnp.ndarray  # [3]
    x_axis: jnp.ndarray  # [3]
    y_axis: jnp.ndarray  # [3]
    z_axis: jnp.ndarray  # [3]
    focal_dist: jnp.ndarray  # scalar; view-plane distance (0.035 default)
    focal_length: jnp.ndarray  # scalar; focal-plane distance (thin lens)
    lens_radius: jnp.ndarray  # scalar
    camera_type: int = struct.field(pytree_node=False, default=PINHOLE)


@struct.dataclass
class Film:
    fov: jnp.ndarray  # radians (vertical of width-based per reference)
    width: int = struct.field(pytree_node=False, default=256)
    height: int = struct.field(pytree_node=False, default=256)

    @property
    def num_pixels(self) -> int:
        return self.width * self.height


def make_camera(
    position,
    look_point,
    up=(0.0, 1.0, 0.0),
    focal_dist: float = 0.035,
    camera_type: int = PINHOLE,
    focal_length: float = 3.0,
    lens_radius: float = 0.2,
) -> Camera:
    position = np.asarray(position, np.float32)
    look = np.asarray(look_point, np.float32)
    up = np.asarray(up, np.float32)
    z = -(look - position)
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return Camera(
        position=jnp.asarray(position),
        x_axis=jnp.asarray(x),
        y_axis=jnp.asarray(y),
        z_axis=jnp.asarray(z),
        focal_dist=jnp.float32(focal_dist),
        focal_length=jnp.float32(focal_length),
        lens_radius=jnp.float32(lens_radius),
        camera_type=camera_type,
    )


def make_camera_jax(position, look_point, up=(0.0, 1.0, 0.0),
                    focal_dist=0.035, camera_type: int = PINHOLE,
                    focal_length=3.0, lens_radius=0.2) -> Camera:
    """Differentiable lookAt (jnp end-to-end): gradients flow through the
    camera basis, so position AND orientation are optimizable leaves —
    `make_camera` is the host-side numpy twin."""
    position = jnp.asarray(position, jnp.float32)
    look = jnp.asarray(look_point, jnp.float32)
    upv = jnp.asarray(up, jnp.float32)
    z = vm.normalize(position - look)
    x = vm.normalize(vm.cross(upv, z))
    y = vm.cross(z, x)
    return Camera(
        position=position, x_axis=x, y_axis=y, z_axis=z,
        focal_dist=jnp.asarray(focal_dist, jnp.float32),
        focal_length=jnp.asarray(focal_length, jnp.float32),
        lens_radius=jnp.asarray(lens_radius, jnp.float32),
        camera_type=camera_type,
    )


def film_dims(film: Film, camera: Camera):
    """(frame_length, frame_height, pixel_length) — calcFilmDimension."""
    frame_length = 2.0 * jnp.sin(film.fov / 2.0) * camera.focal_dist
    frame_height = frame_length * (film.height / film.width)
    pixel_length = frame_length / film.width
    return frame_length, frame_height, pixel_length


def generate_rays(camera: Camera, film: Film, pixel_ids, jitter, lens_u=None):
    """Primary rays for `pixel_ids` ([N] int32) with per-pixel film jitter
    ([N, 2] in [0,1)). Returns (origin[N,3], direction[N,3]).

    `lens_u` ([N, 2]) supplies the lens samples for thin-lens cameras.
    """
    frame_length, frame_height, pixel_length = film_dims(film, camera)
    col = (pixel_ids % film.width).astype(jnp.float32)
    row = (pixel_ids // film.width).astype(jnp.float32)
    ix = -frame_length / 2.0 + pixel_length * (col + jitter[..., 0])
    iy = frame_height / 2.0 - pixel_length * (row + jitter[..., 1])

    if camera.camera_type == PINHOLE:
        # view-plane sample in camera space is (ix, iy, 0); focal point at
        # (0, 0, focal_dist). Direction = sample - focal_point.
        d_cam = jnp.stack([ix, iy, -jnp.broadcast_to(camera.focal_dist, ix.shape)], axis=-1)
        direction = vm.normalize(
            d_cam[..., 0:1] * camera.x_axis
            + d_cam[..., 1:2] * camera.y_axis
            + d_cam[..., 2:3] * camera.z_axis
        )
        origin = (
            ix[..., None] * camera.x_axis
            + iy[..., None] * camera.y_axis
            + camera.position
        )
        return origin, direction

    # Thin lens (calcRayThinLens): lens point at z = focal_dist plane,
    # focal-plane point at -focal_length scaled through the pinhole.
    disk = map_to_disk_polar(lens_u) * camera.lens_radius
    scale = camera.focal_length / camera.focal_dist
    fp = jnp.stack(
        [ix * scale, iy * scale, -jnp.broadcast_to(camera.focal_length, ix.shape)],
        axis=-1,
    )
    o_cam = jnp.stack(
        [disk[..., 0], disk[..., 1], jnp.broadcast_to(camera.focal_dist, ix.shape)],
        axis=-1,
    )
    d_cam = vm.normalize(fp - o_cam)
    direction = (
        d_cam[..., 0:1] * camera.x_axis
        + d_cam[..., 1:2] * camera.y_axis
        + d_cam[..., 2:3] * camera.z_axis
    )
    origin = (
        o_cam[..., 0:1] * camera.x_axis
        + o_cam[..., 1:2] * camera.y_axis
        + o_cam[..., 2:3] * camera.z_axis
        + camera.position
    )
    return origin, direction
