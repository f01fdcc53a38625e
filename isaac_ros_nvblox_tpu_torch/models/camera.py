"""Pinhole camera model (port of isaac_ros_nvblox_tpu/models/camera.py).

A camera is a small frozen dataclass; its projection math is plain tensor
code on whatever device the points live on. Width/height are Python ints.
"""

from __future__ import annotations

import dataclasses

import torch

from isaac_ros_nvblox_tpu_torch.core.types import norm3, recip32


@dataclasses.dataclass(frozen=True)
class Camera:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    def intrinsics(self, device=None) -> torch.Tensor:
        """`f32[4]`: (fx, fy, cx, cy)."""
        return torch.tensor([self.fx, self.fy, self.cx, self.cy],
                            dtype=torch.float32, device=device)

    def project(self, p_C):
        """Project camera-frame points `f32[..., 3]` to pixels.

        Returns (uv f32[..., 2], valid bool[...]). Valid requires z > 0 and
        the pixel center inside the image bounds.
        """
        z = p_C[..., 2]
        eps = 1e-6
        z_safe = torch.where(z > eps, z, torch.ones_like(z))
        u = self.fx * p_C[..., 0] / z_safe + self.cx
        v = self.fy * p_C[..., 1] / z_safe + self.cy
        uv = torch.stack([u, v], dim=-1)
        valid = ((z > eps)
                 & (u >= 0.0) & (u <= self.width - 1.0)
                 & (v >= 0.0) & (v <= self.height - 1.0))
        return uv, valid

    def unproject(self, u, v, depth):
        """Pixel (u, v) + depth (z-depth, meters) -> camera-frame point."""
        x = (u - self.cx) * recip32(self.fx) * depth
        y = (v - self.cy) * recip32(self.fy) * depth
        return torch.stack([x, y, torch.broadcast_to(depth, x.shape)], dim=-1)

    def ray_directions(self, device=None):
        """Unit ray direction per pixel, `f32[H, W, 3]` in camera frame."""
        us = torch.arange(self.width, dtype=torch.float32, device=device)
        vs = torch.arange(self.height, dtype=torch.float32, device=device)
        vv, uu = torch.meshgrid(vs, us, indexing="ij")
        # XLA turns a division by a constant into a product with its
        # float32 reciprocal; so does the port, to round alike.
        d = torch.stack([(uu - self.cx) * recip32(self.fx),
                         (vv - self.cy) * recip32(self.fy),
                         torch.ones_like(uu)], dim=-1)
        return d / norm3(d)[..., None]

    def frustum_corner_directions(self, max_depth: float,
                                  device=None) -> torch.Tensor:
        """The 4 far-plane corners in the camera frame, `f32[4, 3]`
        (pixels (0, 0), (W-1, 0), (0, H-1), (W-1, H-1) at `max_depth`)."""
        uv = torch.tensor([[0.0, 0.0], [self.width - 1.0, 0.0],
                           [0.0, self.height - 1.0],
                           [self.width - 1.0, self.height - 1.0]],
                          dtype=torch.float32, device=device)
        return self.unproject(uv[:, 0], uv[:, 1],
                              torch.full((4,), max_depth, dtype=torch.float32,
                                         device=device))

    def scaled(self, factor: float) -> "Camera":
        """The camera of an image scaled by `factor` (a mask at half
        resolution: `scaled(0.5)`); width and height rounded."""
        return Camera(self.fx * factor, self.fy * factor,
                      self.cx * factor, self.cy * factor,
                      int(round(self.width * factor)),
                      int(round(self.height * factor)))


def sample_image_nearest(image, uv, fill=0.0):
    """Nearest-neighbor sample `image[H, W, ...]` at pixel coords `uv[..., 2]`.

    Rounds half to even (as `jnp.round` does); coordinates are clamped to
    the image before the integer conversion, which leaves every in-range
    result as it is and keeps far-out-of-view values defined. `fill` is
    accepted and unused, as in the reference: no pixel is out of range
    after the clamp.
    """
    del fill
    H, W = image.shape[0], image.shape[1]
    u = torch.round(uv[..., 0]).clamp(-1.0, float(W)).long().clamp(0, W - 1)
    v = torch.round(uv[..., 1]).clamp(-1.0, float(H)).long().clamp(0, H - 1)
    return image[v, u]


def sample_image_bilinear(image, uv):
    """Bilinear sample of a single-channel `image[H, W]` at pixel coords
    `uv[..., 2]`, clamped to the image (border pixels repeat)."""
    H, W = image.shape[0], image.shape[1]
    u = uv[..., 0].clamp(0.0, W - 1.0)
    v = uv[..., 1].clamp(0.0, H - 1.0)
    u0 = torch.floor(u).long()
    v0 = torch.floor(v).long()
    u1 = (u0 + 1).clamp_max(W - 1)
    v1 = (v0 + 1).clamp_max(H - 1)
    fu = u - u0.float()
    fv = v - v0.float()
    i00, i01 = image[v0, u0], image[v0, u1]
    i10, i11 = image[v1, u0], image[v1, u1]
    return ((i00 * (1 - fu) + i01 * fu) * (1 - fv)
            + (i10 * (1 - fu) + i11 * fu) * fv)
