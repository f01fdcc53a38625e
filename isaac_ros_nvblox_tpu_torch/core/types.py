"""Core geometric types (port of isaac_ros_nvblox_tpu/core/types.py).

Plain tensors stand in for nvblox's Eigen types:

  * a point/vector is `f32[3]` (batched: `f32[..., 3]`)
  * a rigid transform is a homogeneous `f32[4, 4]`
  * a block index is `i32[3]` (batched: `i32[..., 3]`)

Blocks are 8x8x8 voxels; the 512 voxels of a block are flattened x-major,
z-fastest: lane v = lx*64 + ly*8 + lz (the JAX package's pool layout, so
pool rows compare one for one).

Rounding. The reference's float32 arithmetic is what XLA's CPU backend
emits, and that backend contracts `a*b + c` into one fused multiply-add
(one rounding). `fma` below reproduces that rounding on any device: the
product is exact in float64, the float64 sum is rounded to odd, and the
conversion to float32 then rounds it once, correctly (a float64 sum
rounded to nearest would round a second time where it lands on a
float32 tie); on a card, float32 `torch.addcmul` where it is one fused
multiply-add. XLA also turns a division by a constant into a product
with the constant's float32 reciprocal (`recip32`). The port follows both
in XLA's accumulation order, so its float32 results equal the reference's
on the CPU (up to rare last-bit differences where XLA orders a product
otherwise), and the CUDA kernels (built with `-fmad=false`) repeat the
port's steps exactly on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

# Voxels along each side of a cubic VoxelBlock (nvblox kVoxelsPerSide).
VOXELS_PER_SIDE: int = 8
VOXELS_PER_BLOCK: int = VOXELS_PER_SIDE ** 3  # 512


def block_size_m(voxel_size_m: float) -> float:
    return VOXELS_PER_SIDE * voxel_size_m


@dataclasses.dataclass(frozen=True)
class AABB:
    """Axis-aligned bounding box in meters (nvblox's
    AxisAlignedBoundingBox)."""

    min_m: Tuple[float, float, float]
    max_m: Tuple[float, float, float]

    def contains(self, p) -> torch.Tensor:
        """bool[...]: whether each point `f32[..., 3]` lies in the box
        (faces included)."""
        lo = torch.tensor(self.min_m, dtype=torch.float32, device=p.device)
        hi = torch.tensor(self.max_m, dtype=torch.float32, device=p.device)
        return ((p >= lo) & (p <= hi)).all(dim=-1)

    def size(self) -> np.ndarray:
        return (np.asarray(self.max_m, np.float64)
                - np.asarray(self.min_m, np.float64))


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller asks
    for another. Raises when CUDA is asked for (or defaulted to) and no
    card is present — entry points never carry on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


def _f64(x):
    # Python scalars are float32 constants in the reference (weak types);
    # they stay Python floats here so that no host->device copy is made.
    return x.double() if isinstance(x, torch.Tensor) else float(np.float32(x))


# float64 bits below float32's last mantissa bit, and their value at a
# float32 tie; float32's smallest normal magnitude.
_BELOW_F32 = (1 << 29) - 1
_F32_TIE = 1 << 28
_F32_MIN_NORMAL = 2.0 ** -126
# Per CUDA device: whether float32 `torch.addcmul` is one fused
# multiply-add there (`_addcmul_is_fma`).
_ADDCMUL_FMA = {}


def _fma_round_to_odd(p, c, s) -> torch.Tensor:
    """float32 of the exact p + c (p, c float64; s = p + c rounded to
    nearest): s rounded to odd (TwoSum's error e, s + e == p + c; where e
    is not 0, the neighbour of s toward it whose last bit is odd), which
    the conversion then rounds once."""
    pp = s - c
    e = (p - pp) + (c - (s - pp))
    odd_step = (e != 0) & ((s.view(torch.int64) & 1) == 0)
    inf = torch.full((), float("inf"), dtype=torch.float64, device=s.device)
    return torch.where(odd_step, torch.nextafter(s, torch.copysign(inf, e)),
                       s).float()


def _fma_f64(a, b, c) -> torch.Tensor:
    """`fma` through float64 on any device."""
    p = _f64(a) * _f64(b)
    c = _f64(c)
    s = p + c
    if s.device.type != "cpu" or s.dim() == 0:
        return _fma_round_to_odd(p, c, s)
    # Only a float64 sum on a float32 tie (or below float32's normal
    # range) can round twice; elsewhere its float32 rounding is the exact
    # value's. So on the CPU only those sums are rounded to odd (on a card
    # the selection would cost a host sync).
    r = s.float()
    bits = s.view(torch.int64)
    idx = torch.nonzero(((bits & _BELOW_F32) == _F32_TIE)
                        | (s.abs() < _F32_MIN_NORMAL), as_tuple=True)
    if idx[0].numel():
        p, c = (torch.broadcast_to(torch.as_tensor(x, dtype=torch.float64),
                                   s.shape)[idx] for x in (p, c))
        r[idx] = _fma_round_to_odd(p, c, s[idx])
    return r


def _addcmul_is_fma(device) -> bool:
    """Whether float32 `torch.addcmul(c, a, b)` rounds a*b + c once on this
    CUDA device (ATen's `a + alpha * b * c`, which nvcc contracts into one
    fused multiply-add): held against `_fma_f64` once, on operands whose
    float64 sums land on float32 ties and on random ones of wide range.
    The check syncs with the host, so it runs outside any sync debug
    mode."""
    key = device.index if device.index is not None else \
        torch.cuda.current_device()
    if key not in _ADDCMUL_FMA:
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            g = torch.Generator(device="cpu").manual_seed(0)
            n = 1 << 16
            ops = [torch.randn(n, generator=g) * torch.exp2(
                torch.randint(lo, 30, (n,), generator=g).float())
                for lo in (-30, -30, -60)]
            tie = ((1 - 2 ** -20, 2 ** -24 * (1 + 2 ** -20), 1 + 2 ** -23),
                   (-(1 - 2 ** -20), 2 ** -24 * (1 + 2 ** -20),
                    -(1 + 2 ** -23)))
            a, b, c = (torch.cat([x, torch.tensor([t[i] for t in tie])])
                       .to(device) for i, x in enumerate(ops))
            _ADDCMUL_FMA[key] = bool(torch.equal(
                torch.addcmul(c, a, b), _fma_f64(a, b, c)))
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    return _ADDCMUL_FMA[key]


def fma(a, b, c) -> torch.Tensor:
    """float32 `a*b + c` with a single rounding of the product-sum (see
    the module docstring). At least one of `a`, `b` is a tensor. On a card
    whose float32 `torch.addcmul` is one fused multiply-add, that op for
    float32 operands; elsewhere float64 with the sum rounded to odd."""
    t = a if isinstance(a, torch.Tensor) else b
    if (t.device.type == "cuda"
            and all(x.dtype == torch.float32 for x in (a, b, c)
                    if isinstance(x, torch.Tensor))
            and _addcmul_is_fma(t.device)):
        def f32(x):
            return (x.float() if isinstance(x, torch.Tensor) else torch.full(
                (), float(np.float32(x)), device=t.device))
        return torch.addcmul(f32(c), f32(a), f32(b))
    return _fma_f64(a, b, c)


def recip32(c: float) -> float:
    """float32 reciprocal of a constant: XLA rewrites `x / c` for a
    constant `c` as `x * (1/c)`, rounding 1/c to float32 first."""
    return float(np.float32(1.0) / np.float32(c))


def mat3_rows(M, x, y, z, t=None):
    """Rows of `M @ [x, y, z] (+ t)` in XLA's order: x*M[i,0], then fused
    multiply-adds of y and z, then the translation."""
    out = []
    for i in range(3):
        s = x * M[i, 0]
        s = fma(y, M[i, 1], s)
        s = fma(z, M[i, 2], s)
        if t is not None:
            s = s + t[i]
        out.append(s)
    return out


class Transform:
    """Helpers for homogeneous 4x4 rigid transforms (f32[4,4] tensors).

    `T_A_B` maps points in frame B to frame A: `p_A = T_A_B @ p_B`.
    """

    @staticmethod
    def identity(device=None) -> torch.Tensor:
        return torch.eye(4, dtype=torch.float32, device=resolve_device(device))

    @staticmethod
    def inverse(T) -> torch.Tensor:
        R = T[:3, :3]
        Rinv = R.T
        Ti = torch.eye(4, dtype=torch.float32, device=T.device)
        Ti[:3, :3] = Rinv
        # -Rinv @ t, accumulated as XLA does.
        nR = -Rinv
        t = T[:3, 3]
        Ti[:3, 3] = torch.stack(mat3_rows(nR, t[0], t[1], t[2]))
        return Ti

    @staticmethod
    def apply(T, points) -> torch.Tensor:
        """Transform points `f32[..., 3]` by `T` (f32[4,4])."""
        x, y, z = points[..., 0], points[..., 1], points[..., 2]
        return torch.stack(mat3_rows(T[:3, :3], x, y, z, T[:3, 3]), dim=-1)

    @staticmethod
    def rotate(T, vectors) -> torch.Tensor:
        x, y, z = vectors[..., 0], vectors[..., 1], vectors[..., 2]
        return torch.stack(mat3_rows(T[:3, :3], x, y, z), dim=-1)

    @staticmethod
    def from_rotation_translation(R, t) -> torch.Tensor:
        """`f32[..., 4, 4]` from rotations `[..., 3, 3]` and translations
        `[..., 3]`."""
        R = torch.as_tensor(R, dtype=torch.float32)
        t = torch.as_tensor(t, dtype=torch.float32, device=R.device)
        T = torch.zeros(R.shape[:-2] + (4, 4), dtype=torch.float32,
                        device=R.device)
        T[..., :3, :3] = R
        T[..., :3, 3] = t
        T[..., 3, 3] = 1.0
        return T

    @staticmethod
    def interpolate(T0, T1, alpha) -> torch.Tensor:
        """Pose at `alpha` between T0 and T1: translation lerp, rotation by
        normalized quaternion lerp (shortest arc). `alpha` may be a float
        or a tensor `f32[K]` (then `f32[K, 4, 4]`)."""
        q0 = quaternion_from_matrix(T0[:3, :3])
        q1 = quaternion_from_matrix(T1[:3, :3])
        q1 = torch.where(torch.sum(q0 * q1) < 0.0, -q1, q1)
        a = torch.as_tensor(alpha, dtype=torch.float32, device=T0.device)
        a4 = a[..., None]
        q = q0 * (1.0 - a4) + q1 * a4
        q = q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True),
                                1e-12)
        t = T0[:3, 3] * (1.0 - a4) + T1[:3, 3] * a4
        return Transform.from_rotation_translation(matrix_from_quaternion(q),
                                                   t)


def quaternion_from_matrix(R) -> torch.Tensor:
    """Rotation matrix `f32[3, 3]` -> unit quaternion (w, x, y, z), by the
    branch-free 4-candidate construction: each candidate from one pivot of
    the diagonal, the largest pivot chosen by `where`."""
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp_min(x, 1e-12))

    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
                      (m10 - m01) / s0])
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                      (m02 + m20) / s1])
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                      (m12 + m21) / s2])
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                      0.25 * s3])
    use0 = tr > 0.0
    use1 = ~use0 & (m00 > m11) & (m00 > m22)
    use2 = ~use0 & ~use1 & (m11 > m22)
    q = torch.where(use0, q0, torch.where(use1, q1, torch.where(use2, q2,
                                                                 q3)))
    return q / torch.clamp_min(torch.linalg.norm(q), 1e-12)


def matrix_from_quaternion(q) -> torch.Tensor:
    """Unit quaternions `[..., 4]` (w, x, y, z) -> rotations `[..., 3, 3]`."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                         2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                         2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                         1 - 2 * (x * x + y * y)], -1)]
    return torch.stack(rows, -2).to(torch.float32)


def sqrt32(x) -> torch.Tensor:
    """float32 square root, correctly rounded on every device (the CPU's
    vectorized float32 sqrt is not; the float64 root rounds exactly)."""
    return torch.sqrt(x.double()).float()


def norm3(v) -> torch.Tensor:
    """Euclidean norm over the last axis (size 3), in XLA's order and
    correctly rounded (`sqrt32`)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return sqrt32(fma(z, z, fma(y, y, x * x)))


def local_voxel_offsets() -> np.ndarray:
    """`i32[512, 3]` local (x, y, z) voxel coordinates within a block,
    index = (x*8 + y)*8 + z."""
    r = np.arange(VOXELS_PER_SIDE)
    xx, yy, zz = np.meshgrid(r, r, r, indexing="ij")
    return np.stack([xx, yy, zz], axis=-1).reshape(-1, 3).astype(np.int32)


def set_rows_drop(dst, idx, values) -> torch.Tensor:
    """`dst[idx] = values` in place, dropping entries whose index lies
    outside [0, len(dst)) — JAX's `.at[idx].set(values, mode="drop")`
    without a host sync (a boolean filter would sync on CUDA).

    Dropped entries are redirected to the target of the first kept entry
    with that entry's value, or, when none is kept, rewrite one row's
    current value; duplicate writes therefore always carry equal values.
    """
    if idx.numel() == 0:
        return dst
    n = dst.shape[0]
    if not isinstance(values, torch.Tensor):
        values = torch.full((), values, dtype=dst.dtype, device=dst.device)
    values = values.to(dst.dtype).expand(tuple(idx.shape) + tuple(dst.shape[1:]))
    valid = (idx >= 0) & (idx < n)
    safe = idx.clamp(0, n - 1).long()
    # Entry j as 1-element slices: indexing with a 0-dim tensor would read
    # it back to the host.
    j = torch.argmax(valid.to(torch.uint8)).view(1)
    tail = (1,) * (values.dim() - 1)
    safe_j = safe.index_select(0, j)
    fallback = torch.where(valid.index_select(0, j).view((1,) + tail),
                           values.index_select(0, j),
                           dst.index_select(0, safe_j))
    target = torch.where(valid, safe, safe_j)
    keep = valid.view(valid.shape + tail)
    dst.index_put_((target,), torch.where(keep, values, fallback))
    return dst


_CONSTANTS = {}


def device_constant(array: np.ndarray, device) -> torch.Tensor:
    """A module-level numpy constant as a tensor on `device`, copied there
    once; later calls make no host->device copy (which would synchronize
    the stream)."""
    key = (id(array), torch.device(device))
    t = _CONSTANTS.get(key)
    if t is None:
        t = torch.as_tensor(array, device=device)
        _CONSTANTS[key] = t
    return t


def device_ints(values, dtype, device) -> torch.Tensor:
    """A small integer tensor on `device` from host values, made of fill
    kernels: no host->device copy, which would synchronize the stream."""
    return torch.stack([torch.full((), int(v), dtype=dtype, device=device)
                        for v in values])


_LOCAL_OFFSETS = local_voxel_offsets()


def voxel_centers_for_blocks(block_indices, voxel_size_m: float) -> torch.Tensor:
    """World-frame voxel centers `f32[N, 512, 3]` for blocks `i32[N, 3]`."""
    offs = device_constant(_LOCAL_OFFSETS, block_indices.device)
    vox = block_indices[:, None, :] * VOXELS_PER_SIDE + offs[None, :, :]
    return (vox.float() + 0.5) * float(np.float32(voxel_size_m))


def block_index_of_position(p_m, voxel_size_m: float) -> torch.Tensor:
    """Position `f32[..., 3]` -> containing block index `i32[..., 3]`."""
    bs = block_size_m(voxel_size_m)
    return torch.floor(p_m / bs).to(torch.int32)


def global_voxel_index_of_position(p_m, voxel_size_m: float) -> torch.Tensor:
    """Position `f32[..., 3]` -> global voxel index `i32[..., 3]`."""
    return torch.floor(p_m / voxel_size_m).to(torch.int32)
