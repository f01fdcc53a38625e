"""Publish-cadence adapters of the DeviceMapper: slices, the dense ESDF
grid, the host mesh layer, map save / load and the removal ring (port of
isaac_ros_nvblox_tpu/mapper/device_io.py).

These are the paths that cross from the device to the host, at publish
cadence (the reference serializes the same way, layer_publishing.cpp:
702-826 and conversions/*.cu); the mapping tick never calls them.

  * `take_removed_blocks`: the new entries of the freed-block ring.
  * `slice_esdf_device`: the 3-D ESDF at one height, gathered through the
    slot grid, cropped to its known content; `slice_esdf_2d_device`: the
    2-D ESDF as an image `[H = y, W = x]`.
  * `esdf_and_gradients_device`: a dense signed ESDF grid over an AABB and
    its central-difference gradients.
  * `update_mesh_layer`: the dirty blocks through marching cubes (kernel
    marching_cubes), the soup compacted per block into world meters on
    the card (kernel mesh_compact), three reads (the live-row, deferred
    and live-vertex counts; the CSR ints; the vertices and colors), then
    the weld into the host `MeshLayer`, with the no-crossing and removed
    blocks dropped; spans `mapper/mesh/march`, `mapper/mesh/readback`,
    `mapper/mesh/layer`.
  * `save_map_device` / `load_map_device`: the live blocks' channels in
    an npz file (format 2, the reference's keys and metadata: a map saved
    by either package loads in the other).

Every read of the device goes through `utils/timing.to_host`, which
counts it.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from isaac_ros_nvblox_tpu_torch.core import world_grid as wg
from isaac_ros_nvblox_tpu_torch.core.types import VOXELS_PER_SIDE, sqrt32
from isaac_ros_nvblox_tpu_torch.mapper.device_mapper import _CHANNEL_RESET
from isaac_ros_nvblox_tpu_torch.ops.dense_grid import (central_gradients,
                                                       gather_dense)
from isaac_ros_nvblox_tpu_torch.ops.esdf_slicer import SliceSpec
from isaac_ros_nvblox_tpu_torch.ops.mesh_cuda import (mesh_compact,
                                                      mesh_row_offsets)
from isaac_ros_nvblox_tpu_torch.utils.timing import Timer, Timing, to_host

B = VOXELS_PER_SIDE
FORMAT_VERSION = 2


# ---------------------------------------------------------------- removals
def take_removed_blocks(m) -> List[Tuple[int, int, int]]:
    """The blocks freed since the last call, oldest first (one scalar and
    one ring readback). Where more were freed than the ring holds, the
    overwritten oldest ones are lost and the ring's newest `cap` come
    back."""
    count = int(to_host(m.removed_count))
    K = m.removed_log.shape[0]
    new = count - m._removed_read
    if new <= 0:
        return []
    new = min(new, K)
    log = to_host(m.removed_log)
    m._removed_read = count
    return [tuple(int(v) for v in row)
            for row in log[np.arange(count - new, count) % K]]


# --------------------------------------------------------------- distances
def _signed_distance(sq, inside, voxel_size_m: float,
                     max_distance_m: Optional[float] = None):
    """Signed meters from squared voxel distances, in the reference's
    float32 order: sqrt(min(sq, 1e12)) * voxel, clamped, negated
    inside."""
    dist = sqrt32(torch.clamp_max(sq, 1e12)) * float(np.float32(voxel_size_m))
    if max_distance_m is not None:
        dist = torch.clamp_max(dist, float(np.float32(max_distance_m)))
    return torch.where(inside, -dist, dist)


def _voxel_lookup(state, gx, gy, gz):
    """(slot, voxel) of global voxel indices (broadcast i32 tensors), slot
    -1 where the block lies outside the world grid or is unallocated."""
    bx, by, bz = (torch.div(g, B, rounding_mode="floor")
                  for g in (gx, gy, gz))
    shape = torch.broadcast_shapes(bx.shape, by.shape, bz.shape)
    cell = torch.stack([b.expand(shape) for b in (bx, by, bz)], -1) \
        - state.origin_block
    dims = state.slot_grid.shape
    ok = torch.ones(shape, dtype=torch.bool, device=cell.device)
    for a in range(3):
        ok &= (cell[..., a] >= 0) & (cell[..., a] < dims[a])
        cell[..., a].clamp_(0, dims[a] - 1)
    slot = state.slot_grid[cell[..., 0].long(), cell[..., 1].long(),
                           cell[..., 2].long()]
    slot = torch.where(ok, slot, -1)
    vox = ((gx - bx * B) * B + (gy - by * B)) * B + (gz - bz * B)
    return slot, vox.expand(shape)


@torch.no_grad()
def _slice_gather(m, origin_vox_xy, gz: int, *, H: int, W: int,
                  max_distance_m: float, unknown_value: float):
    """Signed distance per pixel `f32[H, W]` at global voxel height gz,
    gathered through the slot grid; `unknown_value` where the voxel is
    unallocated or unobserved."""
    dev = m.device
    gx = torch.arange(W, dtype=torch.int32, device=dev)[None, :] \
        + int(origin_vox_xy[0])
    gy = torch.arange(H, dtype=torch.int32, device=dev)[:, None] \
        + int(origin_vox_xy[1])
    gz_t = torch.full((1, 1), int(gz), dtype=torch.int32, device=dev)
    slot, vox = _voxel_lookup(m.state, gx, gy, gz_t)
    ch = m.channels
    sq, inside, obs = (gather_dense(ch[k], slot, vox, 0) for k in
                       ("esdf_sq_dist", "esdf_is_inside", "esdf_observed"))
    dist = _signed_distance(sq, inside, m.voxel_size_m, max_distance_m)
    return torch.where((slot >= 0) & obs, dist,
                       torch.full((), float(unknown_value), device=dev))


def slice_esdf_device(m, *, slice_height_m: float, max_distance_m: float,
                      unknown_value: float = 1000.0,
                      spec: Optional[SliceSpec] = None,
                      padding_px: int = 0
                      ) -> Optional[Tuple[SliceSpec, np.ndarray]]:
    """The mapper's 3-D ESDF at one height -> (spec, f32[H, W]), pixels
    (y, x); by default over the allocated AABB (plus `padding_px`), then
    cropped to the known content. None for an empty map. Parity:
    EsdfSlicer::sliceLayerToDistanceImage (nvblox_node.cpp:135-137,
    841-844)."""
    if m._aabb_lo is None and not m._refresh_region_from_device():
        return None
    if m._aabb_lo is None:
        return None
    vs = m.voxel_size_m
    if spec is None:
        lo_m = m._aabb_lo.astype(np.float64) * B * vs
        hi_m = (m._aabb_hi + 1).astype(np.float64) * B * vs
        width = int(round((hi_m[0] - lo_m[0]) / vs)) + 2 * padding_px
        height = int(round((hi_m[1] - lo_m[1]) / vs)) + 2 * padding_px
        spec = SliceSpec(origin_x_m=float(lo_m[0]) - padding_px * vs,
                         origin_y_m=float(lo_m[1]) - padding_px * vs,
                         width=width, height=height,
                         slice_height_m=slice_height_m, voxel_size_m=vs)
    ox = int(np.floor(spec.origin_x_m / vs + 0.5))
    oy = int(np.floor(spec.origin_y_m / vs + 0.5))
    gz = int(np.floor(slice_height_m / vs))
    img = to_host(_slice_gather(m, (ox, oy), gz, H=spec.height, W=spec.width,
                                max_distance_m=float(max_distance_m),
                                unknown_value=float(unknown_value)))
    # The spec covers the frustum-union AABB; crop to the known content.
    known = img < unknown_value
    if known.any():
        ys = np.nonzero(known.any(axis=1))[0]
        xs = np.nonzero(known.any(axis=0))[0]
        y0, y1 = int(ys[0]), int(ys[-1]) + 1
        x0, x1 = int(xs[0]), int(xs[-1]) + 1
        img = img[y0:y1, x0:x1]
        spec = SliceSpec(origin_x_m=spec.origin_x_m + x0 * vs,
                         origin_y_m=spec.origin_y_m + y0 * vs,
                         width=x1 - x0, height=y1 - y0,
                         slice_height_m=slice_height_m, voxel_size_m=vs)
    return spec, img


@torch.no_grad()
def slice_esdf_2d_device(m, *, max_distance_m: float,
                         unknown_value: float = 1000.0,
                         spec: Optional[SliceSpec] = None
                         ) -> Optional[Tuple[SliceSpec, np.ndarray]]:
    """The 2-D ESDF (`DeviceMapper.update_esdf_2d`) as a distance image
    `f32[H = y, W = x]`, with its spec (by default the field's own frame).
    A given spec is returned as it is, with the field placed in its frame:
    cropped where the field reaches past it, `unknown_value` where the
    field does not cover it (so that the dynamic mapper's field lines up
    with the static slice it is combined with). None before the first 2-D
    solve. The image is made on the device; one copy of it reaches the
    host."""
    if m.esdf_2d is None:
        return None
    origin_b, sq2d, inside2d, observed2d = m.esdf_2d
    vs = m.voxel_size_m
    X, Y = sq2d.shape
    if spec is None:
        spec = SliceSpec(origin_x_m=float(origin_b[0]) * B * vs,
                         origin_y_m=float(origin_b[1]) * B * vs,
                         width=X, height=Y, slice_height_m=0.0,
                         voxel_size_m=vs)
    dist = _signed_distance(sq2d, inside2d, vs, max_distance_m)
    fill = torch.full((), float(unknown_value), device=dist.device)
    img = torch.where(observed2d, dist, fill)
    # The field's first cell in the spec's frame.
    dx = int(origin_b[0]) * B - int(round(spec.origin_x_m / vs))
    dy = int(origin_b[1]) * B - int(round(spec.origin_y_m / vs))
    W, H = int(spec.width), int(spec.height)
    if (dx, dy, X, Y) != (0, 0, W, H):
        out = fill.expand(W, H).clone()
        x0, y0 = max(dx, 0), max(dy, 0)
        x1, y1 = min(dx + X, W), min(dy + Y, H)
        if x1 > x0 and y1 > y0:
            out[x0:x1, y0:y1] = img[x0 - dx:x1 - dx, y0 - dy:y1 - dy]
        img = out
    return spec, to_host(img.t())


# ----------------------------------------------------------- dense ESDF grid
@torch.no_grad()
def _dense_esdf_grid(m, lo_vox, dims, default_value: float):
    """Signed ESDF meters `f32[X, Y, Z]` at the global voxels lo_vox +
    (i, j, k); `default_value` where unallocated or unobserved."""
    dev = m.device
    g = [torch.arange(n, dtype=torch.int32, device=dev).view(
        [n if a == b else 1 for b in range(3)]) + int(lo_vox[a])
        for a, n in enumerate(dims)]
    slot, vox = _voxel_lookup(m.state, *g)
    ch = m.channels
    sq, inside, obs = (gather_dense(ch[k], slot, vox, 0) for k in
                       ("esdf_sq_dist", "esdf_is_inside", "esdf_observed"))
    dist = _signed_distance(sq, inside, m.voxel_size_m)
    return torch.where((slot >= 0) & obs, dist,
                       torch.full((), float(default_value), device=dev))


def esdf_and_gradients_device(m, aabb_min_m, aabb_max_m,
                              default_value: float = 1000.0):
    """Dense f32 grid of the signed 3-D ESDF over an AABB and its
    central-difference gradients: (grid f32[X, Y, Z], gradients
    f32[X, Y, Z, 3], origin meters f64[3]). Parity: the EsdfAndGradients
    service / Unified3DGrid (esdf_and_gradients_conversions.cu:50-125)."""
    vs = m.voxel_size_m
    lo = np.floor(np.asarray(aabb_min_m, np.float64) / vs).astype(np.int64)
    hi = np.ceil(np.asarray(aabb_max_m, np.float64) / vs).astype(np.int64)
    dims = tuple(int(d) for d in np.maximum(hi - lo, 1))
    grid = _dense_esdf_grid(m, lo, dims, float(default_value))
    grads = central_gradients(grid, vs)
    return (to_host(grid), to_host(grads),
            lo.astype(np.float64) * vs)


# ------------------------------------------------------------------ mesh IO
def update_mesh_layer(m, max_blocks: int = 2048) -> List[Tuple[int, int, int]]:
    """The dirty blocks' meshes into the host `MeshLayer`, then the
    removals. Returns the keys re-serialized (re-meshed blocks, then the
    blocks whose stale entries were dropped). Parity: updateColorMesh +
    the serialized mesh blocks + the cleared-block removals
    (layer_publishing.cpp:675-826).

    Marching cubes runs on the device (kernel marching_cubes), and so does
    the per-block CSR compaction of its soup into world meters (kernel
    mesh_compact), so that only live vertices cross to the host. Three
    reads: the counts (live rows; the blocks the budget left for a later
    update, dirty or pending after this one, counted as
    `mapper/mesh/deferred_blocks`; the live vertices, counted as
    `mapper/mesh/live_vertices`), then the CSR ints (offsets and block
    indices) and the f32 vertices and colors, each at its exact size."""
    cap = m.capacity
    with Timer("mapper/mesh/march"):
        verts, colors, _, bidx, slots = m.update_mesh_dirty_device(
            max_blocks=max_blocks, return_slots=True)
    with Timer("mapper/mesh/readback"):
        # The dirty compaction puts the live rows first; the rows past
        # them are all sentinel.
        offsets = mesh_row_offsets(verts)
        n_live_t = (slots < cap).sum().view(1)
        counts = to_host(torch.cat([
            n_live_t, (m.dirty | m.mesh_pending).sum().view(1),
            offsets.index_select(0, n_live_t)]))
        n_live, total = int(counts[0]), int(counts[2])
        Timing.add("mapper/mesh/deferred_blocks", int(counts[1]))
        Timing.add("mapper/mesh/live_vertices", total)
        csr, flat = (to_host(t) for t in mesh_compact(
            verts, colors, bidx, offsets, n_live, total, m.voxel_size_m))
    with Timer("mapper/mesh/layer"):
        meshed = _weld_mesh_rows(
            m, csr[:n_live + 1], csr[n_live + 1:].reshape(n_live, 3),
            flat[0], flat[1] if colors is not None else None)
    # The mesh rows' bytes this update copied to the host (the counts, the
    # CSR ints, the vertices and colors; not the clear keys or the ring).
    m.last_mesh_host_bytes = counts.nbytes + csr.nbytes + flat.nbytes
    return meshed


def _weld_mesh_rows(m, offsets, bidx_np, v_flat, c_flat):
    """The host half of `update_mesh_layer`: each compacted block into the
    `MeshLayer`, then the cleared blocks and the removal ring. Returns the
    keys re-serialized."""
    meshed = []
    for i in range(len(bidx_np)):
        key = tuple(int(v) for v in bidx_np[i])
        a, b = int(offsets[i]), int(offsets[i + 1])
        v = v_flat[a:b].reshape(-1, 3, 3)
        c = (c_flat[a:b].reshape(-1, 3, 3) if c_flat is not None
             and v.shape[0] else np.full_like(v, 190.0))
        m.mesh_layer.update_block(key, v, c)
        meshed.append(key)
    # Batched blocks with no surface crossing: their entries are stale.
    # The clear log accumulates over mesh updates between publishes, so
    # an entry from an earlier update must not drop a block meshed now.
    meshed_set = set(meshed)
    cleared = [k for k in m.take_mesh_clear_keys() if k not in meshed_set]
    for key in cleared:
        m.mesh_layer.blocks.pop(key, None)
    meshed.extend(cleared)
    removed = take_removed_blocks(m)
    if removed:
        m.mesh_layer.remove_blocks(removed)
    # The ring is read once: keep what this drain saw for other consumers.
    m.last_removed_keys = removed
    m.last_meshed_keys = meshed
    return meshed


# ------------------------------------------------------------------- map IO
def save_map_device(m, path) -> None:
    """Write the live blocks' indices and channels to `path` (npz, written
    at that exact path)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    slots = torch.nonzero(wg.live_slot_mask(m.state)).squeeze(1)
    payload = {"block_indices":
               to_host(m.state.block_index_of_slot[slots])}
    for name, arr in m.channels.items():
        payload[f"channel__{name}"] = to_host(arr[slots])
    meta = {
        "format_version": FORMAT_VERSION,
        "voxel_size_m": m.voxel_size_m,
        "projective_layer": m.projective_layer.value,
        "channels": sorted(m.channels.keys()),
    }
    payload["meta_json"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    # Through a file handle: savez_compressed(path) would append ".npz".
    with open(path, "wb") as f:
        np.savez_compressed(f, **payload)


def load_map_device(m, path) -> int:
    """Load a saved map into a compatible DeviceMapper, replacing its
    contents: the allocator is rebuilt with the blocks in file order in
    slots 0..n-1 (blocks outside the world grid are dropped), the other
    rows take each channel's initial value, every loaded block is dirty,
    and the removal ring, the mesh backlog, the mesh layer and the ESDF
    frames start afresh. Returns the number of blocks."""
    with np.load(Path(path)) as data:
        meta = json.loads(bytes(data["meta_json"].tobytes()).decode("utf-8"))
        if meta["format_version"] != FORMAT_VERSION:
            raise ValueError(
                f"unsupported map format {meta['format_version']}")
        if abs(meta["voxel_size_m"] - m.voxel_size_m) > 1e-9:
            raise ValueError("voxel size mismatch")
        if sorted(m.channels.keys()) != meta["channels"]:
            raise ValueError("channel mismatch")
        bidx = data["block_indices"].astype(np.int64)
        chans = {name: data[f"channel__{name}"] for name in meta["channels"]}
    cfg = m.world_config
    if bidx.shape[0] > cfg.capacity:
        raise ValueError("map larger than pool capacity")
    cells = bidx - np.asarray(cfg.origin_block, np.int64)
    ok = np.all((cells >= 0) & (cells < np.asarray(cfg.dims)), axis=1)
    cells, bidx = cells[ok], bidx[ok]
    n = bidx.shape[0]
    slot_grid = np.full(cfg.dims, -1, np.int32)
    slot_grid[cells[:, 0], cells[:, 1], cells[:, 2]] = np.arange(n)
    bidx_full = np.zeros((cfg.capacity, 3), np.int32)
    bidx_full[:n] = bidx
    m.state = wg.WorldGridState.from_numpy(
        {"slot_grid": slot_grid, "block_index_of_slot": bidx_full,
         "alloc_count": n, "overflow_count": 0,
         "origin_block": cfg.origin_block,
         "free_stack": np.zeros(cfg.capacity, np.int32), "free_count": 0},
        m.device)
    resets = dict(_CHANNEL_RESET, **dict(m._reset_extra()))
    for name, host in chans.items():
        ch = m.channels[name]
        ch.fill_(resets.get(name, 0))
        ch[:n] = torch.from_numpy(np.ascontiguousarray(host[ok])).to(
            device=m.device, dtype=ch.dtype)
    m.dirty.zero_()
    m.dirty[:n] = True
    m.esdf_dirty.copy_(m.dirty)
    m.mesh_pending.zero_()
    m.removed_count.zero_()
    m._removed_read = 0
    m._mesh_clear_pending = []
    m._reset_host_tracking()
    m.mesh_layer.blocks.clear()
    return n
