"""MultiMapper: static (background) and dynamic (foreground) maps (port of
isaac_ros_nvblox_tpu/mapper/multi_mapper.py).

nvblox's MultiMapper owns a background mapper (TSDF or occupancy) and, in
the dynamic and human modes, a foreground occupancy mapper fed with the
masked depth:

  * human modes: the mask comes from a people-segmentation network,
    possibly seen from another camera (`T_CM_CD` and the mask camera),
    and loses its components under the size threshold (nvblox's exact
    8-connected filter, kernel mask_components);
  * dynamic mode: the mask comes from the freespace layer. Depth points
    inside high-confidence freespace are dynamic (kernel detect_dynamic);
    the static TSDF takes the other pixels, the dynamic occupancy mapper
    these, and the freespace state machine then advances (its
    neighbourhood check through kernel dilate_dense).

Both mappers are DeviceMappers on one device; a frame step makes no host
sync. The ground-plane estimator feeds the ESDF slice band, and the lazy
debug getters read the last frame's mask back only when called.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from isaac_ros_nvblox_tpu_torch.core import world_grid as wg
from isaac_ros_nvblox_tpu_torch.core.types import (Transform, device_ints,
                                                   recip32)
from isaac_ros_nvblox_tpu_torch.mapper import device_io
from isaac_ros_nvblox_tpu_torch.mapper import device_mapper as dm
from isaac_ros_nvblox_tpu_torch.mapper.params import (EsdfMode, MappingType,
                                                      MultiMapperParams,
                                                      ProjectiveLayerType,
                                                      projective_layer_type)
from isaac_ros_nvblox_tpu_torch.models.camera import (Camera,
                                                      sample_image_nearest)
from isaac_ros_nvblox_tpu_torch.models.lidar import Lidar
from isaac_ros_nvblox_tpu_torch.ops.backproject import back_project_depth
from isaac_ros_nvblox_tpu_torch.ops.detect_cuda import detect_dynamic
from isaac_ros_nvblox_tpu_torch.ops.ground_plane import (GroundPlaneEstimator,
                                                         Plane)
from isaac_ros_nvblox_tpu_torch.ops.masking import (
    mask_overlay, remove_small_connected_components_exact)
from isaac_ros_nvblox_tpu_torch.utils.timing import Timer, Timing, to_host


def _default_world(capacity: int) -> wg.WorldGridConfig:
    return wg.WorldGridConfig(dims=(128, 128, 32), capacity=capacity,
                              origin_block=(-64, -64, -8))


@torch.no_grad()
def reproject_mask(depth, mask, T_CM_CD, *, depth_camera: Camera,
                   mask_camera: Camera) -> torch.Tensor:
    """A mask seen from another camera, per depth pixel `u8[H, W]`: each
    depth pixel is back-projected, moved into the mask camera by `T_CM_CD`
    and samples the mask (nearest). Pixels without depth or projecting
    outside the mask image count as unmasked."""
    H, W = depth.shape
    dev = depth.device
    uu = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    vv = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    x = (uu - depth_camera.cx) * recip32(depth_camera.fx) * depth
    y = (vv - depth_camera.cy) * recip32(depth_camera.fy) * depth
    p = Transform.apply(T_CM_CD, torch.stack([x, y, depth], -1).reshape(-1, 3))
    uv, in_view = mask_camera.project(p)
    m = sample_image_nearest(mask.to(torch.float32), uv).reshape(H, W)
    ok = in_view.reshape(H, W) & (depth > 0)
    return torch.where(ok, m, torch.zeros_like(m)).to(torch.uint8)


def dilate_invalid_depth(depth, num_dilations: int) -> torch.Tensor:
    """Grow the invalid (<= 0) regions of a depth image by
    `num_dilations` 4-neighbour steps (do_depth_preprocessing), against
    mixed-depth edge artefacts. Edges wrap around, as in the reference."""
    d = depth
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    for _ in range(int(num_dilations)):
        invalid = d <= 0.0
        for axis, shift in ((0, 1), (0, -1), (1, 1), (1, -1)):
            invalid = invalid | (torch.roll(d, shift, axis) <= 0.0)
        d = torch.where(invalid, zero, d)
    return d


class MultiMapper:
    def __init__(self, params: Optional[MultiMapperParams] = None,
                 world: Optional[wg.WorldGridConfig] = None, device=None):
        """The static mapper (TSDF or occupancy by mapping type, with
        freespace in the dynamic mode) and, in the dynamic and human modes,
        the dynamic occupancy mapper: a quarter of the pool (at least 1024
        slots) and `dynamic_max_blocks_per_frame` blocks per frame."""
        self.params = params or MultiMapperParams()
        p = self.params
        static_layer = projective_layer_type(p.mapping_type)
        self.is_dynamic_mode = p.mapping_type in (
            MappingType.DYNAMIC, MappingType.HUMAN_WITH_STATIC_TSDF,
            MappingType.HUMAN_WITH_STATIC_OCCUPANCY)
        self.uses_freespace = p.mapping_type == MappingType.DYNAMIC
        # The foreground mapper's spans: `mapper/human/*` in the human
        # modes, `mapper/dynamic/*` in the dynamic mode.
        self._foreground = "dynamic" if self.uses_freespace else "human"
        world = world or _default_world(p.block_capacity)
        self.static_mapper = dm.DeviceMapper(
            p.voxel_size_m, params=p.static_mapper, world=world,
            projective_layer=static_layer,
            enable_color=static_layer == ProjectiveLayerType.TSDF,
            enable_freespace=self.uses_freespace,
            max_blocks_per_frame=p.max_blocks_per_frame, device=device,
            name="static_mapper")
        self.device = self.static_mapper.device
        self.dynamic_mapper: Optional[dm.DeviceMapper] = None
        if self.is_dynamic_mode:
            self.dynamic_mapper = dm.DeviceMapper(
                p.voxel_size_m, params=p.dynamic_mapper,
                world=wg.WorldGridConfig(
                    dims=world.dims,
                    capacity=max(p.block_capacity // 4, 1024),
                    origin_block=world.origin_block),
                projective_layer=ProjectiveLayerType.OCCUPANCY,
                max_blocks_per_frame=p.dynamic_max_blocks_per_frame,
                device=self.device, name="dynamic_mapper")
        self.default_lidar = Lidar.equal_vertical_fov(
            num_azimuth=1024, num_elevation=64,
            vertical_fov_rad=float(np.deg2rad(45.0)))
        self.ground_plane_estimator = GroundPlaneEstimator()
        # The last dynamic-mode frame, kept on the device for the lazy
        # debug getters.
        self._last_dynamic_mask_dev = None
        self._last_depth_dev = None
        self._last_T_L_C = None
        self._last_camera: Optional[Camera] = None

    # -------------------------------------------------------------- helpers
    def background_mapper(self) -> dm.DeviceMapper:
        return self.static_mapper

    def foreground_mapper(self) -> Optional[dm.DeviceMapper]:
        return self.dynamic_mapper

    def _depth(self, depth) -> torch.Tensor:
        """The depth image on the device, preprocessed: the frame's
        `mapper/depth/upload` span."""
        with Timer("mapper/depth/upload"):
            d = self.static_mapper._tensor(depth, torch.float32)
            sp = self.params.static_mapper
            if sp.do_depth_preprocessing:
                d = dilate_invalid_depth(
                    d, sp.depth_preprocessing_num_dilations)
        return d

    # ------------------------------------------------------------ integrate
    def integrate_depth(self, depth, T_L_C, camera: Camera, mask=None,
                        mask_camera: Optional[Camera] = None, T_CM_CD=None,
                        time_ms: float = 0.0) -> None:
        """Route a depth frame. Static modes integrate it whole. The human
        modes split it by `mask` (u8[H, W], > 0 = foreground; reprojected
        from `mask_camera` through `T_CM_CD` when given); the dynamic mode
        derives the mask from high-confidence freespace (kernel
        detect_dynamic) and then updates the freespace at `time_ms`. With
        `remove_small_connected_components` the mask first loses its
        8-connected components under the size threshold (kernel
        mask_components). The background goes to the static mapper, the
        foreground to the dynamic occupancy mapper. No host sync.

        Spans: `mapper/mask/reproject` (a given mask's upload and
        reprojection; counter `mapper/mask/frames` counts those frames),
        `mapper/mask/filter`, and the foreground mapper's blocks and
        fusion, `mapper/human/integrate` (`mapper/dynamic/integrate` in
        the dynamic mode)."""
        depth_t = self._depth(depth)
        sm = self.static_mapper
        if not self.is_dynamic_mode:
            sm.integrate_depth(depth_t, T_L_C, camera)
            return
        if self.uses_freespace and mask is None:
            mask_t = self.detect_dynamic(depth_t, T_L_C, camera)
        elif mask is None:
            mask_t = torch.zeros(depth_t.shape, dtype=torch.uint8,
                                 device=self.device)
        else:
            with Timer("mapper/mask/reproject"):
                mask_t = sm._tensor(mask, torch.uint8)
                if mask_camera is not None and T_CM_CD is not None:
                    mask_t = reproject_mask(
                        depth_t, mask_t, sm._tensor(T_CM_CD, torch.float32),
                        depth_camera=camera, mask_camera=mask_camera)
            Timing.add("mapper/mask/frames")
        sp = self.params.static_mapper
        if sp.remove_small_connected_components:
            with Timer("mapper/mask/filter"):
                mask_t = remove_small_connected_components_exact(
                    mask_t, sp.connected_mask_component_size_threshold)
        sm.integrate_depth(depth_t, T_L_C, camera, mask=mask_t, mask_mode=1)
        with Timer(f"mapper/{self._foreground}/integrate"):
            self.dynamic_mapper.integrate_depth(depth_t, T_L_C, camera,
                                                mask=mask_t, mask_mode=2)
        if self.uses_freespace:
            sm.update_freespace(time_ms, T_L_C, camera)
        self._last_dynamic_mask_dev = mask_t
        self._last_depth_dev = depth_t
        self._last_T_L_C = T_L_C
        self._last_camera = camera

    def integrate_depth_with_esdf2d(self, depth, T_L_C, camera: Camera,
                                    min_height_m: float,
                                    max_height_m: float) -> bool:
        """The online tick of the static TSDF mode: the depth frame
        (preprocessed as `integrate_depth` does) integrated, then the 2-D
        ESDF solved (`DeviceMapper.integrate_depth_with_esdf2d`), with no
        host sync. Returns False, having done nothing, in the dynamic and
        human modes or where the static mapper declines: the caller then
        falls back to integrate_depth() + update_esdf()."""
        if self.dynamic_mapper is not None:
            return False
        return self.static_mapper.integrate_depth_with_esdf2d(
            self._depth(depth), T_L_C, camera, min_height_m, max_height_m)

    def integrate_color(self, color, T_L_C, camera: Camera, mask=None,
                        depth=None) -> None:
        """Color into the static TSDF; masked (foreground) pixels are
        blacked out first. An occupancy static mapper ignores the frame."""
        sm = self.static_mapper
        if sm.projective_layer != ProjectiveLayerType.TSDF:
            return
        if mask is not None:
            color = sm._image(color)
            color = torch.where(sm._tensor(mask, torch.uint8)[..., None] > 0,
                                torch.zeros((), dtype=color.dtype,
                                            device=color.device), color)
        sm.integrate_color(color, T_L_C, camera, depth=depth)

    def integrate_pointcloud(self, points, T_L_S,
                             lidar: Optional[Lidar] = None, timestamps_s=None,
                             T_L_S_end=None, time_ms: float = 0.0) -> None:
        """3D lidar into the static mapper, with optional per-point motion
        compensation."""
        self.static_mapper.integrate_pointcloud(
            points, T_L_S, lidar or self.default_lidar,
            timestamps_s=timestamps_s, T_L_S_end=T_L_S_end)

    @torch.no_grad()
    def replay_frames_dynamic(self, depths, T_L_Cs, times_ms, camera: Camera,
                              region=None, slot_bucket: int = 0) -> None:
        """Replay N frames through the dynamic pipeline (the offline and
        benchmark loop; dynamic mode only), step for step as the
        reference's replay scan: detection (kernel detect_dynamic) ->
        masked static TSDF (background) -> masked dynamic occupancy
        (foreground) -> freespace update. No connected-component filter.

        `region=(origin_blocks, dims_blocks)` selects the freespace
        full-pool form (kernel dilate_dense) over that block region; by
        default the static mapper's tracked AABB when it is known, else the
        view-batch form. `slot_bucket` restricts that form to the pool
        prefix (check_slot_bucket() verifies it after the replay). The loop
        makes no host sync once the frames are on the device."""
        if not (self.uses_freespace and self.dynamic_mapper is not None):
            raise ValueError("replay_frames_dynamic needs the dynamic mode")
        sm, dmap = self.static_mapper, self.dynamic_mapper
        if (region is None and not sm._region_unknown
                and sm._aabb_lo is not None):
            # A replay's region is fixed: no bucket slack.
            region = sm.esdf_region(margin_blocks=0, mult=1)
        if region is not None:
            origin_b = device_ints(region[0], torch.int32, self.device)
            dims_b = tuple(int(d) for d in region[1])
        else:
            origin_b, dims_b = None, None
        depths = sm._tensor(depths, torch.float32)
        T_L_Cs = sm._tensor(T_L_Cs, torch.float32)
        times = sm._tensor(times_ms, torch.float32)
        sp, dp = sm.params, dmap.params
        maxd = float(sp.projective.max_integration_distance_m)
        ch = sm.channels
        last_ms = sm._freespace_last_update_ms
        for k in range(depths.shape[0]):
            depth, T = depths[k], T_L_Cs[k]
            mask = detect_dynamic(
                sm.state, ch["freespace_high_confidence"], depth, T,
                camera=camera, voxel_size_m=sm.voxel_size_m, max_depth_m=maxd,
                subsample=int(self.params.dynamic_detection_subsample))
            sm.state = dm._integrate_frame(
                sm.state, ch["tsdf_distance"], ch["tsdf_weight"], sm.dirty,
                sm.esdf_dirty, depth, T, mask, camera=camera,
                voxel_size_m=sm.voxel_size_m, params=sp.projective,
                max_blocks=sm.max_blocks_per_frame, mask_mode=1)
            dmap.state = dm._integrate_occupancy_frame(
                dmap.state, dmap.channels["occupancy_log_odds"],
                dmap.channels["occupancy_observed"], dmap.dirty,
                dmap.esdf_dirty, depth, T, mask, camera=camera,
                voxel_size_m=dmap.voxel_size_m, params=dp.occupancy,
                max_blocks=dmap.max_blocks_per_frame, mask_mode=2)
            dm._freespace_fused(
                ch["freespace_consecutive_ms"],
                ch["freespace_last_occupied_ms"],
                ch["freespace_high_confidence"], sm.state,
                ch["tsdf_distance"], ch["tsdf_weight"], T, times[k], last_ms,
                origin_b, camera=camera, voxel_size_m=sm.voxel_size_m,
                params=sp.freespace, view_distance_m=maxd,
                max_blocks=sm.max_blocks_per_frame, dims_b=dims_b,
                slot_bucket=int(slot_bucket))
            last_ms = times[k]
        sm._freespace_last_update_ms = last_ms
        sm._region_unknown = True
        dmap._region_unknown = True
        if slot_bucket:
            prev = sm._slot_bucket_pending
            sm._slot_bucket_pending = (min(prev, slot_bucket) if prev
                                       else slot_bucket)

    # -------------------------------------------------------------- dynamic
    def detect_dynamic(self, depth, T_L_C, camera: Camera) -> torch.Tensor:
        """The dynamic-pixel mask `u8[H, W]` of a depth frame from the
        static map's high-confidence freespace (kernel detect_dynamic on
        the card; no host sync). All zero without freespace channels."""
        m = self.static_mapper
        depth_t = m._tensor(depth, torch.float32)
        if "freespace_high_confidence" not in m.channels:
            return torch.zeros(depth_t.shape, dtype=torch.uint8,
                               device=self.device)
        return detect_dynamic(
            m.state, m.channels["freespace_high_confidence"], depth_t,
            m._tensor(T_L_C, torch.float32), camera=camera,
            voxel_size_m=m.voxel_size_m,
            max_depth_m=float(m.params.projective.max_integration_distance_m),
            subsample=int(self.params.dynamic_detection_subsample))

    # Host-facing debug getters of the last frame: each reads back only
    # when it is called.
    @property
    def last_dynamic_mask(self) -> Optional[np.ndarray]:
        if self._last_dynamic_mask_dev is None:
            return None
        return to_host(self._last_dynamic_mask_dev)

    @property
    def last_depth_foreground(self) -> Optional[np.ndarray]:
        if self._last_dynamic_mask_dev is None:
            return None
        d = self._last_depth_dev
        return to_host(torch.where(self._last_dynamic_mask_dev > 0, d,
                                   torch.zeros_like(d)))

    @property
    def last_mask_overlay(self) -> Optional[np.ndarray]:
        if self._last_dynamic_mask_dev is None:
            return None
        return to_host(mask_overlay(
            torch.clamp(self._last_depth_dev * 50.0, 0, 255),
            self._last_dynamic_mask_dev))

    @property
    def last_dynamic_pointcloud(self) -> Optional[np.ndarray]:
        """The last frame's dynamic pixels back-projected into the layer
        frame, `f32[K, 3]`."""
        if self._last_dynamic_mask_dev is None or self._last_T_L_C is None:
            return None
        pts, valid = back_project_depth(self._last_depth_dev,
                                        camera=self._last_camera)
        T = self.static_mapper._tensor(self._last_T_L_C, torch.float32)
        pts = Transform.apply(T, pts)
        keep = (self._last_dynamic_mask_dev > 0).reshape(-1) & valid
        return to_host(pts[keep])

    # --------------------------------------------------------------- update
    def update_esdf(self) -> None:
        """The ESDF of both mappers as `esdf_mode` says: in `K2D` the
        planar field of the height band `esdf_2d_band()`
        (`DeviceMapper.update_esdf_2d`), in `K3D` the 3-D field."""
        for m in self._mappers().values():
            if self.params.esdf_mode == EsdfMode.K2D:
                m.update_esdf_2d(*self.esdf_2d_band())
            else:
                m.update_esdf()

    def esdf_2d_band(self) -> Tuple[float, float]:
        """The 2-D ESDF's height band: [esdf_slice_min_height,
        esdf_slice_max_height], or relative to the estimated ground plane
        once there is one (slice_height_above_plane_m and
        slice_height_thickness_m)."""
        sp = self.params.static_mapper.esdf_slice
        plane = self.ground_plane_estimator.last_plane
        if plane is not None:
            lo = plane.c + sp.slice_height_above_plane_m
            return lo, lo + sp.slice_height_thickness_m
        return sp.esdf_slice_min_height, sp.esdf_slice_max_height

    def update_ground_plane(self) -> Optional[Plane]:
        return self.ground_plane_estimator.estimate_device(self.static_mapper)

    def update_mesh(self, max_blocks: int = 2048):
        """The static mapper's dirty blocks into its host mesh layer
        (`device_io.update_mesh_layer`); returns the re-serialized keys."""
        return device_io.update_mesh_layer(self.static_mapper,
                                           max_blocks=max_blocks)

    def decay_static(self) -> None:
        """Static-layer decay: an occupancy layer always, a TSDF in the
        dynamic mode."""
        if self.static_mapper.projective_layer == ProjectiveLayerType.TSDF:
            if self.uses_freespace:
                self.static_mapper.decay()
        else:
            self.static_mapper.decay()

    def decay_dynamic(self) -> None:
        """Decay of the dynamic occupancy layer."""
        if self.dynamic_mapper is not None:
            with Timer(f"mapper/{self._foreground}/decay"):
                self.dynamic_mapper.decay()

    def decay(self) -> None:
        self.decay_static()
        self.decay_dynamic()

    # ---------------------------------------------------------------- state
    def _mappers(self):
        out = {"static_mapper": self.static_mapper}
        if self.dynamic_mapper is not None:
            out["dynamic_mapper"] = self.dynamic_mapper
        return out

    def state_arrays(self):
        """Both mappers' `state_arrays`, each key prefixed with the
        mapper's name (the reference's DeviceMapper names):
        `static_mapper/<key>`, `dynamic_mapper/<key>`."""
        return {f"{name}/{k}": v for name, m in self._mappers().items()
                for k, v in m.state_arrays().items()}

    def load_state_arrays(self, arrays) -> None:
        """Load both mappers from arrays keyed as `state_arrays` gives them
        (a mapper without keys of its own is left as it is)."""
        for name, m in self._mappers().items():
            pre = f"{name}/"
            own = {k[len(pre):]: v for k, v in arrays.items()
                   if k.startswith(pre)}
            if own:
                m.load_state_arrays(own)
