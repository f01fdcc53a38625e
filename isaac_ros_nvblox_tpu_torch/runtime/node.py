"""NvbloxNode: the online mapping runtime (port of
isaac_ros_nvblox_tpu/runtime/node.py).

Reference: `NvbloxNode` (nvblox_ros/src/lib/nvblox_node.cpp) — thread-safe
input queues fed by sensor callbacks, a periodic `tick()` that drains queues
(pose-gated), per-stream Hz rate limits, ESDF/mesh update cadences, layer
publishing, and services marshalled onto the tick thread.

Same architecture minus ROS: callbacks push into DropOldestQueues; `tick()`
is called by the host loop (or a timer thread); outputs go to a MessageBus.
All device work happens on the tick thread, through the device-resident
MultiMapper (on `cuda` unless the caller passes `device="cpu"`). Numpy
images and poses go to the card inside the mapper; a depth tick that
publishes nothing makes no device-to-host read. Every message on the bus
holds numpy arrays, never device tensors, so subscribers may run on any
thread. The voxel-layer publish gathers the selected blocks' rows on the
device and copies only the voxels it publishes.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from isaac_ros_nvblox_tpu_torch.core.types import voxel_centers_for_blocks
from isaac_ros_nvblox_tpu_torch.io.occupancy_grid_io import \
    save_occupancy_grid
from isaac_ros_nvblox_tpu_torch.io.ply import (write_mesh_ply,
                                               write_voxel_layer_ply_device)
from isaac_ros_nvblox_tpu_torch.mapper import device_io
from isaac_ros_nvblox_tpu_torch.mapper.multi_mapper import MultiMapper
from isaac_ros_nvblox_tpu_torch.mapper.params import (EsdfMode,
                                                      MultiMapperParams)
from isaac_ros_nvblox_tpu_torch.models.camera import Camera
from isaac_ros_nvblox_tpu_torch.models.lidar import Lidar
from isaac_ros_nvblox_tpu_torch.ops.backproject import (back_project_depth,
                                                        transform_pointcloud)
from isaac_ros_nvblox_tpu_torch.ops.esdf_slicer import (
    combine_distance_images, occupancy_grid_from_slice)
from isaac_ros_nvblox_tpu_torch.ops.image_preproc import undo_srgb_gamma
from isaac_ros_nvblox_tpu_torch.ops.view import WorkspaceBoundsType
from isaac_ros_nvblox_tpu_torch.runtime.layer_streaming import (
    LayerStreamer, StreamingParams)
from isaac_ros_nvblox_tpu_torch.runtime.msgs import (
    DistanceMapSlice, EsdfAndGradientsResponse, Header, Index3D,
    MeshBlockMsg, MeshMsg, MessageBus, VoxelBlockLayerMsg, VoxelBlockMsg)
from isaac_ros_nvblox_tpu_torch.runtime.queues import (DropOldestQueue,
                                                       ServiceRequestQueue)
from isaac_ros_nvblox_tpu_torch.runtime.transformer import Transformer
from isaac_ros_nvblox_tpu_torch.runtime.visualization import (aabb_marker,
                                                              plane_marker)
from isaac_ros_nvblox_tpu_torch.utils.timing import (Delays, Rates, Timer,
                                                     Timing, to_host)


@dataclasses.dataclass
class NodeParams:
    """Node-level parameters (parity: the full NvbloxNodeParams surface,
    node_params.hpp:37-414; names and defaults match the reference's
    declarations). Every field is wired to behavior — none parse-only."""
    # -- frames ------------------------------------------------------------
    global_frame: str = "odom"
    pose_frame: str = "base_link"
    # -- input selection / queueing (node_params.hpp:60-78) -----------------
    use_depth: bool = True
    use_color: bool = True
    use_segmentation: bool = False
    use_lidar: bool = True
    num_cameras: int = 1
    maximum_input_queue_length: int = 10
    # -- rates (node_params.hpp:212-258) ------------------------------------
    tick_period_ms: float = 10.0
    integrate_depth_rate_hz: float = 40.0
    integrate_color_rate_hz: float = 5.0
    integrate_lidar_rate_hz: float = 40.0
    update_mesh_rate_hz: float = 5.0
    update_esdf_rate_hz: float = 10.0
    publish_layer_rate_hz: float = 10.0
    publish_debug_vis_rate_hz: float = 2.0
    decay_tsdf_rate_hz: float = 5.0
    decay_dynamic_occupancy_rate_hz: float = 10.0
    clear_map_outside_radius_rate_hz: float = 1.0
    # -- console statistics (node_params.hpp:253-270) -----------------------
    print_statistics_on_console_period_ms: int = 10000
    print_timings_to_console: bool = False
    print_rates_to_console: bool = False
    print_delays_to_console: bool = False
    print_queue_drops_to_console: bool = False
    # -- lidar intrinsics (node_params.hpp:113-151) -------------------------
    lidar_width: int = 1800
    lidar_height: int = 16
    lidar_vertical_fov_rad: float = float(np.radians(30.0))
    lidar_min_valid_range_m: float = 0.1
    use_non_equal_vertical_fov_lidar_params: bool = False
    min_angle_below_zero_elevation_rad: float = float(np.radians(20.0))
    max_angle_above_zero_elevation_rad: float = float(np.radians(15.0))
    use_lidar_motion_compensation: bool = True
    pointcloud2_timestamps_are_relative: bool = True
    # -- ESDF slice outputs --------------------------------------------------
    publish_esdf_distance_slice: bool = True
    esdf_slice_height: float = 0.3
    esdf_2d_min_height: float = 0.1
    esdf_2d_max_height: float = 0.3
    distance_map_unknown_value_optimistic: float = 1000.0
    distance_map_unknown_value_pessimistic: float = -1000.0
    output_pessimistic_distance_map: bool = True
    free_threshold_m: float = 0.2
    esdf_and_gradients_unobserved_value: float = -1000.0
    # -- map maintenance -----------------------------------------------------
    map_clearing_radius_m: float = -1.0  # <0 disables
    map_clearing_frame_id: str = "base_link"
    after_shutdown_map_save_path: Optional[str] = None
    # -- layer streaming / visualization (node_params.hpp:182-211) -----------
    layer_streamer_bandwidth_limit_mbps: float = 30.0
    layer_visualization_min_tsdf_weight: float = 0.1
    layer_visualization_exclusion_height_m: float = 2.0
    layer_visualization_exclusion_radius_m: float = 5.0
    layer_visualization_undo_gamma_correction: bool = False
    max_back_projection_distance: float = 5.0
    back_projection_subsampling: int = 1
    # -- debug-vis markers (node_params.hpp:162-193) --------------------------
    esdf_slice_bounds_visualization_attachment_frame_id: str = "base_link"
    esdf_slice_bounds_visualization_side_length: float = 10.0
    workspace_height_bounds_visualization_attachment_frame_id: str = \
        "base_link"
    workspace_height_bounds_visualization_side_length: float = 10.0
    ground_plane_visualization_attachment_frame_id: str = "base_link"
    ground_plane_visualization_side_length: float = 10.0
    # Ground-plane estimation feeding slice-above-plane
    # (nvblox_node.cpp:1455-1474).
    use_ground_plane_estimator: bool = False
    # -- legacy aliases (kept for config compatibility) -----------------------
    esdf_2d: bool = True          # publish_esdf_distance_slice pre-alias
    decay_rate_hz: Optional[float] = None  # overrides decay_tsdf_rate_hz


@dataclasses.dataclass
class _DepthItem:
    depth: np.ndarray
    camera: Camera
    frame_id: str
    stamp_s: float
    mask: Optional[np.ndarray] = None
    mask_camera: Optional[Camera] = None
    T_CM_CD: Optional[np.ndarray] = None


@dataclasses.dataclass
class _ColorItem:
    color: np.ndarray
    camera: Camera
    frame_id: str
    stamp_s: float


class RateGate:
    """Per-stream Hz limiter (parity: shouldProcess, nvblox_node.cpp:571-580)."""

    def __init__(self):
        self._last: Dict[str, float] = {}

    def should_process(self, name: str, rate_hz: float, now_s: float) -> bool:
        if rate_hz <= 0:
            return False
        last = self._last.get(name)
        if last is not None and (now_s - last) < 1.0 / rate_hz - 1e-9:
            return False
        self._last[name] = now_s
        return True


class NvbloxNode:
    def __init__(self, params: Optional[NodeParams] = None,
                 mapper_params: Optional[MultiMapperParams] = None,
                 bus: Optional[MessageBus] = None,
                 world=None,
                 clock=time.monotonic,
                 device="cuda"):
        """The node and its MultiMapper on `device` (`cuda` by default,
        which raises without a card; the tests pass `device="cpu"`)."""
        self.params = params or NodeParams()
        mapper_params = mapper_params or MultiMapperParams()
        # The node-level 2D slice band configures the mapper's ESDF slice
        # params (parity: esdf_2d_min/max_height flowing into the esdf
        # integrator slice bounds, mapper_initialization.cpp:255-260).
        sp = dataclasses.replace(
            mapper_params.static_mapper.esdf_slice,
            esdf_slice_min_height=self.params.esdf_2d_min_height,
            esdf_slice_max_height=self.params.esdf_2d_max_height,
            esdf_slice_height=self.params.esdf_slice_height)
        mapper_params = dataclasses.replace(
            mapper_params,
            static_mapper=dataclasses.replace(mapper_params.static_mapper,
                                              esdf_slice=sp))
        self.multi_mapper = MultiMapper(mapper_params, world=world,
                                        device=device)
        self.device = self.multi_mapper.device
        # Node-level lidar intrinsics (parity: node_params.hpp:113-151 →
        # nvblox_node.cpp's Lidar construction).
        p = self.params
        if p.use_non_equal_vertical_fov_lidar_params:
            self.lidar = Lidar(
                p.lidar_width, p.lidar_height,
                p.lidar_min_valid_range_m, 100.0,
                p.min_angle_below_zero_elevation_rad,
                p.max_angle_above_zero_elevation_rad)
        else:
            self.lidar = Lidar.equal_vertical_fov(
                p.lidar_width, p.lidar_height, p.lidar_vertical_fov_rad,
                min_range_m=p.lidar_min_valid_range_m)
        if p.decay_rate_hz is not None:  # legacy alias
            p.decay_tsdf_rate_hz = p.decay_rate_hz
            p.decay_dynamic_occupancy_rate_hz = p.decay_rate_hz
        self.transformer = Transformer(global_frame=self.params.global_frame)
        self.bus = bus or MessageBus()
        self.clock = clock
        self._gate = RateGate()
        q = self.params.maximum_input_queue_length
        self.depth_queue: DropOldestQueue = DropOldestQueue("depth", q)
        self.color_queue: DropOldestQueue = DropOldestQueue("color", q)
        self.pointcloud_queue: DropOldestQueue = DropOldestQueue("pointcloud", q)
        self.service_queue = ServiceRequestQueue()
        # Per-subscriber mesh state: new subscribers get a full-map resend
        # (parity: layer_publishing.cpp:545-584).
        self._mesh_sent_to: Dict[int, Set[Tuple[int, int, int]]] = {}
        self._mesh_streamer = None  # created lazily (needs voxel size)
        # Per-subscriber catch-up streamers (budgeted full-map resend).
        self._mesh_resend_streamers: Dict[int, object] = {}
        self._layer_streamers: Dict[str, object] = {}
        self._layer_sent: Dict[str, Set[Tuple[int, int, int]]] = {}
        # The device removal log is consume-once but has TWO consumers (the
        # mesh-layer maintenance and the voxel-layer publisher); whichever
        # drains it forwards the keys to the other through these sets.
        self._pending_layer_removals: Set[Tuple[int, int, int]] = set()
        self._pending_mesh_removals: Set[Tuple[int, int, int]] = set()
        # Re-meshed keys accumulate here so the voxel-layer publisher never
        # loses updates when the mesh runs more often than layer publishing.
        self._pending_layer_updates: Set[Tuple[int, int, int]] = set()
        self._camera_frames: List[str] = []
        self._last_stats_print = -float("inf")
        self._bp_counter = 0
        self.tick_count = 0
        # Bytes the last publish of each kind copied from the device:
        # "slice", "mesh", "layers", "back_projected_depth".
        self.last_host_bytes: Dict[str, int] = {}

    # ------------------------------------------------------------- callbacks
    def add_depth_image(self, depth: np.ndarray, camera: Camera,
                        frame_id: str, stamp_s: float,
                        mask: Optional[np.ndarray] = None,
                        mask_camera: Optional[Camera] = None,
                        T_CM_CD: Optional[np.ndarray] = None) -> None:
        Rates.tick("node/depth_image_callback")
        Delays.record("node/depth_image", self.clock() - stamp_s)
        self.depth_queue.push(_DepthItem(depth, camera, frame_id, stamp_s,
                                         mask, mask_camera, T_CM_CD))

    def add_color_image(self, color: np.ndarray, camera: Camera,
                        frame_id: str, stamp_s: float) -> None:
        Rates.tick("node/color_image_callback")
        self.color_queue.push(_ColorItem(color, camera, frame_id, stamp_s))

    def add_pointcloud(self, points: np.ndarray, frame_id: str,
                       stamp_s: float,
                       timestamps_s: Optional[np.ndarray] = None) -> None:
        Rates.tick("node/pointcloud_callback")
        self.pointcloud_queue.push((points, frame_id, stamp_s, timestamps_s))

    def add_pose(self, frame_id: str, stamp_s: float, T_G_F) -> None:
        self.transformer.add_pose(frame_id, stamp_s, T_G_F)

    # ----------------------------------------------------------------- tick
    def tick(self) -> None:
        """One scheduler tick (parity: NvbloxNode::tick, nvblox_node.cpp:582-678)."""
        now = self.clock()
        with Timer("node/tick"):
            Rates.tick("node/tick")
            self.service_queue.process_all()
            # The ESDF gate is evaluated BEFORE the depth queue so an
            # ESDF-cadence tick can fuse the solve into the integration
            # dispatch (one program instead of two through the relay;
            # see DeviceMapper.integrate_depth_with_esdf2d).
            esdf_due = self._gate.should_process(
                "esdf", self.params.update_esdf_rate_hz, now)
            self._esdf_fused_done = False
            self._process_depth_queue(now, esdf_due=esdf_due)
            self._process_color_queue(now)
            self._process_pointcloud_queue(now)
            if esdf_due:
                self._process_esdf()
            if self._gate.should_process(
                    "mesh", self.params.update_mesh_rate_hz, now):
                self._process_mesh()
            if self._gate.should_process(
                    "decay_tsdf", self.params.decay_tsdf_rate_hz, now):
                self.multi_mapper.decay_static()
            if self._gate.should_process(
                    "decay_dynamic",
                    self.params.decay_dynamic_occupancy_rate_hz, now):
                self.multi_mapper.decay_dynamic()
            if self._gate.should_process(
                    "layers", self.params.publish_layer_rate_hz, now):
                self._publish_voxel_layers()
            if self._gate.should_process(
                    "debug_vis", self.params.publish_debug_vis_rate_hz, now):
                self._publish_debug_visualizations(now)
            if self.params.map_clearing_radius_m > 0:
                self._clear_map_outside_radius(now)
            self._maybe_print_statistics(now)
        self.tick_count += 1

    # -------------------------------------------------------------- process
    def _pose_ready(self, item) -> bool:
        frame, stamp = item.frame_id, item.stamp_s
        return self.transformer.can_transform(frame, stamp)

    def _process_depth_queue(self, now: float, esdf_due: bool = False
                             ) -> None:
        if not self.params.use_depth:
            return
        items = self.depth_queue.extract_ready(self._pose_ready)
        for item in items:
            # num_cameras: only the first N distinct camera streams are
            # integrated (parity: per-camera subscriber count,
            # node_params.hpp:74-77).
            if item.frame_id not in self._camera_frames:
                if len(self._camera_frames) >= self.params.num_cameras:
                    continue
                self._camera_frames.append(item.frame_id)
            if not self._gate.should_process(
                    f"depth/{item.frame_id}",
                    self.params.integrate_depth_rate_hz, now):
                continue
            T = self.transformer.lookup_transform_to_global_frame(
                item.frame_id, item.stamp_s)
            # use_segmentation gates the masked-split path
            # (node_params.hpp:67-69).
            mask = item.mask if self.params.use_segmentation else None
            # ESDF-cadence tick: fuse the 2D solve into this frame's
            # integration dispatch when the configuration allows (2D mode,
            # static mapping, no mask, ground-plane band not in play —
            # that path re-estimates the plane first).
            fused = False
            if (esdf_due and not self._esdf_fused_done and mask is None
                    and self.params.esdf_2d
                    and self.multi_mapper.params.esdf_mode == EsdfMode.K2D
                    and not self.params.use_ground_plane_estimator):
                lo, hi = self.multi_mapper.esdf_2d_band()
                with Timer("node/depth/integrate"):
                    fused = self.multi_mapper.integrate_depth_with_esdf2d(
                        item.depth, T, item.camera, lo, hi)
                if fused:
                    # _process_esdf still runs this tick (slice publishing
                    # + its Rates tick); its update_esdf() early-outs on
                    # the cleared 2D dirty window.
                    self._esdf_fused_done = True
                    Rates.tick("node/depth")
                    self._maybe_publish_back_projection(item, T, now)
                    continue
            with Timer("node/depth/integrate"):
                self.multi_mapper.integrate_depth(
                    item.depth, T, item.camera, mask=mask,
                    mask_camera=item.mask_camera if mask is not None else None,
                    T_CM_CD=item.T_CM_CD if mask is not None else None,
                    time_ms=item.stamp_s * 1e3)
            Rates.tick("node/depth")
            self._maybe_publish_back_projection(item, T, now)

    def _process_color_queue(self, now: float) -> None:
        if not self.params.use_color:
            return
        items = self.color_queue.extract_ready(self._pose_ready)
        for item in items:
            if not self._gate.should_process(
                    f"color/{item.frame_id}",
                    self.params.integrate_color_rate_hz, now):
                continue
            T = self.transformer.lookup_transform_to_global_frame(
                item.frame_id, item.stamp_s)
            with Timer("node/color/integrate"):
                self.multi_mapper.integrate_color(item.color, T, item.camera)
            Rates.tick("node/color")

    def _process_pointcloud_queue(self, now: float) -> None:
        if not self.params.use_lidar:
            return
        items = self.pointcloud_queue.extract_ready(
            lambda it: self.transformer.can_transform(it[1], it[2]))
        for points, frame_id, stamp_s, timestamps in items:
            if not self._gate.should_process(
                    f"lidar/{frame_id}",
                    self.params.integrate_lidar_rate_hz, now):
                continue
            T = self.transformer.lookup_transform_to_global_frame(
                frame_id, stamp_s)
            # Lidar motion compensation: scan duration = max per-point
            # relative timestamp; end pose interpolated from the pose
            # queue (parity: nvblox_node.cpp:1339-1384,
            # pointcloud_conversions.cu:345-378). PointCloud2 stamps may be
            # absolute (pointcloud2_timestamps_are_relative=false).
            T_end = None
            if (timestamps is not None
                    and not self.params.pointcloud2_timestamps_are_relative):
                timestamps = np.asarray(timestamps) - stamp_s
            if timestamps is not None \
                    and self.params.use_lidar_motion_compensation:
                scan_dur = float(np.max(timestamps))
                if scan_dur > 0 and self.transformer.can_transform(
                        frame_id, stamp_s + scan_dur):
                    T_end = self.transformer.lookup_transform_to_global_frame(
                        frame_id, stamp_s + scan_dur)
            with Timer("node/lidar/integrate"):
                self.multi_mapper.integrate_pointcloud(
                    points, T, lidar=self.lidar,
                    timestamps_s=timestamps if T_end is not None else None,
                    T_L_S_end=T_end, time_ms=stamp_s * 1e3)
            Rates.tick("node/lidar")

    def _maybe_publish_back_projection(self, item, T, now: float) -> None:
        """Back-projected-depth debug output with subsampling (parity:
        publishBackProjectedDepth, nvblox_node.cpp:1128-1184;
        back_projection_subsampling + max_back_projection_distance,
        node_params.hpp:194-206)."""
        if self.bus.num_subscribers("~/back_projected_depth") == 0:
            return
        sub = max(1, int(self.params.back_projection_subsampling))
        if (self._bp_counter % sub) != 0:
            self._bp_counter += 1
            return
        self._bp_counter += 1
        sm = self.multi_mapper.static_mapper
        pts, valid = back_project_depth(
            sm._tensor(item.depth, torch.float32), camera=item.camera,
            max_depth_m=self.params.max_back_projection_distance)
        pts_g = transform_pointcloud(pts, sm._tensor(T, torch.float32))
        pts_g = to_host(pts_g[valid])
        self.last_host_bytes["back_projected_depth"] = pts_g.nbytes
        self.bus.publish("~/back_projected_depth",
                         (Header(stamp_s=item.stamp_s,
                                 frame_id=self.params.global_frame), pts_g))

    def _publish_debug_visualizations(self, now: float) -> None:
        """Debug markers: ESDF slice bounds, workspace height bounds, ground
        plane (parity: publishDebugVisualizations markers,
        nvblox_node.cpp:1455-1513; the *_visualization_* params)."""
        p = self.params
        if self.bus.num_subscribers("~/esdf_slice_bounds"):
            T = self.transformer.lookup_transform_to_global_frame(
                p.esdf_slice_bounds_visualization_attachment_frame_id, now)
            if T is not None:
                cx, cy = float(T[0, 3]), float(T[1, 3])
                s = p.esdf_slice_bounds_visualization_side_length / 2.0
                self.bus.publish("~/esdf_slice_bounds", aabb_marker(
                    (cx - s, cy - s, p.esdf_2d_min_height),
                    (cx + s, cy + s, p.esdf_2d_max_height),
                    ns="esdf_slice_bounds", frame_id=p.global_frame,
                    stamp_s=now))
        if self.bus.num_subscribers("~/workspace_height_bounds"):
            vp = self.multi_mapper.params.static_mapper.view
            if vp.workspace_bounds_type != WorkspaceBoundsType.UNBOUNDED:
                T = self.transformer.lookup_transform_to_global_frame(
                    p.workspace_height_bounds_visualization_attachment_frame_id,
                    now)
                if T is not None:
                    cx, cy = float(T[0, 3]), float(T[1, 3])
                    s = p.workspace_height_bounds_visualization_side_length / 2
                    self.bus.publish(
                        "~/workspace_height_bounds", aabb_marker(
                            (cx - s, cy - s,
                             vp.workspace_bounds_min_corner_m[2]),
                            (cx + s, cy + s,
                             vp.workspace_bounds_max_corner_m[2]),
                            ns="workspace_height_bounds",
                            frame_id=p.global_frame, stamp_s=now))
        if self.bus.num_subscribers("~/ground_plane_vis"):
            plane = self.multi_mapper.ground_plane_estimator.last_plane
            if plane is not None:
                T = self.transformer.lookup_transform_to_global_frame(
                    p.ground_plane_visualization_attachment_frame_id, now)
                if T is not None:
                    self.bus.publish("~/ground_plane_vis", plane_marker(
                        plane, (float(T[0, 3]), float(T[1, 3])),
                        size_m=p.ground_plane_visualization_side_length,
                        frame_id=p.global_frame, stamp_s=now))

    def _maybe_print_statistics(self, now: float) -> None:
        """Periodic console statistics (parity: printStatistics +
        print_*_to_console params, nvblox_node.cpp tick statistics)."""
        p = self.params
        if not (p.print_timings_to_console or p.print_rates_to_console
                or p.print_delays_to_console
                or p.print_queue_drops_to_console):
            return
        period_s = p.print_statistics_on_console_period_ms / 1e3
        if now - self._last_stats_print < period_s:
            return
        self._last_stats_print = now
        if p.print_timings_to_console:
            print(Timing.to_string())
        if p.print_rates_to_console:
            print(Rates.to_string())
        if p.print_delays_to_console:
            print(Delays.to_string())
        if p.print_queue_drops_to_console:
            for q in (self.depth_queue, self.color_queue,
                      self.pointcloud_queue):
                print(f"queue {q.name}: dropped={q.dropped_count}")

    def _process_esdf(self) -> None:
        if self.params.use_ground_plane_estimator:
            with Timer("node/ground_plane"):
                plane = self.multi_mapper.update_ground_plane()
            if plane is not None:
                self.bus.publish("~/ground_plane",
                                 (plane.a, plane.b, plane.c))
        with Timer("node/esdf/update"):
            self.multi_mapper.update_esdf()
        Rates.tick("node/esdf")
        if not (self.params.esdf_2d and self.params.publish_esdf_distance_slice):
            return
        if self.bus.num_subscribers("~/static_map_slice") == 0 \
                and self.bus.num_subscribers("~/combined_map_slice") == 0 \
                and self.bus.num_subscribers("~/map_slice_occupancy_grid") == 0:
            return
        with Timer("node/esdf/slice"):
            self._publish_slices()

    def _slice_one(self, mapper, spec=None):
        p = self.params
        unknown = p.distance_map_unknown_value_optimistic
        max_d = mapper.params.esdf.max_esdf_distance_m
        if self.multi_mapper.params.esdf_mode == EsdfMode.K2D:
            return device_io.slice_esdf_2d_device(
                mapper, max_distance_m=max_d, unknown_value=unknown,
                spec=spec)
        return device_io.slice_esdf_device(
            mapper, slice_height_m=p.esdf_slice_height,
            max_distance_m=max_d, unknown_value=unknown, spec=spec)

    def _publish_slices(self) -> None:
        p = self.params
        unknown = p.distance_map_unknown_value_optimistic
        res = self._slice_one(self.multi_mapper.static_mapper)
        if res is None:
            return
        spec, img = res
        slices = [img]
        dyn = self.multi_mapper.dynamic_mapper
        if dyn is not None:
            dres = self._slice_one(dyn, spec=spec)
            if dres is not None:
                slices.append(dres[1])
        self.last_host_bytes["slice"] = sum(x.nbytes for x in slices)
        header = Header(stamp_s=self.clock(), frame_id=p.global_frame)
        msg = DistanceMapSlice(
            header=header, origin_x_m=spec.origin_x_m,
            origin_y_m=spec.origin_y_m, resolution_m=spec.voxel_size_m,
            width=spec.width, height=spec.height, unknown_value=unknown,
            data=img)
        self.bus.publish("~/static_map_slice", msg)
        if len(slices) > 1 and slices[1].shape == img.shape:
            combined = combine_distance_images(slices, unknown)
            self.bus.publish("~/combined_map_slice", dataclasses.replace(
                msg, data=combined))
        else:
            combined = img
        if self.bus.num_subscribers("~/map_slice_occupancy_grid"):
            grid = occupancy_grid_from_slice(
                combined, p.free_threshold_m, unknown)
            self.bus.publish("~/map_slice_occupancy_grid", (spec, grid))
        # Pessimistic map: unknown cells carry the pessimistic (obstacle)
        # value instead of the optimistic one (parity:
        # output_pessimistic_distance_map +
        # distance_map_unknown_value_pessimistic, node_params.hpp:104-112).
        if p.output_pessimistic_distance_map and \
                self.bus.num_subscribers("~/pessimistic_static_map_slice"):
            pess = np.where(img == np.float32(unknown),
                            np.float32(p.distance_map_unknown_value_pessimistic),
                            img)
            self.bus.publish(
                "~/pessimistic_static_map_slice",
                dataclasses.replace(
                    msg, data=pess,
                    unknown_value=p.distance_map_unknown_value_pessimistic))

    def _process_mesh(self) -> None:
        subs = self.bus.subscriber_ids("~/mesh")
        if not subs:
            return
        with Timer("node/mesh/update"):
            self.multi_mapper.update_mesh()
        Rates.tick("node/mesh")
        with Timer("node/mesh/publish"):
            self._publish_mesh(subs)

    def _publish_mesh(self, subs) -> None:
        """The mesh layer to each `~/mesh` subscriber in `subs`, after an
        update: the removals, the layer streamer's budgeted selection and
        each late subscriber's catch-up."""
        static_mapper = self.multi_mapper.static_mapper
        self.last_host_bytes["mesh"] = static_mapper.last_mesh_host_bytes
        mesh_layer = static_mapper.mesh_layer
        # Forward removals this update drained to the voxel-layer publisher,
        # and apply any the voxel publisher drained first.
        self._pending_layer_removals.update(
            getattr(static_mapper, "last_removed_keys", []))
        self._pending_layer_updates.update(
            getattr(static_mapper, "last_meshed_keys", []))
        if self._pending_mesh_removals:
            mesh_layer.remove_blocks(list(self._pending_mesh_removals))
            self._pending_mesh_removals.clear()
        current = set(mesh_layer.blocks.keys())
        # Budgeted incremental publishing (parity: serializeSelectedLayers'
        # bandwidth limit + proximity prioritization) with per-subscriber
        # full-map resend for late joiners (layer_publishing.cpp:545-584).
        if self._mesh_streamer is None:
            self._mesh_streamer = LayerStreamer(
                block_size_m=static_mapper.voxel_size_m * 8,
                params=StreamingParams(
                    bandwidth_mbps=self.params
                    .layer_streamer_bandwidth_limit_mbps),
                clock=self.clock)
        remeshed = set(getattr(static_mapper, "last_meshed_keys", []))
        sent_any = (set.intersection(*self._mesh_sent_to.values())
                    if self._mesh_sent_to else set())
        never_published = current - sent_any
        self._mesh_streamer.mark_dirty((never_published | remeshed) & current)
        selected = set(self._mesh_streamer.select_blocks()) & current
        removed_everywhere = set()
        for sid in subs:
            sent = self._mesh_sent_to.setdefault(sid, set())
            # Late subscriber: catch up on never-seen blocks UNDER the
            # same bandwidth budget, spread over ticks (parity: the
            # reference streams the full-map resend through
            # serializeSelectedLayers' budget, layer_publishing.cpp:
            # 545-584, 702-711) — a per-subscriber streamer queues the
            # backlog instead of dumping `current - sent` in one message.
            backlog = current - sent - selected
            catch_up = set()
            if backlog:
                rs = self._mesh_resend_streamers.get(sid)
                if rs is None:
                    rs = LayerStreamer(
                        block_size_m=static_mapper.voxel_size_m * 8,
                        params=StreamingParams(
                            bandwidth_mbps=self.params
                            .layer_streamer_bandwidth_limit_mbps),
                        clock=self.clock)
                    self._mesh_resend_streamers[sid] = rs
                rs.mark_dirty(backlog)
                catch_up = set(rs.select_blocks()) & backlog
            elif sid in self._mesh_resend_streamers:
                del self._mesh_resend_streamers[sid]
            to_send = selected | catch_up
            removed = sent - current
            blocks = [MeshBlockMsg(index=Index3D(*key),
                                   vertices=mesh_layer.blocks[key].vertices,
                                   colors=mesh_layer.blocks[key].colors,
                                   triangles=mesh_layer.blocks[key].triangles)
                      for key in to_send if key in mesh_layer.blocks]
            msg = MeshMsg(
                header=Header(stamp_s=self.clock(),
                              frame_id=self.params.global_frame),
                block_size_m=static_mapper.voxel_size_m * 8,
                blocks=blocks,
                removed_blocks=[Index3D(*k) for k in removed])
            self.bus.publish_to("~/mesh", sid, msg)
            sent |= to_send
            sent -= removed
            removed_everywhere |= removed
        # Drop state for unsubscribed ids.
        for sid in list(self._mesh_sent_to.keys()):
            if sid not in subs:
                del self._mesh_sent_to[sid]
                self._mesh_resend_streamers.pop(sid, None)

    # Voxel-layer topics: channel name + optional validity-weight channel.
    LAYER_TOPICS = {
        "~/tsdf_layer": ("tsdf_distance", "tsdf_weight"),
        "~/color_layer": ("color_r", "color_weight"),
        "~/occupancy_layer": ("occupancy_log_odds", None),
        "~/esdf_layer": ("esdf_sq_dist", None),
        "~/freespace_layer": ("freespace_high_confidence", None),
    }

    def _publish_voxel_layers(self) -> None:
        """Budgeted incremental voxel-layer streaming (parity:
        LayerPublisher::serializeAndpublishSubscribedLayers,
        layer_publishing.cpp:675-826): only updated blocks are serialized,
        all layers share the bandwidth budget, removals are emitted, and
        late subscribers catch up through the never-sent backlog.

        The selected blocks' rows, voxel centres and visibility mask are
        gathered on the device; only the voxels published cross to the
        host (`last_host_bytes["layers"]` counts them with the slot and
        dirty-block lookups, over the layer topics published so far)."""
        m = self.multi_mapper.static_mapper
        subscribed = [(topic, chs) for topic, chs in self.LAYER_TOPICS.items()
                      if self.bus.num_subscribers(topic)
                      and chs[0] in m.channels]
        if not subscribed:
            return
        host_bytes = 0
        updated = set(self._pending_layer_updates)
        self._pending_layer_updates.clear()
        if not self.bus.subscriber_ids("~/mesh"):
            # No mesh consumer drives re-mesh tracking; derive updated
            # blocks from the device dirty flags directly. Do NOT clear
            # them (the mesh path owns them): still-dirty blocks re-queue
            # each publish, which the bandwidth budget rate-limits.
            dirty_slots = torch.nonzero(m.dirty).squeeze(1)
            bidx = to_host(m.state.block_index_of_slot[dirty_slots])
            host_bytes += 8 * dirty_slots.numel() + bidx.nbytes
            updated |= {tuple(int(x) for x in k) for k in bidx}
        # Drain the device removal log and merge whatever the mesh path
        # drained first; forward our drain to the mesh path symmetrically.
        drained = device_io.take_removed_blocks(m)
        self._pending_mesh_removals.update(drained)
        removed = list(set(drained) | self._pending_layer_removals)
        self._pending_layer_removals.clear()
        origin = np.asarray(m.world_config.origin_block)
        dims = np.asarray(m.world_config.dims)

        def slot_of(keys):
            """(key, slot) of the allocated keys inside the world grid, in
            the order given: one gather of the slot grid on the device."""
            inside = [k for k in keys
                      if np.all(np.asarray(k) - origin >= 0)
                      and np.all(np.asarray(k) - origin < dims)]
            if not inside:
                return []
            cells = torch.as_tensor(np.asarray(inside, np.int64) - origin,
                                    device=self.device)
            slots = to_host(m.state.slot_grid[cells[:, 0], cells[:, 1],
                                              cells[:, 2]])
            nonlocal host_bytes
            host_bytes += slots.nbytes
            return [(k, int(s)) for k, s in zip(inside, slots) if s >= 0]

        for topic, (channel, weight_ch) in subscribed:
            streamer = self._layer_streamers.get(topic)
            if streamer is None:
                streamer = LayerStreamer(
                    block_size_m=m.voxel_size_m * 8,
                    params=StreamingParams(
                        bandwidth_mbps=self.params
                        .layer_streamer_bandwidth_limit_mbps),
                    clock=self.clock)
                self._layer_streamers[topic] = streamer
            sent = self._layer_sent.setdefault(topic, set())
            streamer.mark_dirty(updated | (updated - sent))
            selected = streamer.select_blocks()
            pairs = slot_of(selected)
            if not pairs and not removed:
                continue
            blocks = []
            if pairs:
                keys = [k for k, _ in pairs]
                slots = torch.as_tensor([s for _, s in pairs],
                                        dtype=torch.long, device=self.device)
                centers = voxel_centers_for_blocks(
                    torch.as_tensor(np.asarray(keys, np.int32),
                                    device=self.device), m.voxel_size_m)
                values = m.channels[channel].index_select(0, slots)
                if weight_ch and weight_ch in m.channels:
                    occupied = (m.channels[weight_ch].index_select(0, slots)
                                > self.params.layer_visualization_min_tsdf_weight)
                else:
                    occupied = torch.ones(values.shape[:2], dtype=torch.bool,
                                          device=self.device)
                # Exclusion filters (parity: layer_visualization_exclusion_
                # height_m / _radius_m, node_params.hpp:186-193): voxels
                # above the height or beyond the radius from the robot pose
                # are not visualized.
                occupied &= (centers[..., 2]
                             <= self.params.layer_visualization_exclusion_height_m)
                T_rob = self.transformer.lookup_transform_to_global_frame(
                    self.params.pose_frame, self.clock())
                if T_rob is not None:
                    r = self.params.layer_visualization_exclusion_radius_m
                    rob = torch.as_tensor(np.asarray(T_rob[:2, 3]),
                                          device=self.device)
                    d2 = torch.sum((centers[..., :2] - rob) ** 2, dim=-1)
                    occupied &= d2 <= r * r
                # Only the published voxels cross to the host, block by
                # block in key order.
                counts = to_host(occupied.sum(dim=1))
                centers = to_host(centers[occupied])
                values = to_host(values[occupied])
                host_bytes += counts.nbytes + centers.nbytes + values.nbytes
                if channel.startswith("color") and \
                        self.params.layer_visualization_undo_gamma_correction:
                    values = np.asarray(undo_srgb_gamma(values))
                ends = np.cumsum(counts)
                for i, key in enumerate(keys):
                    if counts[i] == 0:
                        continue
                    lo, hi = int(ends[i] - counts[i]), int(ends[i])
                    blocks.append(VoxelBlockMsg(
                        index=Index3D(*key), centers=centers[lo:hi],
                        values=values[lo:hi]))
                sent |= set(keys)
            sent -= set(removed)
            self.last_host_bytes["layers"] = host_bytes
            self.bus.publish(topic, VoxelBlockLayerMsg(
                header=Header(stamp_s=self.clock(),
                              frame_id=self.params.global_frame),
                layer_name=channel, block_size_m=m.voxel_size_m * 8,
                voxel_size_m=m.voxel_size_m, blocks=blocks,
                removed_blocks=[Index3D(*k) for k in removed]))

    def shutdown(self, output_dir=None) -> None:
        """Shutdown hook: export the 2D occupancy map (parity: the map-saving
        shutdown hook, nvblox_node.cpp:129-169;
        after_shutdown_map_save_path, node_params.hpp)."""
        if output_dir is None:
            output_dir = self.params.after_shutdown_map_save_path
        if output_dir is None:
            return
        m = self.multi_mapper.static_mapper
        self.multi_mapper.update_esdf()
        res = self._slice_one(m)
        if res is None:
            return
        spec, img = res
        grid = occupancy_grid_from_slice(img, self.params.free_threshold_m)
        save_occupancy_grid(output_dir, "map", grid, spec.voxel_size_m,
                            spec.origin_x_m, spec.origin_y_m)

    def _clear_map_outside_radius(self, now: float) -> None:
        if not self._gate.should_process("map_clearing", 1.0, now):
            return
        T = self.transformer.lookup_transform_to_global_frame(
            self.params.map_clearing_frame_id, now)
        if T is not None:
            self.multi_mapper.static_mapper.clear_outside_radius(
                T[:3, 3], self.params.map_clearing_radius_m)

    # -------------------------------------------------------------- services
    def save_map(self, path) -> bool:
        """Parity: save_map service (nvblox_node.cpp:1654-1686)."""
        fut = self.service_queue.submit(
            lambda: device_io.save_map_device(
                self.multi_mapper.static_mapper, path))
        self.tick()
        fut.result()
        return True

    def load_map(self, path) -> bool:
        fut = self.service_queue.submit(
            lambda: device_io.load_map_device(
                self.multi_mapper.static_mapper, path))
        self.tick()
        fut.result()
        return True

    def save_ply(self, directory) -> bool:
        """Parity: save_ply service (nvblox_node.cpp:1598-1652)."""

        def work():
            d = Path(directory)
            m = self.multi_mapper.static_mapper
            device_io.update_mesh_layer(m)
            v, c, t = m.mesh_layer.as_arrays()
            write_mesh_ply(d / "mesh.ply", v, t, c)
            if "tsdf_distance" in m.channels:
                write_voxel_layer_ply_device(d / "tsdf.ply", m, "tsdf")
            if "esdf_sq_dist" in m.channels:
                write_voxel_layer_ply_device(d / "esdf.ply", m, "esdf")
            return True

        fut = self.service_queue.submit(work)
        self.tick()
        return bool(fut.result())

    def save_timings(self, path) -> bool:
        """Parity: save_timings service (nvblox_node.cpp:1724-1748)."""
        with open(path, "w") as f:
            f.write(Timing.to_string() + "\n")
        return True

    def save_rates(self, path) -> bool:
        with open(path, "w") as f:
            f.write(Rates.to_string() + "\n")
        return True

    def get_esdf_and_gradients(self, aabb_min_m, aabb_max_m,
                               update_esdf: bool = True,
                               clear_spheres=(), clear_aabbs=()):
        """Parity: EsdfAndGradients service (nvblox_node.cpp:1776-1876)."""
        def work():
            m = self.multi_mapper.static_mapper
            if clear_spheres or clear_aabbs:
                m.clear_tsdf_inside_shapes(spheres=clear_spheres,
                                           aabbs=clear_aabbs)
            if update_esdf:
                m.update_esdf()  # the dense query needs the 3D field
            grid, grads, origin = device_io.esdf_and_gradients_device(
                m, aabb_min_m, aabb_max_m,
                default_value=self.params.esdf_and_gradients_unobserved_value)
            return EsdfAndGradientsResponse(
                success=True, origin_m=tuple(origin),
                voxel_size_m=m.voxel_size_m, esdf=grid, gradients=grads)

        fut = self.service_queue.submit(work)
        self.tick()
        return fut.result()
