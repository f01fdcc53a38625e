"""The online node in nvblox's people-segmentation mode
(`human_with_static_tsdf`): `NvbloxNode` with a segmentation mask beside
every depth frame, driven as kinds/node.py drives the node, and what its
run is compared by.

Before the program is built, the traffic's people are put into the lap
(people.py: into depth and color, with their masks in the configuration's
mask camera, and the false-positive blobs). Each depth frame is handed
over with its mask, the mask camera and T_CM_CD. The subscribers are
kinds/node.py's, with `~/combined_map_slice` beside them; the costmap
reads the slice the traffic names (`subscribers.costmap`).

Compared (reference/segmentation.py replays the same ticks): the static
TSDF, color and mesh as in kinds/node.py; `slice_off_share` over the last
`~/static_map_slice` and the last `~/combined_map_slice` together;
`mask_off_share`, the filtered masks the window's depth frames were split
by (the program's own: each copied as it is, without a host sync, into
page-locked host memory made before the window, so that the card's
memory does not grow with the frames a window integrates; the copy is
the kind's only work on the card inside the window, and launches no
kernel) against the reference's;
`human_off_share`, the human layer's observed voxels and their
log-odds.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from portbench import people, programs
from portbench.kinds import node as node_kind

LOG_ODDS_TOL = 1e-5     # human layer log-odds (steps of ~0.2 and more)
HUMAN = ["occupancy_log_odds", "occupancy_observed"]
# Window frames a block of the host buffer of masks holds, and the blocks
# made before the window (more are made if a window needs them): 2048
# frames, a 51 s window's 1530 at 30 Hz with room.
MASK_BLOCK_FRAMES = 512
MASK_BLOCKS_AHEAD = 4


def warm_up_steps(config: Dict) -> int:
    return node_kind.warm_up_steps(config)


def _slice_dict(msg) -> Optional[Dict]:
    if msg is None:
        return None
    return {"origin_x_m": float(msg.origin_x_m),
            "origin_y_m": float(msg.origin_y_m), "width": int(msg.width),
            "height": int(msg.height), "data": np.asarray(msg.data)}


class Program(node_kind.Program):
    def __init__(self, config: Dict, traffic: Dict, lap, device):
        from isaac_ros_nvblox_tpu_torch.runtime.costmap import \
            NvbloxCostmapLayer
        pl = people.overlay(lap, config, traffic, device)
        subs = dict(traffic["subscribers"])
        costmap = subs.pop("costmap", None)
        super().__init__(config, dict(traffic, subscribers=subs), lap, device)
        mc = pl.mask_camera
        from isaac_ros_nvblox_tpu_torch.models.camera import Camera
        self.mask_camera = Camera(mc.fx, mc.fy, mc.cx, mc.cy, mc.width,
                                  mc.height)
        self.T_CM_CD = pl.T_CM_CD
        self.masks = pl.masks
        bus = self.node.bus
        if costmap:
            self.costmap = NvbloxCostmapLayer(bus, topic=f"~/{costmap}")
        self.last_combined = None
        if subs.get("combined_map_slice"):
            bus.subscribe("~/combined_map_slice", self._on_combined)
        self._last_mask = None
        H, W = self.camera.height, self.camera.width
        self._pinned = torch.device(device).type == "cuda"
        self._mask_blocks = [self._mask_block(H, W)
                             for _ in range(MASK_BLOCKS_AHEAD)]
        self._masks_kept = 0
        print(f"people: a person in the mask in {pl.in_view_share:.4f} of "
              f"the lap's {lap.depths.shape[0]} frames, {pl.blobs} blobs",
              file=sys.stderr, flush=True)

    def _on_combined(self, msg) -> None:
        self.last_combined = msg

    def _mask_block(self, H: int, W: int) -> torch.Tensor:
        return torch.empty((MASK_BLOCK_FRAMES, H, W), dtype=torch.uint8,
                           pin_memory=self._pinned)

    def _keep_mask(self, m) -> None:
        """The frame's filtered mask into the next frame of the host buffer
        (on the card an asynchronous copy, and no kernel)."""
        b, r = divmod(self._masks_kept, MASK_BLOCK_FRAMES)
        if b == len(self._mask_blocks):
            self._mask_blocks.append(self._mask_block(*m.shape))
        self._mask_blocks[b][r].copy_(m, non_blocking=self._pinned)
        self._masks_kept += 1

    def step(self) -> Optional[float]:
        """One tick, each depth frame handed over with its mask; while
        counting, the mask the frame was split by is kept (`_keep_mask`:
        no host sync)."""
        i, s, lap, node = self.i, self.sched, self.lap, self.node
        now = s.now(i)
        if s.pose_due(i):
            node.add_pose(self.cam_frame, now, lap.orbit.camera_pose(now))
            node.add_pose("base_link", now, lap.orbit.lidar_pose(now))
        handoff = None
        n = lap.depths.shape[0]
        for k in s.frames_at(i):
            stamp = s.frame_stamp(k)
            handoff = time.perf_counter()
            node.add_depth_image(lap.depths[k % n], self.camera,
                                 self.cam_frame, stamp, mask=self.masks[k % n],
                                 mask_camera=self.mask_camera,
                                 T_CM_CD=self.T_CM_CD)
            node.add_color_image(lap.colors[k % n], self.camera,
                                 self.cam_frame, stamp)
        self._now = now
        node.tick()
        self.i += 1
        m = node.multi_mapper._last_dynamic_mask_dev
        if m is not None and m is not self._last_mask:
            self._last_mask = m
            if self.counting:
                self._keep_mask(m)
        return handoff

    def outputs(self) -> Dict:
        """kinds/node.py's outputs, the last combined slice, the human
        layer's live rows and the window's filtered masks, on the host."""
        out = super().outputs()
        out["combined"] = _slice_dict(self.last_combined)
        out["human"] = programs.live_rows(self.node.multi_mapper
                                          .dynamic_mapper, HUMAN)
        if self._pinned:
            torch.cuda.synchronize()
        out["masks"] = torch.cat(self._mask_blocks)[:self._masks_kept].numpy()
        return out


def reference(cell, lap, n_steps: int, warm: int, device,
              dtype=torch.float32) -> Dict:
    """The plain reference's replay of the run's ticks."""
    from portbench.reference import segmentation
    people.overlay(lap, cell.config, cell.traffic, device)
    return segmentation.replay(cell.config,
                               node_kind.schedule(cell.config, lap), lap,
                               n_steps, device=device, dtype=dtype,
                               window_from=warm, mesh=cell.meshes)


def mask_off(kept: np.ndarray, ref: Dict, chunk: int = 64):
    """Pixels set in either side's filtered mask of the window's depth
    frames (u8[F, H, W], > 0 set), in order: off where they differ (every
    set pixel of a frame only one side has)."""
    masks = ref["masks"]
    frames = ref["window_frames"]
    dev = masks.device
    n = min(len(frames), kept.shape[0])
    off = total = 0
    for s in range(0, n, chunk):
        got = torch.as_tensor(kept[s:s + chunk], device=dev) > 0
        want = masks[torch.as_tensor(frames[s:s + chunk], device=dev)] > 0
        off += int((got != want).sum())
        total += int((got | want).sum())
    extra = int((torch.as_tensor(kept[n:], device=dev) > 0).sum()) \
        if kept.shape[0] > n else 0
    for s in range(n, len(frames), chunk):
        extra += int((masks[torch.as_tensor(frames[s:s + chunk],
                                            device=dev)] > 0).sum())
    return off + extra, total + extra


def human_off(rows: Dict, hmap):
    """Voxels the human layer observed on either side: off where only one
    side observed them or their log-odds differ."""
    from portbench import compare
    dev = hmap.lo.device
    blocks = rows["blocks"]
    lo = torch.as_tensor(rows["occupancy_log_odds"], device=dev).float()
    obs = torch.as_tensor(rows["occupancy_observed"], device=dev) > 0
    rlo = compare.ref_rows(hmap.lo, hmap.origin, blocks).float()
    robs = compare.ref_rows(hmap.obs, hmap.origin, blocks).bool()
    both = obs & robs
    bad = (obs != robs) | (both & ((lo - rlo).abs() > LOG_ODDS_TOL))
    extra = compare._outside_count(hmap.obs, hmap.origin, blocks)
    return int(bad.sum()) + extra, int((obs | robs).sum()) + extra


def numbers(cell, outputs: Dict, ref: Dict) -> Dict:
    """`tsdf_off_share`, `color_off_share`, `mesh_off_share` (a viewer),
    `slice_off_share` (the static and the combined slice together),
    `mask_off_share` and `human_off_share`."""
    from portbench import compare
    nums = programs.map_numbers(outputs, ref)
    unknown = float(cell.config["params"]["node"]
                    ["distance_map_unknown_value_optimistic"])
    vs = node_kind.voxel_size(cell.config)
    a = compare.slice_off(outputs["slice"], ref["slice"], unknown, vs)
    b = compare.slice_off(outputs["combined"], ref["combined"], unknown, vs)
    nums["slice_off_share"] = compare.share((a[0] + b[0], a[1] + b[1]))
    nums["mask_off_share"] = compare.share(
        mask_off(outputs["masks"], ref))
    nums["human_off_share"] = compare.share(human_off(outputs["human"],
                                                      ref["human"]))
    return nums


def stand_in(cell, ref: Dict) -> Dict:
    """A reference run's outputs in the form a program's take (the
    control's stand-in for the program)."""
    from portbench import compare
    out = node_kind.stand_in(cell, ref)
    out["combined"] = ref["combined"]
    hmap = ref["human"]
    X, Y, Z = hmap.dims
    per = hmap.obs.view(X // 8, 8, Y // 8, 8, Z // 8, 8).any(5).any(3).any(1)
    blocks = torch.nonzero(per).cpu().numpy() + hmap.origin // 8
    out["human"] = {
        "blocks": blocks,
        "occupancy_log_odds": compare.ref_rows(
            hmap.lo, hmap.origin, blocks).float().cpu().numpy(),
        "occupancy_observed": compare.ref_rows(
            hmap.obs, hmap.origin, blocks).to(torch.uint8).cpu().numpy()}
    masks = ref["masks"]
    idx = torch.as_tensor(ref["window_frames"], dtype=torch.long,
                          device=masks.device)
    out["masks"] = masks[idx].cpu().numpy()
    return out
