"""Message adapters: flatten incremental layer messages into monolithic ones.

Reference: `nvblox_message_adapters` (SURVEY.md §2.2) — stateful nodes that
consume incremental `Mesh` / `VoxelBlockLayer` messages (per-block updates +
removals) and republish monolithic `MeshSerialized` / `VoxelSerialized`
arrays with re-indexed triangles
(nvblox_message_adapters/src/nvblox_mesh_layer_adapter_node.cpp:36-99).

A copy of isaac_ros_nvblox_tpu/runtime/adapters.py for the port.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from isaac_ros_nvblox_tpu_torch.runtime.msgs import (MeshMsg, MeshSerialized,
                                                    VoxelBlockLayerMsg,
                                                    VoxelSerialized)


class MeshLayerAdapter:
    """Stateful Mesh -> MeshSerialized flattener."""

    def __init__(self, bus, in_topic: str = "~/mesh",
                 out_topic: str = "~/mesh_serialized"):
        self._blocks: Dict[Tuple[int, int, int], object] = {}
        self._bus = bus
        self._out_topic = out_topic
        bus.subscribe(in_topic, self.callback)

    def callback(self, msg: MeshMsg) -> None:
        if msg.clear:
            self._blocks.clear()
        for b in msg.blocks:
            key = (b.index.x, b.index.y, b.index.z)
            if b.triangles.shape[0] == 0:
                self._blocks.pop(key, None)
            else:
                self._blocks[key] = b
        for idx in msg.removed_blocks:
            self._blocks.pop((idx.x, idx.y, idx.z), None)
        self._bus.publish(self._out_topic, self.serialize(msg.header))

    def serialize(self, header) -> MeshSerialized:
        if not self._blocks:
            return MeshSerialized(header=header,
                                  vertices=np.zeros((0, 3), np.float32),
                                  colors=np.zeros((0, 3), np.uint8),
                                  triangles=np.zeros((0, 3), np.int32))
        vs, cs, ts = [], [], []
        offset = 0
        for b in self._blocks.values():
            vs.append(b.vertices)
            cs.append(b.colors)
            ts.append(b.triangles + offset)  # re-index into the flat buffer
            offset += b.vertices.shape[0]
        return MeshSerialized(header=header,
                              vertices=np.concatenate(vs),
                              colors=np.concatenate(cs),
                              triangles=np.concatenate(ts))


class VoxelLayerAdapter:
    """Stateful VoxelBlockLayer -> VoxelSerialized flattener."""

    def __init__(self, bus, in_topic: str, out_topic: str):
        self._blocks: Dict[Tuple[int, int, int], object] = {}
        self._bus = bus
        self._out_topic = out_topic
        bus.subscribe(in_topic, self.callback)

    def callback(self, msg: VoxelBlockLayerMsg) -> None:
        for b in msg.blocks:
            key = (b.index.x, b.index.y, b.index.z)
            if b.centers.shape[0] == 0:
                self._blocks.pop(key, None)
            else:
                self._blocks[key] = b
        for idx in msg.removed_blocks:
            self._blocks.pop((idx.x, idx.y, idx.z), None)
        self._bus.publish(self._out_topic, self.serialize(msg.header))

    def serialize(self, header) -> VoxelSerialized:
        if not self._blocks:
            return VoxelSerialized(header=header,
                                   centers=np.zeros((0, 3), np.float32),
                                   values=np.zeros((0,), np.float32))
        centers = np.concatenate([b.centers for b in self._blocks.values()])
        values = np.concatenate([b.values for b in self._blocks.values()])
        return VoxelSerialized(header=header, centers=centers, values=values)
