"""Message schema: in-process mirrors of nvblox_msgs.

Reference: nvblox_msgs package (SURVEY.md §2.2): `DistanceMapSlice`,
`Mesh`+`MeshBlock`, `VoxelBlockLayer`+`VoxelBlock`, `Index3D`,
`MeshSerialized`/`VoxelSerialized` (flattened forms produced by
nvblox_message_adapters), srv `FilePath`, `EsdfAndGradients`.

These are plain dataclasses with dict round-trips so they can cross any
transport (json/msgpack/flatbuffer) — DDS's decoupled pub/sub role is played
by the in-process `MessageBus` below (SURVEY.md §5.8).

A copy of isaac_ros_nvblox_tpu/runtime/msgs.py for the port.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Tuple

import numpy as np


@dataclasses.dataclass
class Header:
    stamp_s: float = 0.0
    frame_id: str = ""


@dataclasses.dataclass
class Index3D:
    x: int
    y: int
    z: int


@dataclasses.dataclass
class DistanceMapSlice:
    """Parity: nvblox_msgs/DistanceMapSlice.msg."""
    header: Header
    origin_x_m: float
    origin_y_m: float
    resolution_m: float
    width: int
    height: int
    unknown_value: float
    data: np.ndarray  # f32[height, width]


@dataclasses.dataclass
class MeshBlockMsg:
    """Parity: nvblox_msgs/MeshBlock.msg (vertices/colors/triangles)."""
    index: Index3D
    vertices: np.ndarray   # f32[V, 3]
    colors: np.ndarray     # u8[V, 3]
    triangles: np.ndarray  # i32[T, 3]


@dataclasses.dataclass
class MeshMsg:
    """Parity: nvblox_msgs/Mesh.msg — incremental block update + removals."""
    header: Header
    block_size_m: float
    blocks: List[MeshBlockMsg]
    removed_blocks: List[Index3D]
    clear: bool = False  # receiver should drop cached blocks first


@dataclasses.dataclass
class VoxelBlockMsg:
    """Parity: nvblox_msgs/VoxelBlock.msg."""
    index: Index3D
    centers: np.ndarray  # f32[N, 3]
    values: np.ndarray   # f32[N] or u8[N,3] colors


@dataclasses.dataclass
class VoxelBlockLayerMsg:
    """Parity: nvblox_msgs/VoxelBlockLayer.msg."""
    header: Header
    layer_name: str
    block_size_m: float
    voxel_size_m: float
    blocks: List[VoxelBlockMsg]
    removed_blocks: List[Index3D]


@dataclasses.dataclass
class MeshSerialized:
    """Parity: nvblox_msgs/MeshSerialized.msg — monolithic flattened mesh
    (produced by the mesh layer adapter)."""
    header: Header
    vertices: np.ndarray
    colors: np.ndarray
    triangles: np.ndarray


@dataclasses.dataclass
class VoxelSerialized:
    """Parity: nvblox_msgs/VoxelSerialized.msg — monolithic voxel dump."""
    header: Header
    centers: np.ndarray
    values: np.ndarray


@dataclasses.dataclass
class EsdfAndGradientsResponse:
    """Parity: nvblox_msgs/srv/EsdfAndGradients response — dense grid
    (esdf_and_gradients_conversions.cu:106-124 packs a Float32MultiArray;
    we return the dense arrays + origin directly)."""
    success: bool
    origin_m: Tuple[float, float, float]
    voxel_size_m: float
    esdf: np.ndarray       # f32[X, Y, Z] signed distance
    gradients: np.ndarray  # f32[X, Y, Z, 3]


class MessageBus:
    """Minimal in-process pub/sub playing DDS's role for consumers.

    Topics are strings; subscribers are callables. `num_subscribers` lets
    publishers skip serialization when nobody listens (parity: the
    subscriber-bitmask gate in layer_publishing.cpp:638-673).
    """

    def __init__(self):
        self._subs: Dict[str, List[Callable]] = {}
        self._lock = threading.Lock()

    def subscribe(self, topic: str, fn: Callable) -> None:
        with self._lock:
            self._subs.setdefault(topic, []).append(fn)

    def num_subscribers(self, topic: str) -> int:
        with self._lock:
            return len(self._subs.get(topic, ()))

    def subscriber_ids(self, topic: str):
        """Stable per-subscriber ids — lets publishers keep per-subscriber
        state such as the full-map resend for late mesh subscribers
        (parity: layer_publishing.cpp:545-584)."""
        with self._lock:
            return [id(fn) for fn in self._subs.get(topic, ())]

    def publish(self, topic: str, msg) -> int:
        with self._lock:
            subs = list(self._subs.get(topic, ()))
        for fn in subs:
            fn(msg)
        return len(subs)

    def publish_to(self, topic: str, subscriber_id: int, msg) -> bool:
        """Deliver to one subscriber (by id from subscriber_ids)."""
        with self._lock:
            subs = list(self._subs.get(topic, ()))
        for fn in subs:
            if id(fn) == subscriber_id:
                fn(msg)
                return True
        return False
