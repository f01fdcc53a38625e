"""Example pipeline bring-up, the launch-file analogue (port of
examples/run_pipeline.py).

nvblox_examples_bringup composes sensor -> nvblox -> costmap ->
visualization graphs from layered YAML (launch/perception/nvblox.launch.py).
This script wires the same graph without ROS: a synthetic (or recorded or
Replica) sensor source feeds the NvbloxNode; the costmap layer and the mesh
adapter subscribe on the bus; the final mesh goes to PLY and a standalone
HTML viewer, beside the node's layer PLYs and its 2-D map.

Usage (from the repository root; `--device cpu` without a card):
  python -m isaac_ros_nvblox_tpu_torch.examples.run_pipeline --frames 16
  python -m isaac_ros_nvblox_tpu_torch.examples.run_pipeline \\
      --config examples/config/nvblox/nvblox_base.yaml --mode dynamic \\
      --frames 24 --out build/pipeline_out
"""

import argparse
import time
from pathlib import Path

import numpy as np

DEFAULT_OUT = Path(__file__).resolve().parents[2] / "build" / "pipeline_out"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=None, nargs="*",
                    help="YAML layers (later wins)")
    ap.add_argument("--mode", default=None,
                    choices=[None, "static", "dynamic", "people_segmentation"])
    ap.add_argument("--dataset", default="synthetic",
                    choices=["synthetic", "replica", "recorded"])
    ap.add_argument("--path", default=None)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from isaac_ros_nvblox_tpu_torch.core.types import resolve_device
    from isaac_ros_nvblox_tpu_torch.io import mesh_viewer
    from isaac_ros_nvblox_tpu_torch.mapper.params import make_params
    from isaac_ros_nvblox_tpu_torch.runtime.adapters import MeshLayerAdapter
    from isaac_ros_nvblox_tpu_torch.runtime.config_loader import load_config
    from isaac_ros_nvblox_tpu_torch.runtime.costmap import NvbloxCostmapLayer
    from isaac_ros_nvblox_tpu_torch.runtime.node import NodeParams, NvbloxNode

    device = resolve_device(args.device)
    if args.config:
        node_params, mapper_params = load_config(args.config)
    else:
        node_params = NodeParams()
        mapper_params = make_params(mode=args.mode)

    node = NvbloxNode(node_params, mapper_params, device=device)
    costmap = NvbloxCostmapLayer(node.bus)
    MeshLayerAdapter(node.bus)
    stats = {"mesh": 0, "slice": 0, "mesh_serialized": 0}

    def count(key):
        return lambda _msg: stats.__setitem__(key, stats[key] + 1)

    node.bus.subscribe("~/mesh", count("mesh"))
    node.bus.subscribe("~/static_map_slice", count("slice"))
    node.bus.subscribe("~/mesh_serialized", count("mesh_serialized"))

    # Sensor source.
    if args.dataset == "synthetic":
        from isaac_ros_nvblox_tpu_torch.datasets.synthetic import (
            SyntheticDataLoader)
        loader = SyntheticDataLoader(num_frames=args.frames, device=device)
    elif args.dataset == "replica":
        from isaac_ros_nvblox_tpu_torch.datasets.replica import (
            ReplicaDataLoader)
        loader = ReplicaDataLoader(args.path, max_frames=args.frames)
    else:
        from isaac_ros_nvblox_tpu_torch.datasets.recorded import (
            RecordedDataLoader)
        loader = RecordedDataLoader(args.path)

    t = [0.0]
    node.clock = lambda: t[0]
    t0 = time.time()
    n = 0
    for frame in loader:
        stamp = frame.timestamp_s
        node.add_pose("camera", stamp, frame.T_L_C)
        node.add_depth_image(np.asarray(frame.depth), frame.camera,
                             "camera", stamp)
        if frame.color is not None:
            node.add_color_image(np.asarray(frame.color), frame.camera,
                                 "camera", stamp)
        t[0] = stamp + 0.001
        node.tick()
        t[0] = stamp + 0.101  # second tick past the esdf/mesh rate gates
        node.tick()
        n += 1
    wall = time.time() - t0

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    node.save_ply(out)
    node.shutdown(out)

    # Standalone viewer of the final mesh.
    v, c, tri = mesh_viewer.read_ply(out / "mesh.ply")
    mesh_viewer.write_html(out / "mesh.html", v, c, tri)

    print(f"frames: {n} in {wall:.1f}s | "
          f"blocks: {node.multi_mapper.static_mapper.block_count()} | "
          f"published: {stats} | "
          f"costmap has data: {costmap.has_data}")
    print(f"outputs in {out}: mesh.ply, tsdf.ply, esdf.ply, map.png, "
          f"map.yaml, mesh.html")
    return node


if __name__ == "__main__":
    main()
