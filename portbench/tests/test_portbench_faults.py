"""A run with the timed path broken underneath comes out not correct, for
each fault the cells can have: a step that leaves the map unchanged, half
of a frame's blocks left out, an answer altered where it is produced, a
mesh update that skips changed blocks, and a slice published over a
cropped frame. (The cells run on one card: there is no exchange between
cards to leave out.)"""

import dataclasses

import pytest
import torch

from conftest import tiny_run


def _no_fusion(*args, **kwargs):
    """The TSDF step returns the map as it was."""
    return args[0], args[1]


def _half_batch(orig):
    """The TSDF step leaves out the second half of a frame's blocks."""
    def fuse(distance, weight, slots, block_indices, *args, **kwargs):
        cap = distance.shape[0]
        real = int((slots < cap).sum())
        keep = torch.arange(slots.shape[0], device=slots.device) < real // 2
        return orig(distance, weight,
                    torch.where(keep, slots, torch.full_like(slots, cap)),
                    block_indices, *args, **kwargs)
    return fuse


def _every_other(orig):
    """The mesh update runs on every other call only: the changed blocks
    of the skipped updates keep their old meshes until the next."""
    calls = []

    def update(m, *args, **kwargs):
        calls.append(1)
        if len(calls) % 2:
            return orig(m, *args, **kwargs)
        m.dirty.zero_()
        return []
    return update


@pytest.mark.parametrize("name", ["node_base.viewer", "fuser_replica.orbit"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered",
                                   "mesh_skipped"])
def test_fault_is_not_correct(monkeypatch, name, fault):
    from isaac_ros_nvblox_tpu_torch.mapper import device_io, device_mapper
    if fault == "mesh_skipped":
        monkeypatch.setattr(device_io, "update_mesh_layer",
                            _every_other(device_io.update_mesh_layer))
    elif fault == "unchanged":
        monkeypatch.setattr(device_mapper, "integrate_tsdf_cuda", _no_fusion)
    elif fault == "half_batch":
        monkeypatch.setattr(device_mapper, "integrate_tsdf_cuda",
                            _half_batch(device_mapper.integrate_tsdf_cuda))
    elif name.startswith("node"):
        orig = device_io.slice_esdf_2d_device

        def slice_plus(*args, **kwargs):
            out = orig(*args, **kwargs)
            return None if out is None else (out[0], out[1] + 0.01)
        monkeypatch.setattr(device_io, "slice_esdf_2d_device", slice_plus)
    else:
        orig = device_mapper._esdf_solve

        def solve_plus(*args, **kwargs):
            sq, inside, observed = orig(*args, **kwargs)
            return sq + 1.0, inside, observed
        monkeypatch.setattr(device_mapper, "_esdf_solve", solve_plus)
    line = tiny_run(name)
    assert line["correct"] is False, line["checks"]


def test_cropped_slice_is_not_correct(monkeypatch):
    """The slice published over the lower half of its frame in x (at the
    card's size a quarter cut from an edge of the port's frame, which
    spans the lidar's reach, holds no known cell)."""
    from isaac_ros_nvblox_tpu_torch.mapper import device_io
    orig = device_io.slice_esdf_2d_device

    def cropped(*args, **kwargs):
        out = orig(*args, **kwargs)
        if out is None:
            return None
        spec, img = out
        w = img.shape[1]
        return dataclasses.replace(spec, width=w // 2), img[:, :w // 2]
    monkeypatch.setattr(device_io, "slice_esdf_2d_device", cropped)
    line = tiny_run("node_base.headless")
    assert line["correct"] is False, line["checks"]
