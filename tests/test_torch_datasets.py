"""The port's image codec and dataset loaders against the reference (CPU).

The codec decodes PNGs with zlib and the host unfilter library; imageio,
which the reference reads and writes with, is the yardstick here. The
loaders of both packages read each other's files to the same frames; JPEG
colours are compared as decoded arrays, where both sides decode through
Pillow."""

import json
import struct
import zlib

import imageio.v2 as imageio
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaac_ros_nvblox_tpu.datasets import base as jbase
from isaac_ros_nvblox_tpu.datasets import recorded as jrec
from isaac_ros_nvblox_tpu.datasets import replica as jrep
from isaac_ros_nvblox_tpu.datasets import replica_writer as jrw
from isaac_ros_nvblox_tpu.datasets import synthetic as jsyn
from isaac_ros_nvblox_tpu.models import camera as jc
from isaac_ros_nvblox_tpu.models import scene as js
from isaac_ros_nvblox_tpu_torch import native
from isaac_ros_nvblox_tpu_torch.datasets import base as tbase
from isaac_ros_nvblox_tpu_torch.datasets import recorded as trec
from isaac_ros_nvblox_tpu_torch.datasets import replica as trep
from isaac_ros_nvblox_tpu_torch.datasets import replica_writer as trw
from isaac_ros_nvblox_tpu_torch.datasets import synthetic as tsyn
from isaac_ros_nvblox_tpu_torch.io import image_codec as ic
from isaac_ros_nvblox_tpu_torch.models import camera as tc
from isaac_ros_nvblox_tpu_torch.models import scene as ts

torch.set_num_threads(2)

CAM_ARGS = dict(fx=160.0, fy=160.0, cx=79.5, cy=59.5, width=160, height=120)
JCAM, TCAM = jc.Camera(**CAM_ARGS), tc.Camera(**CAM_ARGS)
SMALL = dict(fx=50., fy=50., cx=15.5, cy=11.5, width=32, height=24)
KINDS = {"gray8": (np.uint8, ()), "gray16": (np.uint16, ()),
         "rgb8": (np.uint8, (3,)), "rgba8": (np.uint8, (4,))}


def _image(kind, seed=0, shape=(23, 37)):
    """A smooth ramp plus noise: every filter sees non-trivial rows."""
    dtype, trailing = KINDS[kind]
    rng = np.random.default_rng(seed)
    top = np.iinfo(dtype).max
    ramp = np.add.outer(np.arange(shape[0]), 3 * np.arange(shape[1]))
    ramp = ramp.reshape(shape + (1,) * len(trailing)) * (top // 200)
    noise = rng.integers(0, top // 8, shape + trailing)
    return ((ramp + noise) % (top + 1)).astype(dtype)


def _png_with_filter(img, filt):
    """A PNG of `img` whose every row uses filter `filt`, written with zlib
    by hand."""
    ctype = {1: 0, 3: 2, 4: 6}[1 if img.ndim == 2 else img.shape[2]]
    depth = 16 if img.dtype == np.uint16 else 8
    rows = (img.astype(">u2").view(np.uint8) if depth == 16 else img)
    H = img.shape[0]
    rows = rows.reshape(H, -1).astype(np.int32)
    bpp = (1 if img.ndim == 2 else img.shape[2]) * depth // 8
    up = np.vstack([np.zeros((1, rows.shape[1]), np.int32), rows[:-1]])
    left = np.hstack([np.zeros((H, bpp), np.int32), rows[:, :-bpp]])
    ul = np.hstack([np.zeros((H, bpp), np.int32), up[:, :-bpp]])
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, ul))
    pred = [0, left, up, (left + up) // 2, paeth][filt]
    body = ((rows - pred) % 256).astype(np.uint8)
    raw = np.hstack([np.full((H, 1), filt, np.uint8), body]).tobytes()

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", img.shape[1], H, depth,
                                         ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


# ------------------------------------------------------------------ codec
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_png_decode_matches_imageio(tmp_path, kind):
    img = _image(kind, seed=1)
    path = tmp_path / "a.png"
    imageio.imwrite(path, img)
    got = ic.read_png(path)
    want = np.asarray(imageio.imread(path))
    assert got.dtype == want.dtype == img.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("filt", range(5))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_png_row_filters_native_plain_and_imageio(monkeypatch, kind, filt):
    """One image per row filter (0 none, 1 sub, 2 up, 3 average, 4 Paeth):
    the native unfilter, its numpy version and imageio agree."""
    img = _image(kind, seed=filt)
    data = _png_with_filter(img, filt)
    np.testing.assert_array_equal(np.asarray(imageio.imread(data)), img)
    np.testing.assert_array_equal(ic.decode_png(data), img)
    monkeypatch.setattr(native, "png_unfilter", native.png_unfilter_plain)
    np.testing.assert_array_equal(ic.decode_png(data), img)


def test_native_unfilter_equals_plain_on_random_rows():
    rng = np.random.default_rng(7)
    for bpp in (1, 2, 3, 4):
        H, row = 9, 5 * bpp
        raw = rng.integers(0, 256, (H, row + 1)).astype(np.uint8)
        raw[:, 0] = rng.integers(0, 5, H)
        data = raw.tobytes()
        np.testing.assert_array_equal(native.png_unfilter(data, H, row, bpp),
                                      native.png_unfilter_plain(data, H, row,
                                                                bpp))
    raw[3, 0] = 7
    with pytest.raises(ValueError, match="row 3"):
        native.png_unfilter(raw.tobytes(), H, row, bpp)
    with pytest.raises(ValueError, match="unsupported PNG"):
        ic.decode_png(_png_with_filter(_image("rgb8"), 0).replace(
            b"\x08\x02\x00\x00\x00", b"\x08\x03\x00\x00\x00"))


def test_png_library_build_failure_raises(monkeypatch, tmp_path):
    """A failed build of the PNG library raises with the compiler's name:
    nothing falls back to the numpy unfilter."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_png_lib", None)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="png_native: false failed"):
        ic.decode_png(_png_with_filter(_image("gray8"), 1))
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.mark.parametrize("kind", ["gray8", "gray16", "rgb8"])
def test_png_encode_decodes_in_imageio(tmp_path, kind):
    img = _image(kind, seed=3, shape=(40, 33))
    ic.write_png(tmp_path / "b.png", img)
    back = np.asarray(imageio.imread(tmp_path / "b.png"))
    assert back.dtype == img.dtype
    np.testing.assert_array_equal(back, img)
    np.testing.assert_array_equal(ic.read_png(tmp_path / "b.png"), img)


def test_jpeg_through_the_host_codec(tmp_path, monkeypatch):
    assert ic.jpeg_codec() == "PIL"
    img = _image("rgb8", seed=4, shape=(30, 40))
    imageio.imwrite(tmp_path / "c.jpg", img)
    np.testing.assert_array_equal(ic.read_jpeg(tmp_path / "c.jpg"),
                                  np.asarray(imageio.imread(tmp_path
                                                            / "c.jpg")))
    ic.write_jpeg(tmp_path / "d.jpg", img)
    np.testing.assert_array_equal(ic.read_jpeg(tmp_path / "d.jpg"),
                                  np.asarray(imageio.imread(tmp_path
                                                            / "d.jpg")))
    # Without a codec a JPEG that exists raises and names the file.
    monkeypatch.setattr(ic, "jpeg_codec", lambda: None)
    with pytest.raises(RuntimeError, match="c.jpg"):
        ic.read_jpeg(tmp_path / "c.jpg")


# ---------------------------------------------------------------- loaders
def _scene_pair():
    j = js.Scene(primitives=(
        js.RoomBox(center=(0.0, 0.0, 1.25), half_extents=(2.2, 1.8, 1.25)),
        js.Sphere(center=(0.7, 0.5, 0.8), radius=0.4)))
    t = ts.Scene(primitives=(
        ts.RoomBox(center=(0.0, 0.0, 1.25), half_extents=(2.2, 1.8, 1.25)),
        ts.Sphere(center=(0.7, 0.5, 0.8), radius=0.4)))
    return j, t


def _assert_same_frames(got, want, exact_color=True):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.depth, np.asarray(w.depth))
        assert g.depth.dtype == np.float32
        np.testing.assert_array_equal(g.T_L_C, np.asarray(w.T_L_C))
        assert g.camera.width == w.camera.width
        assert (g.camera.fx, g.camera.cy) == (w.camera.fx, w.camera.cy)
        assert g.timestamp_s == w.timestamp_s
        assert (g.color is None) == (w.color is None)
        if g.color is not None:
            np.testing.assert_array_equal(g.color, np.asarray(w.color))


def test_synthetic_loader_matches_reference():
    scene_j, scene_t = _scene_pair()
    cam = dict(fx=40., fy=40., cx=19.5, cy=14.5, width=40, height=30)
    got = list(tsyn.SyntheticDataLoader(num_frames=3, scene=scene_t,
                                        camera=tc.Camera(**cam),
                                        device="cpu"))
    want = list(jsyn.SyntheticDataLoader(num_frames=3, scene=scene_j,
                                         camera=jc.Camera(**cam)))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.depth.shape == (30, 40) and g.color.shape == (30, 40, 3)
        assert isinstance(g.depth, np.ndarray) and (g.depth > 0).any()
        np.testing.assert_array_equal(g.T_L_C, w.T_L_C)
        # The renderers' tolerance (tests/test_torch_core.py).
        err = np.abs(g.depth - np.asarray(w.depth))
        assert (err <= 1e-5).mean() >= 0.999 and err.max() <= 1e-3
        assert (g.color != np.asarray(w.color)).any(-1).mean() <= 1e-3


@pytest.fixture(scope="module")
def replica_pair(tmp_path_factory):
    """The same orbit written by both writers (160x120, 6 frames)."""
    scene_j, scene_t = _scene_pair()
    kw = dict(n_frames=6, orbit_radius=1.1, orbit_height=1.0,
              target=(0, 0, 1.0))
    jroot = jrw.write_replica_sequence(tmp_path_factory.mktemp("jrep"),
                                       scene_j, JCAM, **kw)
    troot = trw.write_replica_sequence(tmp_path_factory.mktemp("trep"),
                                       scene_t, TCAM, device="cpu", **kw)
    return jroot, troot


def test_replica_files_cross_load(replica_pair):
    """Each package's Replica loader reads the other's files to the same
    frames (depth, pose, camera and decoded colour)."""
    jroot, troot = replica_pair
    for root in (jroot, troot):
        _assert_same_frames(list(trep.ReplicaDataLoader(root)),
                            list(jrep.ReplicaDataLoader(root)))
    # The writers quantize the same depth alike; the renderers differ by
    # at most one u16 level where tracing rounds differently.
    jd = np.asarray(imageio.imread(jroot / "results" / "depth000003.png"))
    td = ic.read_png(troot / "results" / "depth000003.png")
    assert td.dtype == np.uint16
    assert np.abs(td.astype(np.int64) - jd).max() <= 1
    assert (td == jd).mean() >= 0.999
    depth = np.random.default_rng(0).random((7, 9)).astype(np.float32) * 9
    np.testing.assert_array_equal(
        trw.quantize_depth(depth),
        np.clip(depth * jrw.DEPTH_SCALE, 0, 65535).astype(np.uint16))
    assert json.loads((troot / "cam_params.json").read_text()) == \
        json.loads((jroot / "cam_params.json").read_text())


def test_replica_loader_default_camera_and_stride(replica_pair, tmp_path):
    jroot, _ = replica_pair
    loader = trep.ReplicaDataLoader(jroot, max_frames=2, frame_stride=2)
    frames = list(loader)
    assert loader.num_frames == 4 and len(frames) == 2
    np.testing.assert_array_equal(frames[1].T_L_C,
                                  np.asarray(list(jrep.ReplicaDataLoader(
                                      jroot))[2].T_L_C))
    # Without cam_params.json: Replica's default camera (vMAP export).
    (tmp_path / "results").mkdir()
    np.savetxt(tmp_path / "traj.txt", np.eye(4).reshape(1, -1))
    d = trep.ReplicaDataLoader(tmp_path)
    assert (d.camera.width, d.camera.height, d.camera.fx, d.camera.fy) == \
        (1200, 680, 600.0, 600.0)
    assert (d.camera.cx, d.camera.cy, d.depth_scale) == (599.5, 339.5,
                                                          6553.5)
    assert d.load_next()[0] == tbase.DataLoadResult.BAD_FRAME


def _render_seq(n=4):
    out = []
    for i in range(n):
        T = js.orbit_pose(2 * np.pi * i / 8, radius=1.1, height=1.0,
                          target=(0, 0, 1.0))
        scene_j, _ = _scene_pair()
        d = np.asarray(js.render_depth(scene_j, JCAM, jnp.asarray(T)))
        c = np.asarray(js.render_color(scene_j, JCAM, jnp.asarray(T)))
        out.append((np.where(np.isfinite(d), d, 0.0), c, T))
    return out


def test_threedmatch_and_redwood_loaders_match_reference(tmp_path):
    """3DMatch and Redwood layouts written as the reference's tests write
    them; both packages' loaders give the same frames."""
    seq = _render_seq()
    root = tmp_path / "3dm"
    (root / "seq-01").mkdir(parents=True)
    K = np.array([[JCAM.fx, 0, JCAM.cx], [0, JCAM.fy, JCAM.cy], [0, 0, 1.0]])
    np.savetxt(root / "camera-intrinsics.txt", K)
    for i, (d, c, T) in enumerate(seq):
        stem = root / "seq-01" / f"frame-{i:06d}"
        imageio.imwrite(f"{stem}.depth.png",
                        np.clip(d * 1000.0, 0, 65535).astype(np.uint16))
        imageio.imwrite(f"{stem}.color.png", np.clip(c, 0, 255)
                        .astype(np.uint8))
        np.savetxt(f"{stem}.pose.txt", T)
    got = trep.ThreeDMatchDataLoader(root)
    assert got.num_frames == 4
    _assert_same_frames(list(got), list(jrep.ThreeDMatchDataLoader(root)))

    red = tmp_path / "redwood"
    (red / "depth").mkdir(parents=True)
    (red / "image").mkdir()
    lines = []
    for i, (d, c, T) in enumerate(seq):
        imageio.imwrite(red / "depth" / f"{i:06d}.png",
                        np.clip(d * 1000.0, 0, 65535).astype(np.uint16))
        imageio.imwrite(red / "image" / f"{i:06d}.jpg",
                        np.clip(c, 0, 255).astype(np.uint8))
        lines.append(f"{i} {i} {i + 1}")
        lines.extend(" ".join(f"{v:.9g}" for v in row)
                     for row in np.asarray(T, np.float64))
    (red / "pose.log").write_text("\n".join(lines) + "\n")
    kw = dict(fx=JCAM.fx, fy=JCAM.fy, cx=JCAM.cx, cy=JCAM.cy)
    got = trep.RedwoodDataLoader(red, **kw)
    assert got.num_frames == 4
    _assert_same_frames(list(got), list(jrep.RedwoodDataLoader(red, **kw)))
    np.testing.assert_array_equal(
        trep.RedwoodDataLoader._read_pose_log(red / "pose.log"),
        jrep.RedwoodDataLoader._read_pose_log(red / "pose.log"))


# --------------------------------------------- recorded (test_datasets.py)
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_recorded_sequence_roundtrip(tmp_path, writer):
    """A recording made by either package replays in both to the same
    frames (the reference's round trip: 4 frames, interpolated poses)."""
    rec_mod = trec if writer == "port" else jrec
    cam = (tc if writer == "port" else jc).Camera(**SMALL)
    rec = rec_mod.SequenceRecorder(tmp_path / "seq", cam)
    rng = np.random.RandomState(0)
    for i in range(4):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = i * 0.1
        rec.add_pose(i * 0.5, T)
        rec.add_frame(i * 0.5 + 0.01, rng.rand(24, 32).astype(np.float32),
                      (rng.rand(24, 32, 3) * 255).astype(np.uint8))
    rec.finish()
    frames = list(trec.RecordedDataLoader(tmp_path / "seq"))
    assert len(frames) == 4
    np.testing.assert_allclose(frames[2].T_L_C[0, 3], 0.2, atol=1e-5)
    assert frames[0].color is not None
    want = list(jrec.RecordedDataLoader(tmp_path / "seq"))
    for g, w in zip(frames, want):
        np.testing.assert_array_equal(g.depth, w.depth)
        np.testing.assert_array_equal(g.color, w.color)
        np.testing.assert_allclose(g.T_L_C, w.T_L_C, atol=1e-6)
        assert g.timestamp_s == w.timestamp_s


def test_recorded_sequence_pose_gap_gives_bad_frame(tmp_path):
    rec = trec.SequenceRecorder(tmp_path / "seq", tc.Camera(**SMALL))
    rec.add_pose(0.0, np.eye(4, dtype=np.float32))
    rec.add_frame(0.0, np.ones((24, 32), np.float32))
    rec.add_frame(99.0, np.ones((24, 32), np.float32))  # no pose near t=99
    rec.finish()
    for mod, base in ((trec, tbase), (jrec, jbase)):
        loader = mod.RecordedDataLoader(tmp_path / "seq")
        results = []
        while True:
            r, _ = loader.load_next()
            if r == base.DataLoadResult.NO_MORE_DATA:
                break
            results.append(r.value)
        assert results == ["success", "bad_frame"]


def test_recorded_tf_lead_time_streams_poses_ahead(tmp_path):
    """Poses stream tf_lead_time_s ahead of the images
    (rosbag_data_loader.cpp:83-150): a frame whose bracketing pose comes
    later fails with lead 0 and interpolates with a lead that covers it."""
    rec = trec.SequenceRecorder(tmp_path / "seq", tc.Camera(**SMALL))
    rec.add_pose(0.9, np.eye(4, dtype=np.float32))
    T2 = np.eye(4, dtype=np.float32)
    T2[0, 3] = 1.0
    rec.add_pose(1.4, T2)
    rec.add_frame(1.0, np.ones((24, 32), np.float32))
    rec.finish()
    strict = trec.RecordedDataLoader(tmp_path / "seq", tf_lead_time_s=0.0,
                                     timestamp_tolerance_s=0.05)
    assert strict.load_next()[0] == tbase.DataLoadResult.BAD_FRAME
    lead = trec.RecordedDataLoader(tmp_path / "seq", tf_lead_time_s=0.5,
                                   timestamp_tolerance_s=0.05)
    r, f = lead.load_next()
    assert r == tbase.DataLoadResult.SUCCESS
    assert 0.0 < f.T_L_C[0, 3] < 1.0  # interpolated between the brackets
    _, w = jrec.RecordedDataLoader(tmp_path / "seq", tf_lead_time_s=0.5,
                                   timestamp_tolerance_s=0.05).load_next()
    np.testing.assert_allclose(f.T_L_C, w.T_L_C, atol=1e-6)


def test_replica_loader_format(tmp_path):
    """A tiny Replica-format dataset written with imageio (the reference's
    test): 16-bit depth back to meters, poses, camera."""
    root = tmp_path / "office_tiny"
    (root / "results").mkdir(parents=True)
    scale = 6553.5
    cam = {"fx": 30.0, "fy": 30.0, "cx": 15.5, "cy": 11.5,
           "w": 32, "h": 24, "scale": scale}
    (root / "cam_params.json").write_text(json.dumps({"camera": cam}))
    poses = []
    rng = np.random.RandomState(1)
    for i in range(3):
        depth_m = 1.0 + rng.rand(24, 32).astype(np.float32)
        imageio.imwrite(root / "results" / f"depth{i:06d}.png",
                        (depth_m * scale).astype(np.uint16))
        imageio.imwrite(root / "results" / f"frame{i:06d}.jpg",
                        (rng.rand(24, 32, 3) * 255).astype(np.uint8))
        T = np.eye(4)
        T[1, 3] = i
        poses.append(T.reshape(-1))
    np.savetxt(root / "traj.txt", np.stack(poses))
    frames = list(trep.ReplicaDataLoader(root))
    assert len(frames) == 3
    assert frames[0].camera.width == 32
    assert 0.99 < frames[0].depth.min() and frames[0].depth.max() < 2.01
    np.testing.assert_allclose(frames[2].T_L_C[1, 3], 2.0, atol=1e-6)
    _assert_same_frames(frames, list(jrep.ReplicaDataLoader(root)))
