"""The port covers the JAX package's public API: read with `ast` (neither
package is imported), every public module-level function, class and
constant, every public method (and `__init__`) and class-level field, and
every parameter of each, has a counterpart of the same name in the port.

Modules map one to one (`ops/*_pallas.py` -> `ops/*_cuda.py`), names too
(`pallas` -> `cuda`). A module-level counterpart is any binding of the name
(def, class, assignment or import); a class member's is a binding in the
class body or a `self.<name>` assignment in its methods. What the port
leaves out on purpose is listed in LEFT_OUT with its reason; an entry that
no longer names a gap fails as stale."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = ROOT / "isaac_ros_nvblox_tpu"
PORT = ROOT / "isaac_ros_nvblox_tpu_torch"
MODULES = sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py"))

_INTERPRET = ("Pallas interpret mode; a CUDA kernel has none, and CPU "
              "tensors take the plain version")
_ABLATE = "switches for TPU ablation runs of the Pallas body"

# {qualified name: why the port has no counterpart}
LEFT_OUT = {
    "core/world_grid.py::B":
        "alias of core/types.py::VOXELS_PER_SIDE, which the port imports "
        "where it needs it",
    "mapper/device_mapper.py::DeviceMapper.update_mesh_dirty_device"
    "(use_pallas)":
        "the tensor's device picks the path: the marching_cubes kernel on "
        "the card, its plain version on the CPU",
    "native/__init__.py::log":
        "the logger of the numpy fallback's warning; the port has no "
        "fallback",
    "native/__init__.py::have_native":
        "the port's native library builds or raises, so there is no "
        "fallback to report on",
    "ops/color_pallas.py::NC":
        "TPU layout: the sampled planes stacked per Pallas program",
    "ops/color_pallas.py::integrate_color_pallas(interpret)": _INTERPRET,
    "ops/detect_pallas.py::detect_dynamic_pallas":
        "the TPU kernel over a block batch; the port's kernel "
        "(ops/detect_cuda.py::detect_dynamic) reads the slot grid per pixel",
    "ops/detect_pallas.py::detect_dynamic_fused_pallas":
        "footprint, batch and kernel in one TPU program; the port's whole "
        "path is ops/detect_cuda.py::detect_dynamic",
    "ops/esdf_dense.py::halo_blocks":
        "TPU block-major line layout of the EDT (csrc/edt.cu sweeps lines "
        "in place)",
    "ops/esdf_dense.py::line_rows":
        "TPU block-major line layout of the EDT (csrc/edt.cu sweeps lines "
        "in place)",
    "ops/esdf_dense.py::binary_pass_lean":
        "TPU form of the first EDT pass; its port is the edt_pass1 kernel",
    "ops/esdf_dense.py::edt_pass_blockmajor":
        "TPU block-major EDT pass; its port is the edt_pass kernel",
    "ops/esdf_dense.py::esdf_from_sites_dense(interpret)": _INTERPRET,
    "ops/esdf_dense.py::esdf_2d_from_sites(interpret)": _INTERPRET,
    "ops/ground_plane.py::ransac_plane_fit(key)":
        "a JAX PRNG key; the port draws from a torch.Generator "
        "(`generator=`) or takes the draws (`draw=`)",
    "ops/halo.py::dilate_dense_grid_pallas":
        "the port's kernel wrapper is ops/halo.py::dilate_dense_grid",
    "ops/lidar_pallas.py::integrate_tsdf_lidar_pallas(interpret)":
        _INTERPRET,
    "ops/masking.py::remove_small_connected_components_device":
        "the pooled, 48-round approximation of nvblox's mask filter; the "
        "port's mapping path takes the exact filter "
        "(ops/masking.py::remove_small_connected_components_exact, kernel "
        "mask_components)",
    "ops/mesh_pallas.py::NB": "TPU layout: voxel blocks per Pallas program",
    "ops/mesh_pallas.py::marching_cubes_fused(interpret)": _INTERPRET,
    "ops/mesh_pallas.py::marching_cubes_fused(ablate)": _ABLATE,
    "ops/occupancy_pallas.py::integrate_occupancy_pallas(interpret)":
        _INTERPRET,
    "ops/tsdf_color_pallas.py::NC":
        "TPU layout: the sampled planes stacked per Pallas program",
    "ops/tsdf_color_pallas.py::integrate_tsdf_color_pallas(interpret)":
        _INTERPRET,
    "ops/tsdf_pallas.py::TILE_U": "TPU layout: one-hot window tile width",
    "ops/tsdf_pallas.py::TILE_V": "TPU layout: one-hot window tile height",
    "ops/tsdf_pallas.py::UW": "TPU layout: one-hot window lane width",
    "ops/tsdf_pallas.py::OHU_ROWS": "TPU layout: one-hot window rows",
    "ops/tsdf_pallas.py::N_LEVELS":
        "TPU layout: levels of the decimation pyramid",
    "ops/tsdf_pallas.py::V":
        "voxels per block; the port uses core/types.py::VOXELS_PER_BLOCK",
    "ops/tsdf_pallas.py::NB": "TPU layout: voxel blocks per Pallas program",
    "ops/tsdf_pallas.py::write_window_onehot":
        "TPU one-hot window write; the tsdf_fuse kernel projects per voxel",
    "ops/tsdf_pallas.py::zero_window_onehot":
        "TPU one-hot window reset; the tsdf_fuse kernel projects per voxel",
    "ops/tsdf_pallas.py::build_decimation_levels":
        "TPU decimation pyramid; the tsdf_fuse kernel reads the depth "
        "image directly",
    "ops/tsdf_pallas.py::pad_batch":
        "TPU batch padding to whole Pallas programs; the persistent "
        "kernel walks any batch size",
    "ops/tsdf_pallas.py::footprint_prepass":
        "TPU footprint prepass for the one-hot windows",
    "ops/tsdf_pallas.py::integrate_tsdf_pallas(interpret)": _INTERPRET,
    "ops/tsdf_pallas.py::integrate_tsdf_pallas(ablate)": _ABLATE,
    "ops/view.py::footprint_depth_minmax":
        "feeds only the TPU one-hot windows of tsdf_pallas.py",
    "ops/view.py::touched_block_grid(subsample)":
        "the reference accepts it and deletes it unused (view.py:123); no "
        "caller passes it",
    "parallel/distributed.py::put_sharded(spec)":
        "a jax PartitionSpec; the port's SpatialMesh shards the leading "
        "axis only",
    "utils/timing.py::Timer.__init__(block_until_ready)":
        "a span that waits on the card; the port's spans never sync, so "
        "that the span log names the host's gaps as they are",
    "utils/timing.py::Timer.set_block":
        "a span that waits on the card; the port's spans never sync, so "
        "that the span log names the host's gaps as they are",
}


def port_module(rel: str) -> str:
    return rel.replace("_pallas.py", "_cuda.py")


def port_name(name: str) -> str:
    return name.replace("pallas", "cuda")


def _public(name: str) -> bool:
    return not name.startswith("_")


def _params(fn) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return names + [x.arg for x in (a.vararg, a.kwarg) if x is not None]


def _bindings(body) -> dict:
    """{name: node} of the defs, classes, assignments and imports in a
    statement list."""
    out = {}
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, ast.Assign):
            out.update((t.id, node) for t in node.targets
                       if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out[node.target.id] = node
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update(((al.asname or al.name).split(".")[0], node)
                       for al in node.names)
    return out


def _self_attributes(cls) -> set:
    """Names assigned as `self.<name>` anywhere in the class."""
    return {t.attr for node in ast.walk(cls)
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign))
            for target in (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
            for t in ast.walk(target)
            if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
            and t.value.id == "self"}


def _missing_params(ref_fn, port_fn, qual: str) -> list:
    if not isinstance(port_fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return []
    have = set(_params(port_fn))
    return [f"{qual}({p})" for p in _params(ref_fn) if p not in have]


def missing(ref_src: str, port_src: str, module: str) -> list:
    """Qualified names (`module::name`, `module::Class.member`,
    `module::function(parameter)`) of the reference's public API that have
    no counterpart in the port's source."""
    ref = _bindings(ast.parse(ref_src).body)
    port = _bindings(ast.parse(port_src).body)
    out = []
    for name, node in ref.items():
        if not _public(name) or isinstance(node, (ast.Import,
                                                  ast.ImportFrom)):
            continue
        qual = f"{module}::{name}"
        other = port.get(port_name(name))
        if other is None:
            out.append(qual)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out += _missing_params(node, other, qual)
        elif isinstance(node, ast.ClassDef) and isinstance(other,
                                                           ast.ClassDef):
            have = _bindings(other.body)
            attrs = _self_attributes(other)
            for member, m in _bindings(node.body).items():
                if not (_public(member) or member == "__init__"):
                    continue
                mqual = f"{qual}.{member}"
                if member in have:
                    if isinstance(m, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                        out += _missing_params(m, have[member], mqual)
                elif member not in attrs:
                    out.append(mqual)
    return out


@pytest.mark.parametrize("module", MODULES)
def test_port_has_every_public_name(module):
    port_file = PORT / port_module(module)
    assert port_file.is_file(), f"no port of {module}"
    gaps = set(missing((REF / module).read_text(), port_file.read_text(),
                       module))
    left_out = {k for k in LEFT_OUT if k.startswith(f"{module}::")}
    assert sorted(gaps - left_out) == [], "missing in the port"
    assert sorted(left_out - gaps) == [], "stale LEFT_OUT entries"
    assert all(LEFT_OUT[k].strip() for k in left_out)


def test_left_out_names_modules_of_the_package():
    assert {k.split("::")[0] for k in LEFT_OUT} <= set(MODULES)


def test_checker_flags_a_missing_function_and_parameter():
    ref = ("import numpy as np\n"
           "LIMIT = 3\n"
           "def kept(a, *, b=1): pass\n"
           "def gone(x): pass\n"
           "def fuse_pallas(d, interpret=False): pass\n"
           "class Mapper:\n"
           "    size: int = 0\n"
           "    def __init__(self, voxel, name='m'): self.voxel = voxel\n"
           "    def run(self, frames, every=0): pass\n"
           "    def _private(self): pass\n")
    port = ("from somewhere import LIMIT\n"
            "def kept(a, *, b=1, device=None): pass\n"
            "def fuse_cuda(d): pass\n"
            "class Mapper:\n"
            "    def __init__(self, voxel, size=0):\n"
            "        self.size = size\n"
            "    def run(self, frames): pass\n")
    assert sorted(missing(ref, port, "m.py")) == [
        "m.py::Mapper.__init__(name)", "m.py::Mapper.run(every)",
        "m.py::fuse_pallas(interpret)", "m.py::gone"]
    assert missing(ref, ref.replace("pallas", "cuda"), "m.py") == []
