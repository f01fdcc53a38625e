"""Standalone HTML viewer: mesh + voxel-layer cubes -> one WebGL page (the
parts of tools/mesh_viewer.py the example pipeline uses, for the port).

The RViz plugin / Foxglove converter render the incremental mesh and
VoxelBlockLayer cubes with a cut-ceiling option
(nvblox_rviz_plugin/src/nvblox_plugin_visual.cpp:91-310,
nvblox_foxglove/src/index.ts:53-190). Without ROS, `write_html` emits a
single self-contained HTML file (inline WebGL2, no external dependencies):
colored mesh + instanced voxel cubes, orbit controls and an interactive
ceiling cut. Keys in the page: m = toggle mesh, v = toggle voxels,
c / x = raise / lower the cut ceiling.
"""

import base64
import json
from pathlib import Path

import numpy as np

from isaac_ros_nvblox_tpu_torch.core.types import voxel_centers_for_blocks

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>nvblox-tpu viewer</title>
<style>body{margin:0;background:#111;color:#eee;font-family:sans-serif}
#info{position:fixed;top:8px;left:8px;font-size:12px}</style></head>
<body><div id="info">nvblox-tpu — drag: orbit, wheel: zoom,
 m: mesh, v: voxels, c/x: ceiling</div>
<canvas id="c"></canvas>
<script>
const MESH = MESH_DATA_PLACEHOLDER;
const CUBES = CUBE_DATA_PLACEHOLDER;
function b64f32(s){const b=atob(s);const a=new Float32Array(b.length/4);
 const dv=new DataView(new ArrayBuffer(4));
 for(let i=0;i<a.length;i++){for(let j=0;j<4;j++)dv.setUint8(j,b.charCodeAt(i*4+j));
  a[i]=dv.getFloat32(0,true);}return a;}
function b64u32(s){const b=atob(s);const a=new Uint32Array(b.length/4);
 const dv=new DataView(new ArrayBuffer(4));
 for(let i=0;i<a.length;i++){for(let j=0;j<4;j++)dv.setUint8(j,b.charCodeAt(i*4+j));
  a[i]=dv.getUint32(0,true);}return a;}
const verts=b64f32(MESH.v), cols=b64f32(MESH.c), idx=b64u32(MESH.i);
const canvas=document.getElementById('c');
canvas.width=innerWidth;canvas.height=innerHeight;
const gl=canvas.getContext('webgl2');
function sh(t,s){const x=gl.createShader(t);gl.shaderSource(x,s);gl.compileShader(x);
 if(!gl.getShaderParameter(x,gl.COMPILE_STATUS))throw gl.getShaderInfoLog(x);return x;}
function prog(vs,fs){const p=gl.createProgram();
 gl.attachShader(p,sh(gl.VERTEX_SHADER,vs));
 gl.attachShader(p,sh(gl.FRAGMENT_SHADER,fs));gl.linkProgram(p);return p;}
const meshProg=prog(`#version 300 es
in vec3 p;in vec3 col;uniform mat4 mvp;out vec3 vc;out vec3 vp;
void main(){gl_Position=mvp*vec4(p,1.0);vc=col;vp=p;}`,`#version 300 es
precision highp float;in vec3 vc;in vec3 vp;out vec4 o;
void main(){vec3 dx=dFdx(vp),dy=dFdy(vp);
 vec3 n=normalize(cross(dx,dy));
 float l=0.35+0.65*abs(dot(n,normalize(vec3(0.4,0.3,0.85))));
 o=vec4(vc*l,1.0);}`);
// Instanced voxel cubes with a cut-ceiling uniform (parity:
// nvblox_plugin_visual cut_ceiling option).
const cubeProg=prog(`#version 300 es
in vec3 corner;in vec3 center;in vec3 icol;
uniform mat4 mvp;uniform float vsize;uniform float zcut;
out vec3 vc;out vec3 vn;out float keep;
void main(){
 keep=center.z<=zcut?1.0:0.0;
 vec3 p=center+corner*vsize*0.5;
 gl_Position=mvp*vec4(p,1.0);
 vc=icol;vn=normalize(corner);}`,`#version 300 es
precision highp float;in vec3 vc;in vec3 vn;in float keep;out vec4 o;
void main(){if(keep<0.5)discard;
 float l=0.45+0.55*abs(dot(normalize(vn),normalize(vec3(0.4,0.3,0.85))));
 o=vec4(vc*l,1.0);}`);
function buf(p,data,loc,n,div){const b=gl.createBuffer();
 gl.bindBuffer(gl.ARRAY_BUFFER,b);
 gl.bufferData(gl.ARRAY_BUFFER,data,gl.STATIC_DRAW);
 gl.enableVertexAttribArray(loc);gl.vertexAttribPointer(loc,n,gl.FLOAT,false,0,0);
 if(div)gl.vertexAttribDivisor(loc,div);return b;}
// Mesh VAO.
const meshVao=gl.createVertexArray();gl.bindVertexArray(meshVao);
buf(meshProg,verts,gl.getAttribLocation(meshProg,'p'),3,0);
buf(meshProg,cols,gl.getAttribLocation(meshProg,'col'),3,0);
const ib=gl.createBuffer();gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER,ib);
gl.bufferData(gl.ELEMENT_ARRAY_BUFFER,idx,gl.STATIC_DRAW);
// Cube VAO (36-vertex cube, instanced by voxel center).
let nCubes=0,vsize=0.05,zcut=1e9,zmin=0,zmax=0;
const cubeVao=gl.createVertexArray();
if(CUBES){
 const cp=b64f32(CUBES.p),cc=b64f32(CUBES.c);vsize=CUBES.s;nCubes=cp.length/3;
 const f=[-1,-1,-1, 1,-1,-1, 1,1,-1, -1,-1,-1, 1,1,-1, -1,1,-1,
          -1,-1,1, 1,1,1, 1,-1,1, -1,-1,1, -1,1,1, 1,1,1,
          -1,-1,-1, 1,-1,1, 1,-1,-1, -1,-1,-1, -1,-1,1, 1,-1,1,
          -1,1,-1, 1,1,-1, 1,1,1, -1,1,-1, 1,1,1, -1,1,1,
          -1,-1,-1, -1,1,1, -1,-1,1, -1,-1,-1, -1,1,-1, -1,1,1,
          1,-1,-1, 1,-1,1, 1,1,1, 1,-1,-1, 1,1,1, 1,1,-1];
 gl.bindVertexArray(cubeVao);
 buf(cubeProg,new Float32Array(f),gl.getAttribLocation(cubeProg,'corner'),3,0);
 buf(cubeProg,cp,gl.getAttribLocation(cubeProg,'center'),3,1);
 buf(cubeProg,cc,gl.getAttribLocation(cubeProg,'icol'),3,1);
 zmin=1e9;zmax=-1e9;
 for(let i=2;i<cp.length;i+=3){zmin=Math.min(zmin,cp[i]);zmax=Math.max(zmax,cp[i]);}
 zcut=zmax;
}
gl.enable(gl.DEPTH_TEST);
let cx=0,cy=0,cz=0,n=verts.length/3;
for(let i=0;i<verts.length;i+=3){cx+=verts[i];cy+=verts[i+1];cz+=verts[i+2];}
if(n>0){cx/=n;cy/=n;cz/=n;}
let yaw=0.7,pitch=0.5,dist=5.0,drag=false,lx=0,ly=0;
let showMesh=true,showVox=nCubes>0;
canvas.onmousedown=e=>{drag=true;lx=e.x;ly=e.y};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(drag){yaw+=(e.x-lx)*0.01;pitch+=(e.y-ly)*0.01;
 pitch=Math.max(-1.5,Math.min(1.5,pitch));lx=e.x;ly=e.y;}};
canvas.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);e.preventDefault();};
window.onkeydown=e=>{
 if(e.key=='m')showMesh=!showMesh;
 if(e.key=='v')showVox=!showVox;
 if(e.key=='c')zcut=Math.min(zcut+vsize*2,zmax);
 if(e.key=='x')zcut=Math.max(zcut-vsize*2,zmin);};
function mat(){
 const eye=[cx+dist*Math.cos(pitch)*Math.cos(yaw),
            cy+dist*Math.cos(pitch)*Math.sin(yaw),
            cz+dist*Math.sin(pitch)];
 const f=[cx-eye[0],cy-eye[1],cz-eye[2]];
 const fl=Math.hypot(...f);f[0]/=fl;f[1]/=fl;f[2]/=fl;
 const up=[0,0,1];
 const s=[f[1]*up[2]-f[2]*up[1],f[2]*up[0]-f[0]*up[2],f[0]*up[1]-f[1]*up[0]];
 const sl=Math.hypot(...s);s[0]/=sl;s[1]/=sl;s[2]/=sl;
 const u=[s[1]*f[2]-s[2]*f[1],s[2]*f[0]-s[0]*f[2],s[0]*f[1]-s[1]*f[0]];
 const V=[s[0],u[0],-f[0],0, s[1],u[1],-f[1],0, s[2],u[2],-f[2],0,
  -(s[0]*eye[0]+s[1]*eye[1]+s[2]*eye[2]),
  -(u[0]*eye[0]+u[1]*eye[1]+u[2]*eye[2]),
   (f[0]*eye[0]+f[1]*eye[1]+f[2]*eye[2]),1];
 const a=canvas.width/canvas.height,fov=1.0,nr=0.05,fr=200.0;
 const t=1/Math.tan(fov/2);
 const P=[t/a,0,0,0, 0,t,0,0, 0,0,(fr+nr)/(nr-fr),-1, 0,0,2*fr*nr/(nr-fr),0];
 const M=new Float32Array(16);
 for(let i=0;i<4;i++)for(let j=0;j<4;j++){let x=0;
  for(let k=0;k<4;k++)x+=V[i*4+k]*P[k*4+j];M[i*4+j]=x;}
 return M;}
function draw(){gl.viewport(0,0,canvas.width,canvas.height);
 gl.clearColor(0.07,0.07,0.08,1);gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 const M=mat();
 if(showMesh&&idx.length){gl.useProgram(meshProg);gl.bindVertexArray(meshVao);
  gl.uniformMatrix4fv(gl.getUniformLocation(meshProg,'mvp'),false,M);
  gl.drawElements(gl.TRIANGLES,idx.length,gl.UNSIGNED_INT,0);}
 if(showVox&&nCubes){gl.useProgram(cubeProg);gl.bindVertexArray(cubeVao);
  gl.uniformMatrix4fv(gl.getUniformLocation(cubeProg,'mvp'),false,M);
  gl.uniform1f(gl.getUniformLocation(cubeProg,'vsize'),vsize);
  gl.uniform1f(gl.getUniformLocation(cubeProg,'zcut'),zcut);
  gl.drawArraysInstanced(gl.TRIANGLES,0,36,nCubes);}
 requestAnimationFrame(draw);}
draw();
</script></body></html>
"""


def read_ply(path):
    """Binary little-endian PLY reader (io/ply.py's format): (vertices
    f32[V, 3], colors f32[V, 3] in [0, 1], triangles u32[T, 3])."""
    data = Path(path).read_bytes()
    header_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode()
    n_verts = n_faces = 0
    has_color = "property uchar red" in header
    for line in header.splitlines():
        if line.startswith("element vertex"):
            n_verts = int(line.split()[-1])
        elif line.startswith("element face"):
            n_faces = int(line.split()[-1])
    body = data[header_end:]
    stride = 12 + (3 if has_color else 0)
    rec = np.frombuffer(body[:n_verts * stride], dtype=np.uint8) \
        .reshape(n_verts, stride)
    verts = rec[:, :12].copy().view("<f4").reshape(n_verts, 3)
    colors = (rec[:, 12:15].astype(np.float32) / 255.0 if has_color
              else np.full((n_verts, 3), 0.7, np.float32))
    faces = np.frombuffer(body[n_verts * stride:], dtype=np.uint8)
    tris = np.zeros((n_faces, 3), np.uint32)
    off = 0
    for i in range(n_faces):
        n = int(faces[off])  # python int: uint8 arithmetic would overflow
        tris[i] = np.frombuffer(faces[off + 1:off + 1 + 12].tobytes(),
                                dtype="<i4")[:3]
        off += 1 + 4 * n
    return verts, colors, tris


def _colormap(values: np.ndarray, kind: str) -> np.ndarray:
    """Voxel colors f32[N, 3] in [0, 1]: RGB channels as they are, other
    layers on a blue-green-red ramp between their 2nd and 98th
    percentiles (the rviz plugin's distance / occupancy coloring)."""
    v = np.asarray(values, np.float32)
    if kind == "rgb":
        return np.clip(v / 255.0, 0, 1)
    lo, hi = np.percentile(v, 2), np.percentile(v, 98)
    t = np.clip((v - lo) / max(hi - lo, 1e-6), 0, 1)
    r = np.clip(2 * t - 1, 0, 1)
    g = 1 - np.abs(2 * t - 1)
    b = np.clip(1 - 2 * t, 0, 1)
    return np.stack([r, g, b], -1).astype(np.float32)


LAYER_CHANNELS = {
    "tsdf": ("tsdf_distance", "tsdf_weight", "ramp"),
    "esdf": ("esdf_sq_dist", None, "ramp"),
    "occupancy": ("occupancy_log_odds", None, "ramp"),
    "color": ("color_r", "color_weight", "rgb"),
}


def voxel_layer_payload(mapper, layer: str):
    """(centers f32[N, 3], colors f32[N, 3], voxel size) of a DeviceMapper
    voxel layer, the data the node's VoxelBlockLayerMsg publisher streams
    (nvblox_plugin_visual.cpp cube rendering), or None when empty."""
    channel, weight_ch, kind = LAYER_CHANNELS[layer]
    n = mapper.block_count()
    if n == 0 or channel not in mapper.channels:
        return None

    def rows(name):
        return mapper.channels[name][:n].cpu().numpy()

    bidx = mapper.state.block_index_of_slot[:n]
    centers = voxel_centers_for_blocks(bidx, mapper.voxel_size_m) \
        .cpu().numpy().reshape(n, 512, 3)
    if kind == "rgb":
        vals = np.stack([rows(c) for c in ("color_r", "color_g", "color_b")],
                        -1)
    else:
        vals = rows(channel)
    if weight_ch and weight_ch in mapper.channels:
        keep = rows(weight_ch) > 1e-4
    elif layer == "esdf":
        sq = rows("esdf_sq_dist")
        keep = sq < 1e11
        vals = np.sqrt(np.minimum(sq, 1e11)) * mapper.voxel_size_m
    elif layer == "occupancy":
        keep = vals > 0.0
    else:
        keep = np.ones(vals.shape[:2], bool)
    if layer == "tsdf":
        keep &= np.abs(rows(channel)) < 2 * mapper.voxel_size_m
    centers = centers[keep]
    vals = vals[keep]
    if centers.size == 0:
        return None
    return centers.astype(np.float32), _colormap(vals, kind), \
        float(mapper.voxel_size_m)


def write_html(out_path, verts, colors, tris, cubes=None) -> None:
    """The viewer page of a mesh (colors in [0, 1]) and, optionally, the
    cubes of `voxel_layer_payload`."""
    payload = {
        "v": base64.b64encode(
            np.ascontiguousarray(verts, "<f4").tobytes()).decode(),
        "c": base64.b64encode(
            np.ascontiguousarray(colors, "<f4").tobytes()).decode(),
        "i": base64.b64encode(
            np.ascontiguousarray(tris, "<u4").tobytes()).decode(),
    }
    if cubes is not None:
        centers, ccolors, vsize = cubes
        cube_payload = {
            "p": base64.b64encode(
                np.ascontiguousarray(centers, "<f4").tobytes()).decode(),
            "c": base64.b64encode(
                np.ascontiguousarray(ccolors, "<f4").tobytes()).decode(),
            "s": vsize,
        }
    else:
        cube_payload = None
    html = _PAGE.replace("MESH_DATA_PLACEHOLDER", json.dumps(payload)) \
                .replace("CUBE_DATA_PLACEHOLDER", json.dumps(cube_payload))
    Path(out_path).write_text(html)
