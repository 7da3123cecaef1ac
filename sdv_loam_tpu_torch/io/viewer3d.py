"""Interactive 3-D map viewer — the Pangolin GUI counterpart.

Counterpart of `sdv_loam_tpu/io/viewer3d.py`, the same file apart from its
imports (numpy and JSON only). Reference:
src/IOWrapper/Pangolin/PangolinViewer.{h,cpp} + KeyFrameDisplay.{h,cpp}: a
live OpenGL window with the colored sparse map, camera frusta at the
keyframes, the trajectory polyline, and orbit navigation. Without a
display/GL stack this observer renders the same scene as ONE
self-contained HTML file (inline vanilla WebGL, zero external assets) that
gives the same interaction — orbit / pan / zoom, frusta, per-host point
colors — in any browser.

Use: attach `Html3DViewer(path)` to FullSystem's observers; the file is
(re)written on `join()` and optionally every `every` keyframes.
"""

from __future__ import annotations

import json

import numpy as np

from sdv_loam_tpu_torch.io.observer import Observer

# 8 distinguishable point colors cycled by host keyframe slot
_PALETTE = [
    (0.96, 0.47, 0.20), (0.30, 0.65, 0.95), (0.45, 0.85, 0.40),
    (0.90, 0.35, 0.60), (0.95, 0.85, 0.30), (0.55, 0.45, 0.95),
    (0.35, 0.85, 0.80), (0.85, 0.55, 0.35),
]

_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>sdv_loam_tpu map</title>
<style>
 html,body{margin:0;height:100%;overflow:hidden;background:#101014;
   font:12px monospace;color:#ccc}
 #hud{position:fixed;top:8px;left:10px;pointer-events:none;
   text-shadow:0 1px 2px #000}
 canvas{display:block;width:100vw;height:100vh}
</style></head><body>
<div id="hud"></div><canvas id="c"></canvas>
<script>
const DATA = __DATA__;
const cv = document.getElementById('c');
const gl = cv.getContext('webgl');
const VS = `attribute vec3 p;attribute vec3 col;uniform mat4 mvp;
uniform float ps;varying vec3 vc;
void main(){gl_Position=mvp*vec4(p,1.0);gl_PointSize=ps;vc=col;}`;
const FS = `precision mediump float;varying vec3 vc;
void main(){gl_FragColor=vec4(vc,1.0);}`;
function sh(t,s){const o=gl.createShader(t);gl.shaderSource(o,s);
 gl.compileShader(o);return o;}
const prog=gl.createProgram();
gl.attachShader(prog,sh(gl.VERTEX_SHADER,VS));
gl.attachShader(prog,sh(gl.FRAGMENT_SHADER,FS));
gl.linkProgram(prog);gl.useProgram(prog);
const aP=gl.getAttribLocation(prog,'p'),aC=gl.getAttribLocation(prog,'col');
const uM=gl.getUniformLocation(prog,'mvp'),uS=gl.getUniformLocation(prog,'ps');
function buf(a){const b=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,b);
 gl.bufferData(gl.ARRAY_BUFFER,new Float32Array(a),gl.STATIC_DRAW);return b;}
const ptsB=buf(DATA.pts), ptsCB=buf(DATA.ptsCol);
const trajB=buf(DATA.traj), trajCB=buf(DATA.traj.map((_,i)=>0.9));
const frB=buf(DATA.frusta), frCB=buf(DATA.frustaCol);
const nPts=DATA.pts.length/3, nTraj=DATA.traj.length/3,
      nFr=DATA.frusta.length/3;
// camera: orbit around map centroid
let cx=0,cy=0,cz=0;
for(let i=0;i<DATA.traj.length;i+=3){cx+=DATA.traj[i];cy+=DATA.traj[i+1];
 cz+=DATA.traj[i+2];}
if(nTraj>0){cx/=nTraj;cy/=nTraj;cz/=nTraj;}
let yaw=-0.6,pitch=0.45,dist=DATA.scale*2.0,panX=0,panY=0;
function mat(){
 const w=cv.width,h=cv.height,f=1.5/Math.tan(0.4),asp=w/h;
 const cp=Math.cos(pitch),sp=Math.sin(pitch),
       cyw=Math.cos(yaw),syw=Math.sin(yaw);
 const ex=cx+dist*cp*syw, ey=cy-dist*sp, ez=cz-dist*cp*cyw;
 // look-at
 let fx=cx-ex,fy=cy-ey,fz=cz-ez;const fl=Math.hypot(fx,fy,fz);
 fx/=fl;fy/=fl;fz/=fl;
 let rx=fz*0-fy*(-1),ry=fx*(-1)-fz*0,rz=0; // f x up(0,-1,0)
 rx=-fz; rz=fx; ry=0; const rl=Math.hypot(rx,ry,rz)||1;rx/=rl;rz/=rl;
 const ux=ry*fz-rz*fy, uy=rz*fx-rx*fz, uz=rx*fy-ry*fx;
 const tx=-(rx*ex+ry*ey+rz*ez)+panX, ty=-(ux*ex+uy*ey+uz*ez)+panY,
       tz=-(fx*ex+fy*ey+fz*ez);
 const n=0.05*DATA.scale, fa=100*DATA.scale;
 const a=(fa+n)/(fa-n), b=-2*fa*n/(fa-n);
 return new Float32Array([
  f/asp*rx, f*ux, a*fx, fx,  f/asp*ry, f*uy, a*fy, fy,
  f/asp*rz, f*uz, a*fz, fz,  f/asp*tx, f*ty, a*tz+b, tz]);
}
function draw(){
 cv.width=innerWidth;cv.height=innerHeight;
 gl.viewport(0,0,cv.width,cv.height);
 gl.clearColor(0.063,0.063,0.078,1);gl.enable(gl.DEPTH_TEST);
 gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 const m=mat();gl.uniformMatrix4fv(uM,false,m);
 gl.enableVertexAttribArray(aP);gl.enableVertexAttribArray(aC);
 // points
 gl.uniform1f(uS,2.0);
 gl.bindBuffer(gl.ARRAY_BUFFER,ptsB);
 gl.vertexAttribPointer(aP,3,gl.FLOAT,false,0,0);
 gl.bindBuffer(gl.ARRAY_BUFFER,ptsCB);
 gl.vertexAttribPointer(aC,3,gl.FLOAT,false,0,0);
 gl.drawArrays(gl.POINTS,0,nPts);
 // trajectory (yellow line strip)
 gl.bindBuffer(gl.ARRAY_BUFFER,trajB);
 gl.vertexAttribPointer(aP,3,gl.FLOAT,false,0,0);
 gl.disableVertexAttribArray(aC);gl.vertexAttrib3f(aC,1.0,0.85,0.2);
 gl.drawArrays(gl.LINE_STRIP,0,nTraj);
 // frusta (line list, per-vertex colors)
 gl.enableVertexAttribArray(aC);
 gl.bindBuffer(gl.ARRAY_BUFFER,frB);
 gl.vertexAttribPointer(aP,3,gl.FLOAT,false,0,0);
 gl.bindBuffer(gl.ARRAY_BUFFER,frCB);
 gl.vertexAttribPointer(aC,3,gl.FLOAT,false,0,0);
 gl.drawArrays(gl.LINES,0,nFr);
 document.getElementById('hud').textContent =
  `sdv_loam_tpu  ${DATA.nKf} KFs  ${nPts} pts  ` +
  `${(DATA.pathLen).toFixed(1)} m   drag=orbit shift-drag=pan wheel=zoom`;
}
let mx=0,my=0,down=false,shift=false;
cv.onmousedown=e=>{down=true;shift=e.shiftKey;mx=e.clientX;my=e.clientY;};
window.onmouseup=()=>down=false;
window.onmousemove=e=>{if(!down)return;
 const dx=e.clientX-mx,dy=e.clientY-my;mx=e.clientX;my=e.clientY;
 if(shift){panX+=dx*0.002*dist;panY-=dy*0.002*dist;}
 else{yaw+=dx*0.008;pitch=Math.max(-1.5,Math.min(1.5,pitch+dy*0.008));}
 draw();};
cv.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);e.preventDefault();draw();};
window.onresize=draw;
draw();
</script></body></html>
"""


def _frustum_lines(T_wc: np.ndarray, scale: float) -> np.ndarray:
    """16-segment camera frustum (KeyFrameDisplay::drawCam) in world coords."""
    s = scale
    c = np.zeros(3)
    corners = np.array([[-s, -0.6 * s, s], [s, -0.6 * s, s],
                        [s, 0.6 * s, s], [-s, 0.6 * s, s]])
    segs = []
    for i in range(4):
        segs.append([c, corners[i]])
        segs.append([corners[i], corners[(i + 1) % 4]])
    pts = np.asarray(segs, np.float32).reshape(-1, 3)
    R, t = T_wc[:3, :3], T_wc[:3, 3]
    return pts @ R.T + t


class Html3DViewer(Observer):
    """Accumulates the published map and writes one standalone HTML scene."""

    def __init__(self, path: str, every: int = 0, max_points: int = 400_000):
        self.path = path
        self.every = every
        self.max_points = max_points
        self._traj: list[np.ndarray] = []
        self._pts = np.zeros((0, 3), np.float32)
        self._cols = np.zeros((0, 3), np.float32)
        self._frusta: list[np.ndarray] = []
        self._n_kf = 0

    def publish_cam_pose(self, frame_id, timestamp, T_cam_to_world):
        self._traj.append(np.asarray(T_cam_to_world, np.float32)[:3, 3].copy())

    def publish_keyframes(self, kf_ids, T_cam_to_world, points_xyz,
                          points_host):
        self._n_kf += 1
        pts = np.asarray(points_xyz, np.float32).reshape(-1, 3)
        host = np.asarray(points_host).reshape(-1)
        pal = np.asarray(_PALETTE, np.float32)
        cols = pal[host % len(pal)] if len(host) == len(pts) else \
            np.tile(np.float32([0.8, 0.8, 0.8]), (len(pts), 1))
        # the latest window snapshot REPLACES the live map (the reference
        # viewer redraws active KFs each publish); marginalized history stays
        self._pts = np.concatenate([self._pts, pts])[-self.max_points:]
        self._cols = np.concatenate([self._cols, cols])[-self.max_points:]
        self._frusta = [_frustum_lines(np.asarray(T), 0.4)
                        for T in np.asarray(T_cam_to_world)]
        if self.every and self._n_kf % self.every == 0:
            self.write()

    def write(self) -> None:
        traj = np.asarray(self._traj, np.float32).reshape(-1, 3)
        path_len = float(np.linalg.norm(np.diff(traj, axis=0),
                                        axis=1).sum()) if len(traj) > 1 else 0.0
        fr = np.concatenate(self._frusta) if self._frusta else \
            np.zeros((0, 3), np.float32)
        fr_col = np.tile(np.float32([0.95, 0.3, 0.3]), (len(fr), 1))
        span = 1.0
        if len(traj):
            span = max(1.0, float(np.ptp(traj, axis=0).max()))
        data = dict(
            pts=self._pts.ravel().tolist(),
            ptsCol=self._cols.ravel().tolist(),
            traj=traj.ravel().tolist(),
            frusta=fr.ravel().tolist(),
            frustaCol=fr_col.ravel().tolist(),
            nKf=self._n_kf, pathLen=path_len, scale=span,
        )
        with open(self.path, "w") as f:
            f.write(_HTML.replace("__DATA__", json.dumps(data)))

    def reset(self):
        self._traj.clear()
        self._pts = np.zeros((0, 3), np.float32)
        self._cols = np.zeros((0, 3), np.float32)
        self._frusta.clear()
        self._n_kf = 0

    def join(self):
        self.write()
