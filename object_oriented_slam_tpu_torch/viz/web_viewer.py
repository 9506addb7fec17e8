"""Self-contained interactive HTML map viewer.

Port of ``object_oriented_slam_tpu/viz/web_viewer.py`` (numpy and JSON,
unchanged in substance), the replacement for the reference's interactive
Pangolin window (``src/core/Viewer.cpp`` + ``MapDrawer.cpp``): instead of
an OpenGL thread racing the tracker (SURVEY.md section 5), the functional
``SlamState`` is snapshotted into ONE standalone .html file — embedded
JSON + a hand-rolled WebGL renderer (no external assets; works offline in
any browser).  Feature parity with the Pangolin viewer's menus:

  * ellipsoid wireframes with instance ids and per-axis colors
    (MapDrawer.cpp:103-140)
  * camera trajectory + frusta (MapDrawer.cpp:292-401)
  * ground-plane grid (MapDrawer.cpp:153-290)
  * named point-cloud lists with per-list visibility checkboxes —
    the dynamic-menu behavior of Viewer::RefreshMenu (Viewer.cpp:241-281)
  * a history slider replaying each object's per-observation estimate
    (object_history rows, Tracking.cpp:855-896)
  * mouse orbit / pan / zoom
"""
from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np


def _quat_to_mat_np(q):
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _ellipsoid_lines(vec10, n_seg=24, n_lat=3, n_lon=4):
    """Wireframe polyline vertices [L, 2, 3] for one ellipsoid."""
    t, q, s = vec10[:3], vec10[3:7], vec10[7:10]
    R = _quat_to_mat_np(q)
    segs = []
    th = np.linspace(0, 2 * np.pi, n_seg + 1)
    # latitude rings
    for lat in np.linspace(-np.pi / 2, np.pi / 2, n_lat + 2)[1:-1]:
        ring = np.stack([np.cos(lat) * np.cos(th), np.cos(lat) * np.sin(th),
                         np.full_like(th, np.sin(lat))], 1)
        pts = ring * s @ R.T + t
        segs.extend(np.stack([pts[:-1], pts[1:]], 1))
    # longitude arcs
    for lon in np.linspace(0, np.pi, n_lon, endpoint=False):
        arc = np.stack([np.cos(th) * np.cos(lon), np.cos(th) * np.sin(lon),
                        np.sin(th)], 1)
        pts = arc * s @ R.T + t
        segs.extend(np.stack([pts[:-1], pts[1:]], 1))
    # principal axes
    for a in range(3):
        d = R[:, a] * s[a]
        segs.append(np.stack([t, t + d]))
    return np.asarray(segs, np.float32)


def _frustum_lines(pose_wc, scale=0.08):
    t, q = pose_wc[:3], pose_wc[3:7]
    R = _quat_to_mat_np(q)
    c = np.array([[0, 0, 0]], np.float32)
    corners = np.array([[-1, -0.75, 1.5], [1, -0.75, 1.5],
                        [1, 0.75, 1.5], [-1, 0.75, 1.5]]) * scale
    pts = np.concatenate([c, corners]) @ R.T + t
    idx = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    return np.asarray([[pts[i], pts[j]] for i, j in idx], np.float32)


def export_html(path: str,
                map_objects: Dict[int, np.ndarray],
                trajectory: Optional[np.ndarray] = None,
                ground_plane: Optional[np.ndarray] = None,
                cloud_lists: Optional[Dict[str, tuple]] = None,
                object_history: Optional[Dict[int, np.ndarray]] = None,
                max_points_per_cloud: int = 60000,
                title: str = "object-oriented-slam map",
                live_reload_s: float = 0.0,
                image_panels: Optional[Dict[str, str]] = None):
    """Write a standalone interactive viewer to ``path``.

    map_objects: {instance: vec10}; trajectory: [F,7] or [F,3] poses;
    ground_plane: vec4; cloud_lists: {name: (pts [N,3], colors [N,3] or
    None)}; object_history: {instance: rows [H, 11] (n_obs, flag, vec9)}.

    ``live_reload_s`` > 0 turns the page into a live view: it reloads
    itself every that many seconds while persisting the camera pose and
    layer toggles in localStorage, so a file being atomically rewritten
    during a run (``run_tum.py --viz-live``) behaves like the reference's
    Viewer-thread window (src/core/Viewer.cpp:48-175) without a display
    server.

    ``image_panels``: {name: base64 JPEG} — rendered as image panels
    beside the 3D view (the reference Viewer's RGB + colorized-depth
    image panels, src/core/Viewer.cpp:146-166).
    """
    data = {"title": title, "objects": [], "clouds": [], "frusta": [],
            "traj": [], "plane": None, "history": {},
            "reload_s": float(live_reload_s),
            "panels": [{"name": k, "b64": v}
                       for k, v in (image_panels or {}).items()]}

    for inst, v in sorted(map_objects.items()):
        v = np.asarray(v, np.float64)
        data["objects"].append({
            "id": int(inst),
            "vec10": [round(float(x), 5) for x in v],
            "lines": _ellipsoid_lines(v).reshape(-1, 3).round(4).tolist(),
        })

    if trajectory is not None and len(trajectory):
        tr = np.asarray(trajectory, np.float64)
        data["traj"] = tr[:, :3].round(4).tolist()
        if tr.shape[1] >= 7:
            step = max(1, len(tr) // 20)
            for p in tr[::step]:
                data["frusta"].append(
                    _frustum_lines(p).reshape(-1, 3).round(4).tolist())

    if ground_plane is not None:
        gp = np.asarray(ground_plane, np.float64)
        n = gp[:3] / max(np.linalg.norm(gp[:3]), 1e-9)
        d = gp[3] / max(np.linalg.norm(gp[:3]), 1e-9)
        c = -n * d
        a = np.cross(n, [1.0, 0, 0])
        if np.linalg.norm(a) < 1e-6:
            a = np.cross(n, [0, 1.0, 0])
        a /= np.linalg.norm(a)
        b = np.cross(n, a)
        lines = []
        ext, ngrid = 3.0, 13
        for u in np.linspace(-ext, ext, ngrid):
            lines.append([(c + a * u - b * ext), (c + a * u + b * ext)])
            lines.append([(c + b * u - a * ext), (c + b * u + a * ext)])
        data["plane"] = np.asarray(lines).reshape(-1, 3).round(4).tolist()

    for name, (pts, cols) in (cloud_lists or {}).items():
        pts = np.asarray(pts, np.float64).reshape(-1, 3)
        if len(pts) > max_points_per_cloud:
            sel = np.random.RandomState(0).choice(
                len(pts), max_points_per_cloud, replace=False)
            pts = pts[sel]
            cols = None if cols is None else np.asarray(cols)[sel]
        entry = {"name": name, "pts": pts.round(4).tolist()}
        if cols is not None:
            entry["cols"] = np.asarray(cols, np.float64).reshape(
                -1, 3).round(3).tolist()
        data["clouds"].append(entry)

    for inst, rows in (object_history or {}).items():
        rows = np.asarray(rows, np.float64)
        hist = []
        for r in rows:
            # vec9 (xyz rpy abc) -> wireframe via quat from rpy
            roll, pitch, yaw = r[5], r[6], r[7]
            cr, sr = np.cos(roll / 2), np.sin(roll / 2)
            cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
            cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
            q = np.array([sr * cp * cy - cr * sp * sy,
                          cr * sp * cy + sr * cp * sy,
                          cr * cp * sy - sr * sp * cy,
                          cr * cp * cy + sr * sp * sy])
            v10 = np.concatenate([r[2:5], q, r[8:11]])
            hist.append({
                "n": int(r[0]),
                "lines": _ellipsoid_lines(v10).reshape(-1, 3)
                .round(4).tolist()})
        data["history"][str(int(inst))] = hist

    html = _HTML_TEMPLATE.replace("/*__DATA__*/null",
                                  json.dumps(data, separators=(",", ":")))
    with open(path, "w") as f:
        f.write(html)
    return path


_HTML_TEMPLATE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>oslam viewer</title>
<style>
 body{margin:0;background:#101218;color:#cfd3dc;font:13px sans-serif;overflow:hidden}
 #panel{position:absolute;top:10px;left:10px;background:rgba(22,25,34,.92);
   padding:10px 14px;border-radius:8px;max-height:92vh;overflow:auto;min-width:190px}
 #panel h3{margin:2px 0 8px;font-size:14px}
 label{display:block;margin:3px 0;cursor:pointer}
 .obj{color:#9fd08f} .sld{width:160px}
 #info{position:absolute;bottom:8px;left:10px;color:#6d7486;font-size:11px}
 #frames{position:absolute;top:10px;right:10px;display:flex;
   flex-direction:column;gap:2px;max-width:324px}
 #frames img{width:320px;border:1px solid #333;border-radius:4px}
 #frames div{font-size:11px;color:#6d7486}
</style></head><body>
<canvas id="gl"></canvas>
<div id="panel"><h3 id="ttl"></h3><div id="toggles"></div><div id="hist"></div></div>
<div id="frames"></div>
<div id="info">drag: orbit &nbsp; shift-drag: pan &nbsp; wheel: zoom</div>
<script>
const DATA = /*__DATA__*/null;
if(DATA.panels&&DATA.panels.length){
 const fd=document.getElementById('frames');
 for(const p of DATA.panels){
  const t=document.createElement('div');t.textContent=p.name;
  const im=document.createElement('img');
  im.src='data:image/jpeg;base64,'+p.b64;
  fd.appendChild(t);fd.appendChild(im);}}
const cv = document.getElementById('gl');
const gl = cv.getContext('webgl');
function resize(){cv.width=innerWidth;cv.height=innerHeight;gl.viewport(0,0,cv.width,cv.height);}
addEventListener('resize',resize);resize();
const VS=`attribute vec3 p;attribute vec3 c;uniform mat4 mvp;uniform float ps;
 varying vec3 vc;void main(){gl_Position=mvp*vec4(p,1.);gl_PointSize=ps;vc=c;}`;
const FS=`precision mediump float;varying vec3 vc;void main(){gl_FragColor=vec4(vc,1.);}`;
function sh(t,s){const o=gl.createShader(t);gl.shaderSource(o,s);gl.compileShader(o);return o;}
const prog=gl.createProgram();
gl.attachShader(prog,sh(gl.VERTEX_SHADER,VS));gl.attachShader(prog,sh(gl.FRAGMENT_SHADER,FS));
gl.linkProgram(prog);gl.useProgram(prog);
const aP=gl.getAttribLocation(prog,'p'),aC=gl.getAttribLocation(prog,'c');
const uM=gl.getUniformLocation(prog,'mvp'),uPS=gl.getUniformLocation(prog,'ps');
gl.enableVertexAttribArray(aP);gl.enableVertexAttribArray(aC);
gl.enable(gl.DEPTH_TEST);

// ---- build draw items -------------------------------------------------
const items=[]; // {name, mode, buf, cbuf, n, vis, ps}
function addItem(name,pts,color,mode,ps,cols){
  const n=pts.length/3;if(!n)return null;
  const b=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,b);
  gl.bufferData(gl.ARRAY_BUFFER,new Float32Array(pts),gl.STATIC_DRAW);
  let carr;
  if(cols){carr=new Float32Array(cols);}else{
    carr=new Float32Array(n*3);
    for(let i=0;i<n;i++){carr[3*i]=color[0];carr[3*i+1]=color[1];carr[3*i+2]=color[2];}}
  const cb=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,cb);
  gl.bufferData(gl.ARRAY_BUFFER,carr,gl.STATIC_DRAW);
  const it={name,mode,buf:b,cbuf:cb,n,vis:true,ps};items.push(it);return it;}
const PAL=[[0.62,0.82,0.55],[0.96,0.62,0.35],[0.45,0.72,0.95],[0.92,0.5,0.65],
 [0.75,0.72,0.4],[0.55,0.85,0.85],[0.8,0.62,0.95],[0.95,0.85,0.4]];
const flat=a=>a.flat ? a.flat() : [].concat.apply([],a);
(DATA.objects||[]).forEach((o,i)=>{
  addItem('obj '+o.id,flat(o.lines),PAL[o.id%PAL.length],'LINES',1);});
if(DATA.traj&&DATA.traj.length>1){
  const seg=[];for(let i=0;i+1<DATA.traj.length;i++){seg.push(...DATA.traj[i],...DATA.traj[i+1]);}
  addItem('trajectory',seg,[0.95,0.3,0.3],'LINES',1);}
if(DATA.frusta&&DATA.frusta.length){
  const seg=[];DATA.frusta.forEach(f=>seg.push(...flat(f)));
  addItem('keyframes',seg,[0.5,0.45,0.75],'LINES',1);}
if(DATA.plane)addItem('ground plane',flat(DATA.plane),[0.3,0.4,0.35],'LINES',1);
(DATA.clouds||[]).forEach((c,i)=>{
  addItem(c.name,flat(c.pts),PAL[(i+3)%PAL.length],'POINTS',2,
          c.cols?flat(c.cols):null);});
// history item (rebuilt by slider)
let histItem=null, histKeys=Object.keys(DATA.history||{});
function setHist(frac){
  if(histItem){items.splice(items.indexOf(histItem),1);histItem=null;}
  if(frac>=1)return; // slider at end = live map (objects shown anyway)
  const seg=[];
  histKeys.forEach(k=>{const h=DATA.history[k];if(!h.length)return;
    const idx=Math.min(h.length-1,Math.floor(frac*h.length));
    seg.push(...flat(h[idx].lines));});
  if(seg.length){histItem=addItem('history',seg,[0.98,0.92,0.5],'LINES',1);}}
// ---- UI ---------------------------------------------------------------
document.getElementById('ttl').textContent=DATA.title;
const tog=document.getElementById('toggles');
items.forEach(it=>{const l=document.createElement('label');
  const c=document.createElement('input');c.type='checkbox';c.checked=true;
  c.onchange=()=>{it.vis=c.checked;};l.appendChild(c);
  l.appendChild(document.createTextNode(' '+it.name+(it.mode==='POINTS'?' ('+it.n+' pts)':'')));
  tog.appendChild(l);});
if(histKeys.length){const hd=document.getElementById('hist');
  hd.innerHTML='<b>history replay</b><br>';
  const s=document.createElement('input');s.type='range';s.min=0;s.max=100;s.value=100;
  s.className='sld';s.oninput=()=>{const f=s.value/100;setHist(f);
    items.forEach(it=>{if(it.name.startsWith('obj '))it.vis=(f>=1);});
    tog.querySelectorAll('input').forEach((c,i)=>{if(items[i]&&items[i].name.startsWith('obj '))c.checked=(f>=1);});};
  hd.appendChild(s);}
// ---- camera -----------------------------------------------------------
let az=-1.1,el=0.9,dist=8,ctr=[0,0,0.4];
(function(){ // fit to scene
  let mn=[1e9,1e9,1e9],mx=[-1e9,-1e9,-1e9],any=false;
  (DATA.objects||[]).forEach(o=>o.lines.forEach(p=>{any=true;
    for(let a=0;a<3;a++){mn[a]=Math.min(mn[a],p[a]);mx[a]=Math.max(mx[a],p[a]);}}));
  (DATA.traj||[]).forEach(p=>{any=true;
    for(let a=0;a<3;a++){mn[a]=Math.min(mn[a],p[a]);mx[a]=Math.max(mx[a],p[a]);}});
  if(any){ctr=[(mn[0]+mx[0])/2,(mn[1]+mx[1])/2,(mn[2]+mx[2])/2];
    dist=Math.max(2,1.6*Math.hypot(mx[0]-mn[0],mx[1]-mn[1],mx[2]-mn[2]));}})();
let drag=false,pan=false,lx=0,ly=0;
cv.onmousedown=e=>{drag=true;pan=e.shiftKey;lx=e.clientX;ly=e.clientY;};
onmouseup=()=>drag=false;
onmousemove=e=>{if(!drag)return;const dx=e.clientX-lx,dy=e.clientY-ly;lx=e.clientX;ly=e.clientY;
  if(pan){const s=dist*0.0015;
    const f=[Math.cos(az)*Math.cos(el),Math.sin(az)*Math.cos(el),Math.sin(el)];
    const r=[-Math.sin(az),Math.cos(az),0];
    const u=[-f[1]*r[2]+f[2]*r[1],-f[2]*r[0]+f[0]*r[2],-f[0]*r[1]+f[1]*r[0]];
    for(let a=0;a<3;a++)ctr[a]+=(-r[a]*dx+u[a]*dy)*s;}
  else{az-=dx*0.008;el=Math.max(-1.55,Math.min(1.55,el+dy*0.008));}};
cv.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);e.preventDefault();};
function mat(){
  const eye=[ctr[0]+dist*Math.cos(az)*Math.cos(el),
             ctr[1]+dist*Math.sin(az)*Math.cos(el),
             ctr[2]+dist*Math.sin(el)];
  const f=norm3(sub3(ctr,eye)),r=norm3(cross3(f,[0,0,1])),u=cross3(r,f);
  const V=[r[0],u[0],-f[0],0, r[1],u[1],-f[1],0, r[2],u[2],-f[2],0,
           -dot3(r,eye),-dot3(u,eye),dot3(f,eye),1];
  const a=cv.width/cv.height,fov=1.0,n=0.02,fr=500;
  const t=1/Math.tan(fov/2);
  const Pm=[t/a,0,0,0, 0,t,0,0, 0,0,(fr+n)/(n-fr),-1, 0,0,2*fr*n/(n-fr),0];
  return mul4(Pm,V);}
function sub3(a,b){return[a[0]-b[0],a[1]-b[1],a[2]-b[2]];}
function cross3(a,b){return[a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],a[0]*b[1]-a[1]*b[0]];}
function dot3(a,b){return a[0]*b[0]+a[1]*b[1]+a[2]*b[2];}
function norm3(a){const l=Math.hypot(a[0],a[1],a[2])||1;return[a[0]/l,a[1]/l,a[2]/l];}
function mul4(A,B){const o=new Array(16);
  for(let c=0;c<4;c++)for(let r=0;r<4;r++){let s=0;
    for(let k=0;k<4;k++)s+=A[k*4+r]*B[c*4+k];o[c*4+r]=s;}return o;}
function draw(){
  gl.clearColor(0.063,0.07,0.094,1);gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
  const M=mat();gl.uniformMatrix4fv(uM,false,new Float32Array(M));
  items.forEach(it=>{if(!it.vis)return;
    gl.uniform1f(uPS,it.ps*2);
    gl.bindBuffer(gl.ARRAY_BUFFER,it.buf);gl.vertexAttribPointer(aP,3,gl.FLOAT,false,0,0);
    gl.bindBuffer(gl.ARRAY_BUFFER,it.cbuf);gl.vertexAttribPointer(aC,3,gl.FLOAT,false,0,0);
    gl.drawArrays(it.mode==='POINTS'?gl.POINTS:gl.LINES,0,it.n);});
  requestAnimationFrame(draw);}
// ---- live mode: persist view across self-reloads ----------------------
if(DATA.reload_s){
  try{const s=JSON.parse(localStorage.getItem('oslam_view')||'null');
    if(s){az=s.az;el=s.el;dist=s.dist;ctr=s.ctr;
      items.forEach(it=>{if(s.vis&&(it.name in s.vis))it.vis=s.vis[it.name];});
      tog.querySelectorAll('input').forEach((c,i)=>{if(items[i])c.checked=items[i].vis;});}}catch(e){}
  setInterval(()=>{const vis={};items.forEach(it=>{vis[it.name]=it.vis;});
    localStorage.setItem('oslam_view',JSON.stringify({az,el,dist,ctr,vis}));},500);
  setTimeout(()=>location.reload(),DATA.reload_s*1000);
}
draw();
</script></body></html>
"""


def export_state_html(path: str, state, title="object-oriented-slam map",
                      live_reload_s: float = 0.0, image_panels=None):
    """Convenience: export a SlamState snapshot (system/state.py)."""
    objs = {i: state.objects[i].vec10
            for i in state.initialized_instances()}
    hist = {i: np.stack(state.objects[i].history)
            for i in state.objects if state.objects[i].history}
    traj = (np.stack(state.frames_pose_wc)
            if state.frames_pose_wc else None)
    return export_html(path, objs, trajectory=traj,
                       ground_plane=state.ground_plane,
                       cloud_lists=state.cloud_lists,
                       object_history=hist, title=title,
                       live_reload_s=live_reload_s,
                       image_panels=image_panels)


def _encode_jpeg_b64(img: np.ndarray, quality: int = 80) -> Optional[str]:
    """BGR uint8 image -> base64 JPEG (None when cv2 is unavailable)."""
    import base64
    try:
        import cv2
    except ImportError:  # pragma: no cover
        return None
    ok, buf = cv2.imencode(".jpg", img,
                           [int(cv2.IMWRITE_JPEG_QUALITY), quality])
    if not ok:
        return None
    return base64.b64encode(buf.tobytes()).decode("ascii")


def frame_panels(rgb=None, depth=None, det_mat=None, map_objects=None,
                 pose_wc=None, K=None, depth_scale: float = 5000.0):
    """Render the reference Viewer's image panels (Viewer.cpp:146-166):
    the current RGB frame with detection bboxes + projected map-ellipse
    outlines (FrameDrawer.cpp:63-115) and the false-color depth
    (FrameDrawer.cpp:36-61), as {name: base64 JPEG} for export_html."""
    from .export import draw_depth_frame, draw_frame

    panels = {}
    if rgb is not None:
        b64 = _encode_jpeg_b64(
            draw_frame(np.asarray(rgb), det_mat, map_objects, pose_wc, K))
        if b64:
            panels["frame"] = b64
    if depth is not None:
        b64 = _encode_jpeg_b64(
            draw_depth_frame(np.asarray(depth), scale=depth_scale))
        if b64:
            panels["depth"] = b64
    return panels


def export_live_snapshot(out_dir: str, state, frame_no: int,
                         reload_s: float = 1.0,
                         filename: str = "live.html",
                         image_panels=None) -> str:
    """Atomically rewrite ``<out_dir>/live.html`` with the current map.

    Safe to call mid-run at any frequency: the page in the browser
    reloads itself every ``reload_s`` seconds and keeps its camera, so
    watching the file is a live map view (Viewer-thread analogue).
    ``image_panels`` (see ``frame_panels``) adds the current RGB/depth
    frame panels beside the 3D view.
    """
    import os
    final = os.path.join(out_dir, filename)
    tmp = final + ".tmp"
    export_state_html(tmp, state, title=f"live map — frame {frame_no}",
                      live_reload_s=reload_s, image_panels=image_panels)
    os.replace(tmp, final)
    return final
