"""Self-contained HTML map viewer (a copy of ``openvslam_tpu/publish/html_viewer.py``;
the socket_publisher/web-app replacement).

The reference streams protobuf over socket.io to a three.js browser app
(SURVEY.md §2.2).  In a zero-egress TPU pod that model is inverted: we export
one dependency-free HTML file with the map snapshot inlined — interactive 3D
(orbit/zoom, canvas-rendered point cloud + trajectory + covisibility edges)
with no external assets.
"""
from __future__ import annotations

import json

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>openvslam_tpu map</title>
<style>
 body {{ margin:0; background:#101418; color:#cdd5dd; font:13px sans-serif; }}
 #hud {{ position:fixed; top:8px; left:10px; }}
 canvas {{ display:block; }}
</style></head>
<body>
<div id="hud">openvslam_tpu — {n_kfs} keyframes, {n_lms} landmarks.
drag: rotate &middot; wheel: zoom &middot; shift-drag: pan</div>
<canvas id="c"></canvas>
<script>
const DATA = {data_json};
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let yaw=-0.6, pitch=-0.5, dist=14, cx=0, cy=0;
function center() {{
  let s=[0,0,0];
  for (const p of DATA.landmarks) {{ s[0]+=p[0]; s[1]+=p[1]; s[2]+=p[2]; }}
  const n=Math.max(DATA.landmarks.length,1);
  return [s[0]/n, s[1]/n, s[2]/n];
}}
const C = center();
function proj(p) {{
  let x=p[0]-C[0], y=p[1]-C[1], z=p[2]-C[2];
  let x1=x*Math.cos(yaw)+z*Math.sin(yaw), z1=-x*Math.sin(yaw)+z*Math.cos(yaw);
  let y2=y*Math.cos(pitch)-z1*Math.sin(pitch), z2=y*Math.sin(pitch)+z1*Math.cos(pitch);
  const f=0.9*Math.min(cv.width,cv.height)/dist, zc=z2+dist;
  if (zc<=0.05) return null;
  return [cv.width/2+(x1+cx)*f/(zc/dist), cv.height/2+(y2+cy)*f/(zc/dist)];
}}
function draw() {{
  cv.width=innerWidth; cv.height=innerHeight;
  ctx.fillStyle='#101418'; ctx.fillRect(0,0,cv.width,cv.height);
  ctx.fillStyle='#5b87b0';
  for (const p of DATA.landmarks) {{
    const q=proj(p); if(q) ctx.fillRect(q[0],q[1],1.6,1.6);
  }}
  ctx.strokeStyle='#3a4652'; ctx.beginPath();
  for (const [a,b] of DATA.covis_edges) {{
    const p=proj(DATA.kf_centers[a]), q=proj(DATA.kf_centers[b]);
    if(p&&q) {{ ctx.moveTo(p[0],p[1]); ctx.lineTo(q[0],q[1]); }}
  }}
  ctx.stroke();
  ctx.strokeStyle='#e0b74c'; ctx.lineWidth=2; ctx.beginPath();
  DATA.kf_centers.forEach((p,i)=>{{
    const q=proj(p); if(!q) return;
    if(i===0) ctx.moveTo(q[0],q[1]); else ctx.lineTo(q[0],q[1]);
  }});
  ctx.stroke(); ctx.lineWidth=1;
  ctx.fillStyle='#e0b74c';
  for (const p of DATA.kf_centers) {{
    const q=proj(p); if(q) ctx.fillRect(q[0]-2,q[1]-2,4,4);
  }}
}}
let drag=null;
cv.onmousedown=e=>drag=[e.clientX,e.clientY,e.shiftKey];
window.onmouseup=()=>drag=null;
window.onmousemove=e=>{{
  if(!drag) return;
  const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
  if(drag[2]) {{ cx+=dx*dist/600; cy+=dy*dist/600; }}
  else {{ yaw+=dx*0.008; pitch+=dy*0.008; }}
  drag=[e.clientX,e.clientY,drag[2]]; draw();
}};
window.onwheel=e=>{{ dist*=Math.exp(e.deltaY*0.001); draw(); }};
window.onresize=draw;
draw();
</script></body></html>
"""


def export_html(map_publisher, path: str, max_landmarks: int = 20000):
    ids, kf_poses = map_publisher.get_keyframes()
    lm_ids, lm_pos = map_publisher.get_landmarks()
    if len(lm_pos) > max_landmarks:
        step = len(lm_pos) // max_landmarks + 1
        lm_pos = lm_pos[::step]
    centers = []
    for T in kf_poses:
        c = -(T[:3, :3].T @ T[:3, 3])
        centers.append([float(c[0]), float(c[1]), float(c[2])])
    id_to_row = {int(k): i for i, k in enumerate(ids)}
    edges = [
        [id_to_row[a], id_to_row[b]]
        for a, b in map_publisher.get_covisibility_edges()
        if a in id_to_row and b in id_to_row
    ]
    data = {
        "landmarks": [[float(x) for x in p] for p in lm_pos],
        "kf_centers": centers,
        "covis_edges": edges,
    }
    html = _TEMPLATE.format(
        n_kfs=len(centers), n_lms=len(data["landmarks"]),
        data_json=json.dumps(data),
    )
    with open(path, "w") as f:
        f.write(html)
    return path
