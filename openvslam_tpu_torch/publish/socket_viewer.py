"""Live web viewer (a copy of ``openvslam_tpu/publish/socket_viewer.py``; ref
``socket_publisher/*`` + the node/three.js web app,
SURVEY.md §2.2): serve the running SLAM session to a browser.

The reference pushes protobuf frames over socket.io to an external node
server.  TPU-native inversion: a zero-dependency stdlib HTTP server runs in a
daemon thread next to the session and the browser polls it —

    /            the viewer page (canvas 3D map + live frame overlay)
    /state.json  map snapshot: kf centers, covis edges, landmarks, pose, stats
    /frame.png   current grayscale frame with keypoints (minimal PNG encoder)

No sockets library, no protobuf, no node: everything ships in this file.
"""
from __future__ import annotations

import json
import struct
import threading
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np


# ----------------------------------------------------------------------
# minimal PNG encoder (grayscale / RGB uint8) — no PIL in the image
# ----------------------------------------------------------------------
def encode_png(img: np.ndarray) -> bytes:
    if img.ndim == 2:
        color_type, arr = 0, img[:, :, None]
    else:
        color_type, arr = 2, img
    h, w, _ = arr.shape
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        c = struct.pack(">I", len(payload)) + tag + payload
        return c + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>openvslam_tpu live</title>
<style>
 body { margin:0; background:#101418; color:#cdd5dd; font:13px sans-serif; }
 #hud { position:fixed; top:8px; left:10px; z-index:2; }
 #frame { position:fixed; right:10px; bottom:10px; border:1px solid #3a4652;
          max-width:38vw; z-index:2; }
 canvas#c { display:block; }
</style></head>
<body>
<div id="hud">connecting…</div>
<div id="panel" style="position:fixed;top:28px;left:10px;z-index:2">
 <button onclick="ctl('playback')">play/pause</button>
 <button onclick="ctl('step')">step</button>
 <button id="follow" onclick="FOLLOW=!FOLLOW;this.style.opacity=FOLLOW?1:0.5">follow</button>
 <button onclick="ctl('pause')">pause threads</button>
 <button onclick="ctl('resume')">resume</button>
 <button onclick="ctl('toggle_mapping')">mapping</button>
 <button onclick="ctl('toggle_loop')">loop</button>
 <button onclick="ctl('reset')">reset</button>
 <button onclick="ctl('terminate')">terminate</button>
</div>
<img id="frame" alt="">
<canvas id="c"></canvas>
<script>
let DATA = {landmarks:[],kf_centers:[],covis_edges:[],cur:null,stats:{}};
let FOLLOW = false;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let yaw=-0.6, pitch=-0.5, dist=14, cx=0, cy=0, C=[0,0,0];
function recenter() {
  let s=[0,0,0];
  for (const p of DATA.landmarks) { s[0]+=p[0]; s[1]+=p[1]; s[2]+=p[2]; }
  const n=Math.max(DATA.landmarks.length,1);
  C=[s[0]/n, s[1]/n, s[2]/n];
}
function proj(p) {
  let x=p[0]-C[0], y=p[1]-C[1], z=p[2]-C[2];
  let x1=x*Math.cos(yaw)+z*Math.sin(yaw), z1=-x*Math.sin(yaw)+z*Math.cos(yaw);
  let y2=y*Math.cos(pitch)-z1*Math.sin(pitch), z2=y*Math.sin(pitch)+z1*Math.cos(pitch);
  const f=0.9*Math.min(cv.width,cv.height)/dist, zc=z2+dist;
  if (zc<=0.05) return null;
  return [cv.width/2+(x1+cx)*f/(zc/dist), cv.height/2+(y2+cy)*f/(zc/dist)];
}
function draw() {
  cv.width=innerWidth; cv.height=innerHeight;
  ctx.fillStyle='#101418'; ctx.fillRect(0,0,cv.width,cv.height);
  ctx.fillStyle='#5b87b0';
  for (const p of DATA.landmarks) {
    const q=proj(p); if(q) ctx.fillRect(q[0],q[1],1.6,1.6);
  }
  ctx.strokeStyle='#3a4652'; ctx.beginPath();
  for (const [a,b] of DATA.covis_edges) {
    const p=proj(DATA.kf_centers[a]), q=proj(DATA.kf_centers[b]);
    if(p&&q) { ctx.moveTo(p[0],p[1]); ctx.lineTo(q[0],q[1]); }
  }
  ctx.stroke();
  ctx.strokeStyle='#e0b74c'; ctx.lineWidth=2; ctx.beginPath();
  DATA.kf_centers.forEach((p,i)=>{
    const q=proj(p); if(!q) return;
    if(i===0) ctx.moveTo(q[0],q[1]); else ctx.lineTo(q[0],q[1]);
  });
  ctx.stroke(); ctx.lineWidth=1;
  ctx.fillStyle='#e0b74c';
  for (const p of DATA.kf_centers) {
    const q=proj(p); if(q) ctx.fillRect(q[0]-2,q[1]-2,4,4);
  }
  if (DATA.cur) {
    const q=proj(DATA.cur);
    if (q) { ctx.fillStyle='#e05c5c'; ctx.beginPath();
             ctx.arc(q[0],q[1],5,0,6.3); ctx.fill(); }
  }
}
let drag=null;
cv.onmousedown=e=>drag=[e.clientX,e.clientY,e.shiftKey];
window.onmouseup=()=>drag=null;
window.onmousemove=e=>{
  if(!drag) return;
  const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
  if(drag[2]) { cx+=dx*dist/600; cy+=dy*dist/600; }
  else { yaw+=dx*0.008; pitch+=dy*0.008; }
  drag=[e.clientX,e.clientY,drag[2]]; draw();
};
window.onwheel=e=>{ dist*=Math.exp(e.deltaY*0.001); draw(); };
window.onresize=draw;
async function ctl(cmd) { await fetch('control?cmd=' + cmd); }
async function tick() {
  try {
    const r = await fetch('state.json'); DATA = await r.json();
    if (FOLLOW && DATA.cur) C = DATA.cur.slice(); else recenter();
    draw();
    const s = DATA.stats;
    document.getElementById('hud').textContent =
      `openvslam_tpu live — ${s.state||'?'} · ${DATA.kf_centers.length} KFs · ` +
      `${s.n_landmarks||0} landmarks · frame ${s.frame_id??'-'}`;
    document.getElementById('frame').src = 'frame.png?' + (s.frame_id||0);
  } catch (e) { document.getElementById('hud').textContent = 'disconnected'; }
  setTimeout(tick, 250);
}
tick();
</script></body></html>
"""


class _Handler(BaseHTTPRequestHandler):
    viewer: "SocketViewer" = None  # set by server factory

    def do_GET(self):
        path = self.path.split("?")[0]
        if path in ("/", "/index.html"):
            self._send(200, "text/html", _PAGE.encode())
        elif path == "/state.json":
            self._send(200, "application/json",
                       json.dumps(self.viewer.state_snapshot()).encode())
        elif path == "/frame.png":
            png = self.viewer.frame_png()
            if png is None:
                self._send(404, "text/plain", b"no frame yet")
            else:
                self._send(200, "image/png", png)
        elif path == "/control":
            from urllib.parse import parse_qs, urlparse
            q = parse_qs(urlparse(self.path).query)
            cmd = (q.get("cmd") or [""])[0]
            out = self.viewer.control(cmd)
            self._send(200, "application/json", json.dumps(out).encode())
        else:
            self._send(404, "text/plain", b"not found")

    def log_message(self, *a):           # silence request logging
        pass

    def _send(self, code: int, ctype: str, body: bytes):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Cache-Control", "no-store")
        self.end_headers()
        self.wfile.write(body)


class SocketViewer:
    """Serve a running System's publishers over HTTP (live map + frame).

    Usage (mirrors ref socket_publisher lifecycle)::

        viewer = SocketViewer(system, port=7007)
        viewer.start()
        ... feed frames ...
        viewer.stop()
    """

    def __init__(self, system, host: str = "127.0.0.1", port: int = 7007,
                 max_landmarks: int = 20000):
        self.system = system
        self.host = host
        self.port = port
        self.max_landmarks = max_landmarks
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._frame_lock = threading.Lock()
        self._frame_png: Optional[bytes] = None
        self._frame_id_png = -1
        # playback control plane (ref pangolin_viewer pause/step buttons):
        # honored by feed loops via wait_if_paused()
        self.playback_paused = False
        self._step = threading.Event()
        self.terminate_requested = False

    # -- lifecycle ------------------------------------------------------
    def start(self):
        handler = type("Handler", (_Handler,), {"viewer": self})
        self._httpd = ThreadingHTTPServer((self.host, self.port), handler)
        self.port = self._httpd.server_address[1]   # resolve port=0
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="socket-viewer")
        self._thread.start()
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/"

    # -- data -----------------------------------------------------------
    def state_snapshot(self) -> dict:
        mp = self.system.map_publisher
        fp = self.system.frame_publisher
        ids, kf_poses = mp.get_keyframes()
        _, lm_pos = mp.get_landmarks()
        n_lms = len(lm_pos)
        if n_lms > self.max_landmarks:
            lm_pos = lm_pos[:: n_lms // self.max_landmarks + 1]
        centers = [(-(T[:3, :3].T @ T[:3, 3])).tolist() for T in kf_poses]
        row = {int(k): i for i, k in enumerate(ids)}
        edges = [[row[a], row[b]] for a, b in mp.get_covisibility_edges()
                 if a in row and b in row]
        snap = fp.get_current_frame()
        cur = None
        T = mp.get_current_pose()
        if T is not None:
            cur = (-(T[:3, :3].T @ T[:3, 3])).tolist()
        stats = {
            "n_landmarks": n_lms,
            "state": None if snap is None else snap["state"],
            "frame_id": None if snap is None else snap["frame_id"],
        }
        return {
            "landmarks": np.asarray(lm_pos, np.float32).round(4).tolist(),
            "kf_centers": centers,
            "covis_edges": edges,
            "cur": cur,
            "stats": stats,
        }

    def control(self, cmd: str) -> dict:
        """UI control plane (the reference viewer's panel: pause/resume,
        reset, toggle mapping/loop, terminate request)."""
        s = self.system
        ok = True
        if cmd == "pause":
            s.pause_other_threads()
        elif cmd == "resume":
            s.resume_other_threads()
        elif cmd == "reset":
            s.request_reset()
        elif cmd == "toggle_mapping":
            if s.mapping_enabled:
                s.disable_mapping_module()
            else:
                s.enable_mapping_module()
        elif cmd == "toggle_loop":
            if s.loop_detector_is_enabled():
                s.disable_loop_detector()
            else:
                s.enable_loop_detector()
        elif cmd == "terminate":
            self.terminate_requested = True
        elif cmd == "playback":
            self.playback_paused = not self.playback_paused
        elif cmd == "step":
            self.playback_paused = True
            self._step.set()
        else:
            ok = False
        return {
            "ok": ok,
            "mapping": s.mapping_enabled,
            "loop": s.loop_detector_is_enabled(),
            "playback_paused": self.playback_paused,
            "terminate": self.terminate_requested,
        }

    def wait_if_paused(self, poll: float = 0.05) -> bool:
        """Block the caller's feed loop while playback is paused; a 'step'
        lets exactly one frame through.  Returns False once terminate was
        requested (the loop should stop feeding)."""
        import time as _time
        while self.playback_paused and not self.terminate_requested:
            if self._step.is_set():
                self._step.clear()
                return True
            _time.sleep(poll)
        return not self.terminate_requested

    def frame_png(self) -> Optional[bytes]:
        snap = self.system.frame_publisher.get_current_frame()
        if snap is None or snap.get("image") is None:
            return None
        with self._frame_lock:
            if snap["frame_id"] == self._frame_id_png:
                return self._frame_png
            img = snap["image"]
            rgb = np.repeat(img[:, :, None], 3, axis=2)
            kps = snap["keypoints"].astype(int)
            tracked = snap["tracked"]
            h, w = img.shape
            for (x, y), ok in zip(kps, tracked):
                if 1 <= x < w - 1 and 1 <= y < h - 1:
                    rgb[y - 1:y + 2, x - 1:x + 2] = (
                        (80, 220, 100) if ok else (220, 150, 60))
            self._frame_png = encode_png(rgb)
            self._frame_id_png = snap["frame_id"]
            return self._frame_png
