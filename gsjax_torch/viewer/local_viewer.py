"""Local interactive viewer: browser-based real-time rendering of a model —
the counterpart of ``gsjax.viewer.local_viewer``.

The analogue of the reference's local ``SIBR_gaussianViewer_app``
(reference README.md:270-310): where SIBR is a native OpenGL application
rasterizing the trained PLY, this serves an HTML5 viewer over HTTP and
renders frames server-side through the same inference path the training
eval uses (``make_render_fn``; the ``composite_infer`` kernel on CUDA) —
so it works on headless machines and over an SSH tunnel.

Controls: drag to orbit, wheel to zoom, right-drag (or shift-drag) to pan,
double-click to recenter. A slider drives ``scaling_modifier`` exactly like
the SIBR remote viewer's wire field (reference network_gui.py:75-86).

Frames are JPEG; the page offers a fixed set of sizes (each one sizes its
pair budget once, by a probe on the model) and anything else is refused.

Renders run on the HTTP server's threads, one at a time under the render
lock. A training run that shows its live state (``python -m
gsjax_torch.train --web_viewer PORT``) updates that state in place, so it
holds the render lock for the whole of each iteration and lets the renders
queued so far run between two iterations (:meth:`LocalViewer.hold`,
:meth:`LocalViewer.between_iterations`): a frame never sees a half-applied
step, as gsjax's immutable state guarantees there.
"""

from __future__ import annotations

import contextlib
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from gsjax_torch.utils.system import resolve_device

_PAGE = """<!DOCTYPE html>
<html><head><title>gsjax_torch viewer</title><style>
body{margin:0;background:#111;color:#ccc;font:13px sans-serif;overflow:hidden}
#hud{position:fixed;top:8px;left:8px;background:#000a;padding:8px 10px;
border-radius:6px;line-height:1.7;user-select:none}
#cv{display:block;margin:0 auto;cursor:grab}
input[type=range]{vertical-align:middle;width:110px}
select{background:#222;color:#ccc;border:1px solid #444}
</style></head><body>
<img id="cv" draggable="false">
<div id="hud">
 <b>gsjax_torch</b> <span id="stats"></span><br>
 scale <input id="sc" type="range" min="1" max="200" value="100">
 <span id="scv">1.00</span><br>
 size <select id="rs">
  <option value="640x360">640&times;360</option>
  <option value="960x540" selected>960&times;540</option>
  <option value="1280x720">1280&times;720</option>
  <option value="1920x1080">1920&times;1080</option>
 </select> <span id="fps"></span><br>
 <span style="color:#777">drag orbit &middot; wheel zoom &middot;
 right-drag pan</span>
</div>
<script>
let az=0.6, el=0.35, r=7, tgt=[0,0,0], scale=1.0, W=960, H=540;
let busy=false, dirty=true, lastT=performance.now();
const img=document.getElementById('cv');
fetch('/info').then(r=>r.json()).then(j=>{
  tgt=j.center; r=j.extent*2.2||7;
  document.getElementById('stats').textContent=
    j.n_gaussians.toLocaleString()+' gaussians, it '+j.iteration;
  dirty=true;});
function eye(){return [tgt[0]+r*Math.cos(az)*Math.cos(el),
  tgt[1]+r*Math.sin(az)*Math.cos(el), tgt[2]+r*Math.sin(el)];}
async function loop(){
  if(dirty&&!busy){busy=true;dirty=false;
    const e=eye();
    const q=`/render?ex=${e[0]}&ey=${e[1]}&ez=${e[2]}&tx=${tgt[0]}`+
      `&ty=${tgt[1]}&tz=${tgt[2]}&w=${W}&h=${H}&scale=${scale}`;
    try{const rs=await fetch(q); const b=await rs.blob();
      img.src=URL.createObjectURL(b);
      const now=performance.now();
      document.getElementById('fps').textContent=
        (1000/(now-lastT)).toFixed(1)+' fps'; lastT=now;
    }catch(err){} busy=false;}
  requestAnimationFrame(loop);}
loop();
let drag=null;
img.addEventListener('mousedown',e=>{drag=[e.clientX,e.clientY,e.button,
  e.shiftKey];e.preventDefault();});
window.addEventListener('mouseup',()=>drag=null);
window.addEventListener('mousemove',e=>{if(!drag)return;
  const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
  drag[0]=e.clientX; drag[1]=e.clientY;
  if(drag[2]===2||drag[3]){ // pan in view plane
    const ey=eye(), f=[tgt[0]-ey[0],tgt[1]-ey[1],tgt[2]-ey[2]];
    const fl=Math.hypot(...f); f.forEach((v,i)=>f[i]=v/fl);
    const up=[0,0,1];
    let rt=[f[1]*up[2]-f[2]*up[1],f[2]*up[0]-f[0]*up[2],
            f[0]*up[1]-f[1]*up[0]];
    const rl=Math.hypot(...rt); rt.forEach((v,i)=>rt[i]=v/rl);
    const uv=[rt[1]*f[2]-rt[2]*f[1],rt[2]*f[0]-rt[0]*f[2],
              rt[0]*f[1]-rt[1]*f[0]];
    const s=r*0.0015;
    for(let i=0;i<3;i++) tgt[i]+=(-dx*rt[i]+dy*uv[i])*s;
  }else{az-=dx*0.008; el=Math.min(1.5,Math.max(-1.5,el+dy*0.008));}
  dirty=true;});
img.addEventListener('wheel',e=>{r*=Math.exp(e.deltaY*0.001);
  dirty=true;e.preventDefault();});
img.addEventListener('contextmenu',e=>e.preventDefault());
document.getElementById('sc').addEventListener('input',e=>{
  scale=e.target.value/100;
  document.getElementById('scv').textContent=scale.toFixed(2);dirty=true;});
document.getElementById('rs').addEventListener('change',e=>{
  [W,H]=e.target.value.split('x').map(Number);dirty=true;});
</script></body></html>"""

# resolutions the page offers — each compiles once; anything else is 403d
# so a stray request can't trigger a surprise multi-second compile
# resolutions the page offers — each sizes its budgets once; anything else
# is 403d so a stray request can't trigger a surprise budget probe
ALLOWED_SIZES = {(640, 360), (960, 540), (1280, 720), (1920, 1080)}


class LocalViewer:
    """Serve ``state`` (a GaussianState on ``device``) interactively over
    HTTP."""

    def __init__(self, state, bg, host="127.0.0.1", port=8080,
                 iteration=0, extra_sizes=(), jpeg_quality=88, device="cuda"):
        self.device = resolve_device(device)
        if state.device.type != self.device.type:
            raise ValueError(f"the state is on {state.device}, the viewer on {self.device}")
        self.state = state
        self.bg = torch.as_tensor(np.asarray(bg, np.float32), device=state.device)
        self.host, self.port = host, port
        self.iteration = iteration
        self.jpeg_quality = jpeg_quality
        self.sizes = ALLOWED_SIZES | set(extra_sizes)
        self._fns = {}
        # one render (or state read) at a time, and none while a training
        # run holds it (reentrant: a render builds its function under it)
        self._lock = threading.RLock()
        self._turns = threading.Condition()
        self._requested = self._served = 0
        self._server = None

    # -- the render lock -------------------------------------------------
    @contextlib.contextmanager
    def _turn(self):
        """Hold the render lock for one request that reads the state."""
        with self._turns:
            self._requested += 1
        try:
            with self._lock:
                yield
        finally:
            with self._turns:
                self._served += 1
                self._turns.notify_all()

    def hold(self):
        """Called by a training thread: hold renders off until
        :meth:`between_iterations` (or :meth:`release`)."""
        self._lock.acquire()

    def between_iterations(self, state, iteration):
        """Called by the training thread holding the lock, between two
        iterations: show ``state``, let every request queued so far run on
        it, then hold renders off again."""
        self.state, self.iteration = state, iteration
        with self._turns:
            queued = self._requested
        self._lock.release()
        try:
            with self._turns:
                self._turns.wait_for(lambda: self._served >= queued)
        finally:
            self._lock.acquire()

    def release(self):
        """Called by the training thread when it is done with the state."""
        self._lock.release()

    def _fn_for(self, w, h):
        # keyed on capacity too: a viewer attached to a training run
        # sees the state grow, and budgets scale with capacity
        from gsjax_torch.data.cameras import lookat_camera
        from gsjax_torch.train.loop import probe_rasterize_settings
        from gsjax_torch.train.step import TrainConfig, make_render_fn

        key = (w, h, int(self.state.capacity))
        with self._lock:
            if key not in self._fns:
                # probe budgets against the live model from synthetic
                # viewpoints at the UI's default and a closer orbit
                # distance — trained scenes keep gaussians spanning
                # hundreds of tiles, which static default budgets
                # would silently drop (darkened renders)
                st = self.scene_stats()
                c = np.asarray(st["center"])
                r = max(st["extent"], 1e-3)
                cams = [
                    lookat_camera(c + [0, -d * r, 0.3 * r], c, (0, 0, 1), 1.1, w, h)
                    for d in (2.2, 1.2)
                ]
                settings = probe_rasterize_settings(self.state, cams, w, h)
                # as_uint8: quantize on the device — a quarter of the bytes
                # cross to the host, and the host skips a full-frame pass
                # on its way to the JPEG encoder
                self._fns[key] = make_render_fn(TrainConfig(settings=settings), as_uint8=True)
            return self._fns[key]

    def scene_stats(self):
        """Live scene statistics (recomputed per /info request, so a viewer
        attached to a running training job sees growth)."""
        state = self.state
        xyz = state.params["xyz"].detach().cpu().numpy()
        act = state.active.cpu().numpy()
        pts = xyz[act] if act.any() else xyz
        center = pts.mean(axis=0).tolist()
        extent = float(
            np.percentile(np.linalg.norm(pts - np.mean(pts, 0), axis=1), 90)
        )
        return {
            "n_gaussians": int(act.sum()),
            "center": center,
            "extent": extent,
            "iteration": self.iteration,
        }

    # -- rendering -------------------------------------------------------
    def render_jpeg(self, eye, target, w, h, scale=1.0, fov_x=1.1):
        from PIL import Image

        from gsjax_torch.data.cameras import lookat_camera

        cam = lookat_camera(eye, target, (0.0, 0.0, 1.0), fov_x, w, h)
        with self._turn():
            fn = self._fn_for(w, h)
            img = fn(self.state, cam.to_render_camera(self.state.device), self.bg,
                     float(scale)).cpu().numpy()
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=self.jpeg_quality)
        return buf.getvalue()

    # -- http ------------------------------------------------------------
    def _handler(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                try:
                    if u.path == "/":
                        self._send(200, "text/html", _PAGE.encode())
                    elif u.path == "/info":
                        with viewer._turn():
                            stats = viewer.scene_stats()
                        self._send(200, "application/json", json.dumps(stats).encode())
                    elif u.path == "/render":
                        q = {k: v[0] for k, v in parse_qs(u.query).items()}
                        w = int(q.get("w", 960))
                        h = int(q.get("h", 540))
                        if (w, h) not in viewer.sizes:
                            self._send(403, "text/plain",
                                       b"resolution not in allowed set")
                            return
                        eye = [float(q.get(k, 0)) for k in ("ex", "ey", "ez")]
                        tgt = [float(q.get(k, 0)) for k in ("tx", "ty", "tz")]
                        jpg = viewer.render_jpeg(
                            eye, tgt, w, h,
                            scale=float(q.get("scale", 1.0)),
                            fov_x=float(q.get("fov", 1.1)),
                        )
                        self._send(200, "image/jpeg", jpg)
                    else:
                        self._send(404, "text/plain", b"not found")
                except BrokenPipeError:
                    pass
                except Exception as e:  # noqa: BLE001 — surface render errors to the client
                    self._send(500, "text/plain", repr(e).encode())

        return Handler

    def start(self):
        """Start serving in a background thread; returns the bound port."""
        self._server = ThreadingHTTPServer((self.host, self.port), self._handler())
        self.port = self._server.server_address[1]
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()
        return self.port

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None

    def serve_forever(self):
        self.start()
        print(f"viewer: http://{self.host}:{self.port}/  "
              f"({self.scene_stats()['n_gaussians']} gaussians)", flush=True)
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            self.stop()


def viewer_from_model(model_path, iteration=-1, device="cuda", **kw):
    """Load a trained model directory (render.py layout) into a viewer.

    Reads the saved ``point_cloud.ply`` directly — unlike :class:`Scene`
    this needs no source dataset, matching the SIBR viewer's
    "point to a model directory" usage (reference README.md:296-302)."""
    import os

    from gsjax_torch.configs import load_cfg_args
    from gsjax_torch.models.gaussians import load_gaussian_ply
    from gsjax_torch.utils.system import search_for_max_iteration

    dev = resolve_device(device)  # fail before reading anything
    saved = load_cfg_args(model_path) or {}
    white_bg = saved.get("white_background", False)
    sh_degree = saved.get("sh_degree", 3)
    if iteration == -1:
        iteration = search_for_max_iteration(os.path.join(model_path, "point_cloud"))
    state = load_gaussian_ply(
        os.path.join(model_path, "point_cloud", f"iteration_{iteration}", "point_cloud.ply"),
        max_sh_degree=sh_degree, device=dev,
    )
    bg = np.full(3, 1.0 if white_bg else 0.0, np.float32)
    return LocalViewer(state, bg, iteration=iteration or 0, device=dev, **kw)
