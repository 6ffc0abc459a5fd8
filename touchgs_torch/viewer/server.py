"""Browser-based live viewer, the nerfstudio viewer's analogue (port of
``touchgs_tpu/viewer/server.py``).

A dependency-free threaded HTTP server that renders the current Gaussian
state on demand:

- ``GET /``            orbit-control HTML page (drag = rotate, wheel = zoom,
                       shift-drag = pan; RGB / depth / accumulation modes)
- ``GET /render?...``  one PNG frame from an orbit camera
- ``GET /state``       JSON training status (step, loss, alive count)

Rendering runs through whatever the owner provides: a live ``Trainer``
(``trainer=``) or a callable (``render_fn=``).  A live trainer's frames
render from a *snapshot* of its Gaussian parameters that ``update_status``
clones on the training thread between steps: the port's step updates the
parameters in place, so a frame that read ``trainer.state.params`` while a
step ran would see torn values.  Frames render on the HTTP server's thread,
under ``torch.no_grad()`` (grad mode is per thread), on the snapshot's
device and its default stream, the stream the training thread enqueued the
clone on; on a GPU the frame goes through the tile kernels K1 (with rows)
and K2 and never falls back to the CPU: a failed render returns a 500 with
the error's text.  A render lock serializes frames; the status dict has
its own lock, so ``/state`` and ``update_status`` never wait on a frame.
PNGs are written by ``data/png.py``.
"""
from __future__ import annotations

import contextlib
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from touchgs_torch.data.png import encode_png
from touchgs_torch.models.gaussians import FIELDS, GaussianParams


def orbit_c2w(theta: float, phi: float, radius: float,
              center=(0.0, 0.0, 0.0)) -> np.ndarray:
    """OpenGL-convention camera-to-world on an orbit around ``center``.

    ``theta`` azimuth and ``phi`` elevation in radians.  Matches the
    transforms.json convention (`data/cameras.py`: +X right, +Y up, camera
    looks down −Z).
    """
    cx, cy, cz = center
    phi = float(np.clip(phi, -1.55, 1.55))
    eye = np.array([
        cx + radius * np.cos(phi) * np.sin(theta),
        cy + radius * np.sin(phi),
        cz + radius * np.cos(phi) * np.cos(theta),
    ], np.float64)
    fwd = np.array([cx, cy, cz], np.float64) - eye
    fwd /= np.linalg.norm(fwd) + 1e-12
    up_hint = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up_hint)
    nr = np.linalg.norm(right)
    if nr < 1e-6:
        right = np.array([1.0, 0.0, 0.0])
    else:
        right /= nr
    up = np.cross(right, fwd)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = right
    c2w[:3, 1] = up
    c2w[:3, 2] = -fwd  # OpenGL: camera looks down -Z
    c2w[:3, 3] = eye
    return c2w


_PAGE = """<!doctype html><html><head><title>touchgs_torch viewer</title><style>
body{margin:0;background:#111;color:#ccc;font:13px monospace;overflow:hidden}
#hud{position:fixed;top:8px;left:8px;background:#000a;padding:6px 10px;
border-radius:4px;white-space:pre}
#img{display:block;width:100vw;height:100vh;object-fit:contain;cursor:grab}
#mode{position:fixed;top:8px;right:8px}
</style></head><body>
<img id="img"><div id="hud">connecting…</div>
<select id="mode"><option>rgb</option><option>depth</option><option>acc</option></select>
<script>
let th=0.0, ph=0.3, r=2.5, cx=0, cy=0, cz=0, drag=null, busy=false, dirty=true;
const img=document.getElementById('img'), hud=document.getElementById('hud');
const mode=document.getElementById('mode');
mode.onchange=()=>{dirty=true};
img.onmousedown=e=>{drag=[e.clientX,e.clientY,e.shiftKey];e.preventDefault()};
window.onmouseup=()=>drag=null;
window.onmousemove=e=>{if(!drag)return;
 const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
 if(drag[2]){cx-=dx*0.002*r; cy-=dy*0.002*r;}
 else{th-=dx*0.008; ph+=dy*0.008;}
 drag=[e.clientX,e.clientY,drag[2]]; dirty=true};
window.onwheel=e=>{r*=Math.exp(e.deltaY*0.001); dirty=true};
async function tick(){
 if(dirty&&!busy){busy=true;dirty=false;
  const u=`/render?theta=${th}&phi=${ph}&radius=${r}&cx=${cx}&cy=${cy}&cz=${cz}`+
          `&w=640&h=480&mode=${mode.value}&t=${Date.now()}`;
  try{const b=await(await fetch(u)).blob();img.src=URL.createObjectURL(b);}catch(e){}
  busy=false;}
 try{const s=await(await fetch('/state')).json();
  hud.textContent=`step ${s.step}  loss ${(+s.loss).toFixed(4)}  `+
   `gaussians ${s.num_alive}  ${s.training?'training':'idle'}`;}catch(e){}
 setTimeout(tick, 250);}
tick();
</script></body></html>"""


def _snapshot(params):
    """A copy of every tensor of ``params``, enqueued on the current
    stream."""
    return GaussianParams(**{f: getattr(params, f).detach().clone()
                             for f in FIELDS})


class ViewerServer:
    """Threaded HTTP viewer over a render callable or a live Trainer."""

    def __init__(self, render_fn=None, trainer=None, port: int = 7007,
                 host: str = "127.0.0.1", max_dim: int = 1024):
        if render_fn is None and trainer is None:
            raise ValueError("pass render_fn or trainer")
        self._trainer = trainer
        self._render_fn = render_fn
        self._render_lock = threading.Lock()   # serializes frame renders
        self._status_lock = threading.Lock()   # guards the status dict only
        self._params_snapshot = None           # render-safe copy (module doc)
        self._status = {"step": 0, "loss": float("nan"), "num_alive": 0,
                        "training": trainer is not None}
        self._max_dim = max_dim
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    u = urlparse(self.path)
                    if u.path == "/":
                        self._send(200, "text/html", _PAGE.encode())
                    elif u.path == "/state":
                        self._send(200, "application/json",
                                   json.dumps(viewer.status()).encode())
                    elif u.path == "/render":
                        q = {k: v[0] for k, v in parse_qs(u.query).items()}
                        png = viewer.render_png(q)
                        self._send(200, "image/png", png)
                    else:
                        self._send(404, "text/plain", b"not found")
                except BrokenPipeError:
                    pass
                except ValueError as e:  # unparseable query parameters
                    try:
                        self._send(400, "text/plain", str(e).encode())
                    except Exception:
                        pass
                except Exception as e:  # surface render errors to the page
                    try:
                        self._send(500, "text/plain", str(e).encode())
                    except Exception:
                        pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)

    # --- lifecycle ---
    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}/"

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # --- training-side hooks ---
    def update_status(self, step: int, loss: float, num_alive: int,
                      training: bool = True):
        """Called from the training thread between steps.  Publishes the
        status and a render-safe clone of the current Gaussian parameters
        (the step updates the trainer's own in place)."""
        with self._status_lock:
            self._status = {"step": int(step), "loss": float(loss),
                            "num_alive": int(num_alive), "training": training}
        if self._trainer is not None:
            # reference swap is atomic; in-flight renders keep the old copy
            self._params_snapshot = _snapshot(self._trainer.state.params)

    def status(self) -> dict:
        with self._status_lock:
            return dict(self._status)

    # --- rendering ---
    def _render(self, c2w: np.ndarray, width: int, height: int) -> dict:
        if self._render_fn is not None:
            return self._render_fn(c2w, width, height)
        from touchgs_torch.data.cameras import Camera
        from touchgs_torch.models.splatfacto import render

        tr = self._trainer
        params = self._params_snapshot
        if params is None:
            # no snapshot published yet (training hasn't started): the
            # trainer thread is idle, so its parameters are safe to copy
            params = _snapshot(tr.state.params)
            self._params_snapshot = params
        dev = params.means.device

        def scalar(v):
            return torch.tensor(np.float32(v), device=dev)

        f = 0.8 * max(width, height)
        cam = Camera(fx=scalar(f), fy=scalar(f), cx=scalar(width / 2),
                     cy=scalar(height / 2),
                     c2w=torch.as_tensor(c2w, dtype=torch.float32, device=dev),
                     width=width, height=height)
        with torch.no_grad(), contextlib.ExitStack() as on_card:
            if dev.type == "cuda":
                on_card.enter_context(torch.cuda.device(dev))
                on_card.enter_context(
                    torch.cuda.stream(torch.cuda.default_stream(dev)))
            out, _ = render(params, cam, tr.cfg.model,
                            active_sh_degree=tr.cfg.model.sh_degree)
            return {"rgb": out.rgb.cpu().numpy(),
                    "depth": out.depth.cpu().numpy(),
                    "acc": out.acc.cpu().numpy()}

    def render_png(self, q: dict) -> bytes:
        # float()/int() raise ValueError on garbage → handler returns 400
        theta = float(q.get("theta", 0.0))
        phi = float(q.get("phi", 0.3))
        radius = float(q.get("radius", 2.5))
        center = (float(q.get("cx", 0)), float(q.get("cy", 0)),
                  float(q.get("cz", 0)))
        w = max(1, min(int(q.get("w", 640)), self._max_dim))
        h = max(1, min(int(q.get("h", 480)), self._max_dim))
        mode = q.get("mode", "rgb")
        c2w = orbit_c2w(theta, phi, radius, center)
        with self._render_lock:
            out = self._render(c2w, w, h)
        return encode_png(frame_bytes(out, mode))


def frame_bytes(out: dict, mode: str) -> np.ndarray:
    """The (H, W, 3) uint8 frame of a render's host arrays in ``mode``:
    rgb clipped to [0, 1], depth stretched between its 2nd and 98th
    percentiles of the positive depths, acc clipped; then ×255 truncated."""
    if mode == "rgb":
        arr = np.clip(np.asarray(out["rgb"]), 0, 1)
    elif mode == "depth":
        d = np.asarray(out["depth"])
        lo, hi = np.percentile(d[d > 0], [2, 98]) if (d > 0).any() else (0, 1)
        arr = np.clip((d - lo) / max(hi - lo, 1e-6), 0, 1)[..., None]
        arr = np.repeat(arr, 3, axis=-1)
    else:
        arr = np.repeat(np.clip(np.asarray(out["acc"]), 0, 1)[..., None],
                        3, axis=-1)
    return (arr * 255).astype(np.uint8)
