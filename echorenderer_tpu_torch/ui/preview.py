"""Live render dashboard (counterpart of echorenderer_tpu/ui/preview.py,
over this package's PNG encoder): the analogue of the reference's
SDL2/ImGui GUI (Echo.UserInterface/Core/EchoUI.cs:20-31 — its AreaUI set).
Each reference area has a web equivalent:

    ViewerUI     -> pan/zoom layer viewer with a linear pixel inspector
                    (wheel zoom around the cursor, drag pan, dbl-click
                    reset; hover readout fetches the exact linear RGB)
    RenderUI     -> named statistics table (/stats.json — the device-side
                    event counters published by the render loop)
    SchedulerUI  -> operations table (/operations.json — one row per
                    layer/operation with progress, samples, throughput)
    LogsUI       -> scrolling log pane (/logs.json — a ring buffer handler
                    attached to the 'echo' structured logger,
                    utils/diagnostics.py)

A render loop publishes frames/layers/progress into a `PreviewState`;
`PreviewServer` serves:
    /                 dashboard page
    /frame.png?layer= current image of a layer (tonemapped sRGB PNG)
    /layers.json      published layer names + shapes
    /pixel.json?layer=&x=&y=  exact linear RGB under the inspector
    /status.json      progress, noise, samples/sec
    /stats.json       named event counters
    /operations.json  per-operation rows
    /logs.json        recent log records

Stdlib http.server on a background thread — zero dependencies, works over
any port forward.
"""

from __future__ import annotations

import collections
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>echorenderer-tpu</title>
<style>
 body { background:#111; color:#ddd; font-family:monospace; margin:1.2em; }
 #wrap { display:flex; gap:1.5em; flex-wrap:wrap; }
 #viewport { width:min(960px,62vw); height:540px; overflow:hidden;
             border:1px solid #333; position:relative; background:#000;
             cursor:grab; }
 #frame { image-rendering:pixelated; position:absolute;
          transform-origin:0 0; user-select:none; -webkit-user-drag:none; }
 #readout { position:absolute; bottom:0; left:0; background:#000a;
            padding:2px 6px; pointer-events:none; }
 #panels { flex:1; min-width:320px; max-width:44em; }
 table { border-collapse:collapse; margin:0 0 1em 0; }
 td, th { padding:1px 1em 1px 0; text-align:left; font-weight:normal; }
 th { color:#8ab; border-bottom:1px solid #333; }
 h3 { color:#8ab; margin:0.4em 0 0.2em 0; font-size:1em; }
 #logs { height:14em; overflow-y:scroll; border:1px solid #333;
         padding:4px; white-space:pre-wrap; font-size:0.85em; }
 .warn { color:#fc6; } .error { color:#f66; }
 select { background:#222; color:#ddd; border:1px solid #444; }
</style></head>
<body>
<h2 style="margin:0 0 .4em 0">echorenderer-tpu live preview</h2>
<div>layer <select id="layer"></select>
 <span id="zoomlvl">1.0x</span> (wheel: zoom, drag: pan, dblclick: reset)</div>
<div id="wrap">
 <div id="viewport">
   <img id="frame" src="/frame.png"/>
   <div id="readout"></div>
 </div>
 <div id="panels">
   <h3>status</h3><table id="status"></table>
   <h3>operations</h3><table id="ops"></table>
   <h3>statistics</h3><table id="stats"></table>
   <h3>logs</h3><div id="logs"></div>
 </div>
</div>
<script>
 let scale = 1, tx = 0, ty = 0, drag = null, layer = 'main';
 const img = document.getElementById('frame');
 const vp = document.getElementById('viewport');
 const sel = document.getElementById('layer');
 function apply() {
   img.style.transform = `translate(${tx}px,${ty}px) scale(${scale})`;
   document.getElementById('zoomlvl').textContent = scale.toFixed(2) + 'x';
 }
 vp.addEventListener('wheel', e => {
   e.preventDefault();
   const r = vp.getBoundingClientRect();
   const mx = e.clientX - r.left, my = e.clientY - r.top;
   const f = e.deltaY < 0 ? 1.25 : 0.8;
   tx = mx - (mx - tx) * f; ty = my - (my - ty) * f;
   scale = Math.min(64, Math.max(0.1, scale * f));
   apply();
 });
 vp.addEventListener('mousedown', e => { drag = {x:e.clientX-tx, y:e.clientY-ty}; });
 window.addEventListener('mouseup', () => drag = null);
 vp.addEventListener('dblclick', () => { scale = 1; tx = ty = 0; apply(); });
 let lastPx = 0;
 vp.addEventListener('mousemove', async e => {
   if (drag) { tx = e.clientX-drag.x; ty = e.clientY-drag.y; apply(); return; }
   const r = vp.getBoundingClientRect();
   const x = Math.floor((e.clientX-r.left-tx)/scale);
   const y = Math.floor((e.clientY-r.top-ty)/scale);
   if (Date.now() - lastPx < 100) return;  lastPx = Date.now();
   try {
     const p = await (await fetch(`/pixel.json?layer=${layer}&x=${x}&y=${y}`)).json();
     document.getElementById('readout').textContent = p.ok ?
       `(${x},${y}) rgb ${p.rgb.map(v=>v.toPrecision(5)).join(' ')}` : '';
   } catch (err) {}
 });
 sel.addEventListener('change', () => { layer = sel.value; });
 function rows(obj) {
   return Object.entries(obj).map(([k,v]) =>
     `<tr><td>${k}</td><td>${typeof v==='object'?JSON.stringify(v):v}</td></tr>`).join('');
 }
 async function tick() {
   try {
     const s = await (await fetch('/status.json')).json();
     document.getElementById('status').innerHTML = rows(s);
     const st = await (await fetch('/stats.json')).json();
     document.getElementById('stats').innerHTML = rows(st);
     const ops = await (await fetch('/operations.json')).json();
     document.getElementById('ops').innerHTML = ops.length ?
       '<tr>' + Object.keys(ops[0]).map(k=>`<th>${k}</th>`).join('') + '</tr>' +
       ops.map(o=>'<tr>'+Object.values(o).map(v=>`<td>${v}</td>`).join('')+'</tr>').join('') : '';
     const lg = await (await fetch('/logs.json')).json();
     const el = document.getElementById('logs');
     const stick = el.scrollTop + el.clientHeight >= el.scrollHeight - 4;
     el.innerHTML = lg.map(l =>
       `<div class="${l.level.toLowerCase()}">${l.time} ${l.level} ${l.name} ${l.msg}</div>`).join('');
     if (stick) el.scrollTop = el.scrollHeight;
     const ls = await (await fetch('/layers.json')).json();
     const names = Object.keys(ls);
     if (names.join() !== [...sel.options].map(o=>o.value).join()) {
       sel.innerHTML = names.map(n=>`<option${n===layer?' selected':''}>${n}</option>`).join('');
     }
     if (!names.includes(layer) && names.length) layer = names[0];
     img.src = `/frame.png?layer=${layer}&t=` + Date.now();
   } catch (e) {}
   setTimeout(tick, 1000);
 }
 apply(); tick();
</script>
</body></html>"""


class _RingLogHandler(logging.Handler):
    """Keeps the last N log records for the dashboard's LogsUI pane."""

    def __init__(self, maxlen: int = 400):
        super().__init__()
        self.records: collections.deque = collections.deque(maxlen=maxlen)

    def emit(self, record):
        self.records.append(
            dict(
                time=time.strftime("%H:%M:%S", time.localtime(record.created)),
                level=record.levelname,
                name=record.name,
                msg=record.getMessage(),
            )
        )


class PreviewState:
    """Thread-safe bridge between the render loop and the HTTP server.
    Holds every published layer as LINEAR float data (the inspector
    serves exact values, like the reference ViewerUI's pixel readout)
    plus lazily-encoded display PNGs."""

    def __init__(self, capture_logs: bool = True):
        self._lock = threading.Lock()
        self._layers: dict[str, dict] = {}  # name -> {linear, png}
        self._status: dict = {"state": "idle"}
        self._stats: dict = {}
        self._ops: dict[str, dict] = {}  # name -> row (insertion-ordered)
        self._start = time.time()
        self._log_handler = None
        if capture_logs:
            self._log_handler = _RingLogHandler()
            logging.getLogger("echo").addHandler(self._log_handler)

    # -- publishing (render-loop side) --------------------------------

    def publish_frame(self, image: np.ndarray, *, layer: str = "main",
                      tonemap: bool = True):
        """Publish an (H, W, C) linear image for a layer."""
        img = np.asarray(image, dtype=np.float32)[..., :3]
        with self._lock:
            self._layers[layer] = dict(linear=img, png=None, tonemap=tonemap)

    publish_layer = publish_frame

    def publish_status(self, **kw):
        with self._lock:
            self._status.update(kw)
            self._status["uptime_s"] = round(time.time() - self._start, 1)

    def publish_stats(self, stats: dict):
        """Named event counters (the reference's EvaluatorStatistics /
        RenderUI table)."""
        with self._lock:
            self._stats.update(
                {k: (float(v) if hasattr(v, "__float__") else v)
                 for k, v in stats.items()}
            )

    def publish_operation(self, name: str, **row):
        """One SchedulerUI-style row per operation (layer render,
        composition pass, ...)."""
        with self._lock:
            self._ops.setdefault(name, {"operation": name}).update(row)

    # -- serving (HTTP side) ------------------------------------------

    def frame_png(self, layer: str = "main") -> bytes | None:
        with self._lock:
            entry = self._layers.get(layer)
            if entry is None:
                return None
            if entry["png"] is None:
                entry["png"] = self._encode(entry["linear"], entry["tonemap"])
            return entry["png"]

    @staticmethod
    def _encode(img: np.ndarray, tonemap: bool) -> bytes:
        from ..io.images import encode_png

        if tonemap:
            img = img / (1.0 + img)  # cheap reinhard for display
        return encode_png(img)

    def layers(self) -> dict:
        with self._lock:
            return {
                name: list(e["linear"].shape) for name, e in self._layers.items()
            }

    def pixel(self, layer: str, x: int, y: int) -> dict:
        """Exact linear RGB at (x, y) in image coordinates (row 0 = the
        displayed top row, matching the PNG orientation)."""
        with self._lock:
            entry = self._layers.get(layer)
            if entry is None:
                return {"ok": False}
            img = entry["linear"]
        h, w = img.shape[:2]
        if not (0 <= x < w and 0 <= y < h):
            return {"ok": False}
        # save_png writes row 0 at the bottom; the viewer indexes from top
        rgb = img[h - 1 - y, x]
        return {"ok": True, "x": x, "y": y, "rgb": [float(v) for v in rgb]}

    def status(self) -> dict:
        with self._lock:
            return dict(self._status)

    def stats(self) -> dict:
        with self._lock:
            return dict(self._stats)

    def operations(self) -> list:
        with self._lock:
            return [dict(row) for row in self._ops.values()]

    def logs(self) -> list:
        if self._log_handler is None:
            return []
        return list(self._log_handler.records)

    def close(self):
        if self._log_handler is not None:
            logging.getLogger("echo").removeHandler(self._log_handler)
            self._log_handler = None


class PreviewServer:
    """Background HTTP server bound to `state`."""

    def __init__(self, state: PreviewState, host: str = "127.0.0.1", port: int = 0):
        self.state = state
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence
                pass

            def do_GET(self):
                url = urlparse(self.path)
                q = parse_qs(url.query)
                arg = lambda k, d: q.get(k, [d])[0]
                path = url.path
                if path == "/":
                    self._send(200, "text/html", _PAGE.encode())
                elif path == "/frame.png":
                    png = outer.state.frame_png(arg("layer", "main"))
                    if png is None:
                        self._send(404, "text/plain", b"no frame yet")
                    else:
                        self._send(200, "image/png", png)
                elif path == "/layers.json":
                    self._json(outer.state.layers())
                elif path == "/pixel.json":
                    try:
                        res = outer.state.pixel(
                            arg("layer", "main"),
                            int(arg("x", "0")), int(arg("y", "0")),
                        )
                    except ValueError:
                        res = {"ok": False}
                    self._json(res)
                elif path == "/status.json":
                    self._json(outer.state.status())
                elif path == "/stats.json":
                    self._json(outer.state.stats())
                elif path == "/operations.json":
                    self._json(outer.state.operations())
                elif path == "/logs.json":
                    self._json(outer.state.logs())
                else:
                    self._send(404, "text/plain", b"not found")

            def _json(self, obj):
                self._send(200, "application/json", json.dumps(obj).encode())

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self.state.close()


def preview_progress(state: PreviewState, scene, profile):
    """A render_layer progress callback that publishes status (frames are
    published by the epoch loop via accumulator means)."""

    def cb(epoch, max_epoch, noise, layer="main", samples=0, image=None, **kw):
        status = dict(
            layer=layer, epoch=epoch, max_epoch=max_epoch,
            noise=(round(noise, 5) if np.isfinite(noise) else None),
            samples=samples,
        )
        if "tile_batch" in kw:  # spiral fill-in progress (b, n_batches)
            status["tile_batch"] = list(kw["tile_batch"])
        state.publish_status(**status)
        state.publish_operation(
            layer, epoch=f"{epoch}/{max_epoch}", samples=samples,
            noise=(round(noise, 5) if np.isfinite(noise) else "-"),
        )
        if image is not None:
            state.publish_frame(np.asarray(image), layer=layer)

    return cb
