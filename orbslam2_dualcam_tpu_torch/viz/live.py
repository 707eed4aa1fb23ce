"""Live viewer: the original's real-time window, served over HTTP.

Port of orbslam2_dualcam_tpu/viz/live.py; it draws through the port's
viz/viewer.py.  Everything it is handed is host data (numpy images, the
tracker's HostFrame, the host map, a numpy rig transform).

The original spawns a Viewer thread that owns a Pangolin 3D map window
and an OpenCV frame window and redraws them ~30x/s (Viewer::Run,
src/Viewer.cc:73-190).  A GPU server has no display, so this build
serves the same two live panels — the FrameDrawer HUD (side-by-side dual
image with tracked keypoints + state text, FrameDrawer.cc:64-161) and the
MapDrawer 3D view (points colored by cross-camera observability, KF
frusta, covisibility graph, current/reloc camera, MapDrawer.cc:78-136) —
from a background HTTP thread to any browser: open http://host:port/ and
the page polls the PNGs + a JSON status line.

Rendering is throttled (default: at most one redraw per second) and
happens inside update(), on the tracking thread, from a consistent map
snapshot — the server thread only ever hands out finished PNG bytes, so
there is no cross-thread access to the live map."""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from orbslam2_dualcam_tpu_torch.viz import viewer as _draw

_PAGE = b"""<!doctype html><html><head><title>orbslam2_dualcam_tpu_torch</title>
<style>body{background:#111;color:#ddd;font-family:monospace;margin:12px}
img{max-width:98vw;display:block;margin:8px 0;border:1px solid #333}
#status{font-size:14px;padding:4px 0}</style></head><body>
<div id="status">connecting...</div>
<img id="frame" src="/frame.png"><img id="map" src="/map.png">
<script>
setInterval(function(){
  var t = Date.now();
  document.getElementById('frame').src = '/frame.png?' + t;
  document.getElementById('map').src = '/map.png?' + t;
  fetch('/status.json?' + t).then(r => r.json()).then(function(s){
    document.getElementById('status').textContent = JSON.stringify(s);
  });
}, 1000);
</script></body></html>"""


class LiveViewer:
    """Background HTTP viewer.  port=0 picks a free port (see .port)."""

    def __init__(self, port: int = 0, min_interval_s: float = 1.0) -> None:
        self.min_interval_s = min_interval_s
        self._lock = threading.Lock()
        self._frame_png: Optional[bytes] = None
        self._map_png: Optional[bytes] = None
        self._status: dict = {"state": "STARTING"}
        self._last_render = 0.0

        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # no stdout spam
                pass

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/" or path == "/index.html":
                    self._send(200, "text/html", _PAGE)
                elif path == "/frame.png":
                    with outer._lock:
                        png = outer._frame_png
                    self._send(200 if png else 404, "image/png", png or b"")
                elif path == "/map.png":
                    with outer._lock:
                        png = outer._map_png
                    self._send(200 if png else 404, "image/png", png or b"")
                elif path == "/status.json":
                    with outer._lock:
                        body = json.dumps(outer._status).encode()
                    self._send(200, "application/json", body)
                else:
                    self._send(404, "text/plain", b"not found")

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    def update(self, images: np.ndarray, frame, state: str, m,
               rig_T_sc: np.ndarray,
               reloc_T_cw: Optional[np.ndarray] = None,
               stats: Optional[dict] = None) -> None:
        """Redraw both panels from the current frame + map (throttled).
        Called on the tracking thread, so the map snapshot is consistent
        with whatever lock the caller holds (the reference reads the map
        under mMutexMapUpdate the same way)."""
        now = time.monotonic()
        status = {"state": state, "n_keyframes": m.n_keyframes,
                  "n_points": m.n_points,
                  "tracked": (int((frame.mp_ids >= 0).sum())
                              if frame is not None and frame.mp_ids
                              is not None else 0)}
        if stats:
            status.update(stats)
        with self._lock:
            self._status = status
        if now - self._last_render < self.min_interval_s:
            return
        self._last_render = now

        frame_png = None
        if frame is not None and frame.uv is not None:
            buf = io.BytesIO()
            tracked = (frame.mp_ids >= 0 if frame.mp_ids is not None
                       else np.zeros_like(frame.valid))
            _draw.draw_frame(np.asarray(images), frame.uv, frame.valid,
                             tracked, state, buf)
            frame_png = buf.getvalue()
        buf = io.BytesIO()
        _draw.plot_map(m, rig_T_sc, buf,
                       current_T_cw=(frame.T_cw if frame is not None
                                     else None),
                       reloc_T_cw=reloc_T_cw)
        map_png = buf.getvalue()
        with self._lock:
            if frame_png is not None:
                self._frame_png = frame_png
            self._map_png = map_png

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
