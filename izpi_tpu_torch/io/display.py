"""Live render preview over HTTP.

Counterpart of `izpi_tpu/io/display.py`, the analog of the reference's
SDL/Fyne display windows (internal/display/display.go, where the renderer
pushes DisplayTile rows over a channel into a local window). A headless
host's window is a browser tab: the renderer writes a progressive PNG per
sample chunk (`render(preview_path=...)`, the CLI's `--preview`), and
`PreviewServer` serves that file with a page that reloads it every second.
The standard library's http.server on one daemon thread, bound to
127.0.0.1 unless the caller names another host.
"""

from __future__ import annotations

import http.server
import os
import threading
from functools import partial

_PAGE = b"""<!doctype html><html><head><title>izpi live preview</title>
<style>body{background:#111;margin:0;display:flex;align-items:center;
justify-content:center;height:100vh}img{image-rendering:pixelated;
max-width:95vw;max-height:95vh}</style></head><body>
<img id="p" src="/preview.png">
<script>setInterval(()=>{document.getElementById('p').src=
'/preview.png?'+Date.now()},1000)</script></body></html>"""


class _Handler(http.server.BaseHTTPRequestHandler):
    def __init__(self, preview_path, *args, **kwargs):
        self.preview_path = preview_path
        super().__init__(*args, **kwargs)

    def log_message(self, *args):  # silence per-request stderr spam
        pass

    def do_GET(self):
        if self.path.startswith("/preview.png"):
            try:
                with open(self.preview_path, "rb") as f:
                    data = f.read()
            except OSError:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Cache-Control", "no-store")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        else:
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(_PAGE)))
            self.end_headers()
            self.wfile.write(_PAGE)


class PreviewServer:
    """Serve `preview_path` on localhost:`port` from a daemon thread."""

    def __init__(self, preview_path: str, port: int = 0,
                 host: str = "127.0.0.1"):
        self.preview_path = os.path.abspath(preview_path)
        handler = partial(_Handler, self.preview_path)
        self._httpd = http.server.ThreadingHTTPServer((host, port), handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)

    def start(self) -> "PreviewServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
