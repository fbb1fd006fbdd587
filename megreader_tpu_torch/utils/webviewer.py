"""A browser image viewer for headless machines, standard library only.

``imshow(name, image)`` keeps a PNG of each named image; ``serve(port)``
starts (once) an HTTP server in a daemon thread whose front page is an
auto-refreshing gallery of them, each at ``/img/<name>``; ``waitKey(ms)``
sleeps, as the cv2 call it stands in for blocks.
"""

from __future__ import annotations

import html
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

from ..data.imageio import encode_png

_images: Dict[str, bytes] = {}
_lock = threading.Lock()
_server: Optional[ThreadingHTTPServer] = None


def _encode_png(image: np.ndarray) -> bytes:
    """(H, W) grey or (H, W, 3) RGB -> PNG bytes (other dtypes cast to uint8)."""
    return encode_png(np.ascontiguousarray(image).astype(np.uint8))


def imshow(name: str, image: np.ndarray) -> None:
    with _lock:
        _images[name] = _encode_png(image)


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *args):  # quiet
        pass

    def do_GET(self):
        if self.path.startswith("/img/"):
            with _lock:
                data = _images.get(self.path[len("/img/"):])
            if data is None:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.end_headers()
            self.wfile.write(data)
            return
        with _lock:
            names = list(_images)
        body = "<html><head><meta http-equiv='refresh' content='2'></head><body>"
        for n in names:
            safe = html.escape(n)
            body += f"<div><h3>{safe}</h3><img src='/img/{safe}'/></div>"
        data = (body + "</body></html>").encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/html")
        self.end_headers()
        self.wfile.write(data)


def serve(port: int = 8087) -> int:
    """Start the gallery server once, on all interfaces; returns the port it
    bound (``port``, or the one the system chose for 0)."""
    global _server
    with _lock:
        if _server is None:
            _server = ThreadingHTTPServer(("0.0.0.0", port), _Handler)
            threading.Thread(target=_server.serve_forever, daemon=True).start()
        return _server.server_address[1]


def waitKey(ms: int = 0) -> int:
    time.sleep(max(ms, 1) / 1000.0)
    return -1
