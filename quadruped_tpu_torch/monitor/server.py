"""Training monitor web server (stdlib only; cv2 for thumbnails).

The port's own copy of quadruped_tpu/monitor/server.py, the capability
port of the reference's FastAPI/uvicorn app (monitorserver.py): video
list pages, JSON API, progress-image endpoint and HTTP-Range MP4
streaming (206 partial content, 64 KB chunks, monitorserver.py:120-205)
on the stdlib ThreadingHTTPServer, with the same endpoints:

    GET /                     video list page         (monitorserver.py:60-70)
    GET /main                 same                    (102-117)
    GET /showimage            progress-image page     (73-78)
    GET /training_progress.png                        (81-92)
    GET /api/videos           JSON list               (95-100)
    GET /stream/<filename>    Range-aware MP4 stream  (186-205)
    GET /thumb/<filename>     first-frame JPEG thumbnail (beyond reference)

The server reads the training artifacts from disk (training_videos/*.mp4,
training_progress.png), so it runs as a separate process during training
and does no device work.

Usage: python -m quadruped_tpu_torch.monitor.server [--port 8898] [--dir .]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import threading
from http import HTTPStatus
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

CHUNK = 64 * 1024  # 64 KB chunks (monitorserver.py:139-184)

INDEX_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>Training Monitor</title>
<style>
 body {{ font-family: sans-serif; margin: 2em; background:#111; color:#eee; }}
 a {{ color: #8cf; }} li {{ margin: 0.3em 0; list-style: none; }}
 li img {{ vertical-align: middle; margin-right: 0.6em; border-radius: 4px;
           background:#000; }}
 video {{ max-width: 90%; margin-top: 1em; background:#000; }}
</style></head>
<body>
<h1>Training videos</h1>
<p><a href="/showimage">training progress plot</a> |
   <a href="/api/videos">JSON API</a></p>
<ul>
{items}
</ul>
<video id="player" controls></video>
<script>
 document.querySelectorAll('a[data-src]').forEach(a => {{
   a.addEventListener('click', e => {{
     e.preventDefault();
     const v = document.getElementById('player');
     v.src = a.dataset.src; v.play();
   }});
 }});
</script>
</body></html>
"""

SHOWIMAGE_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>Training Progress</title>
<meta http-equiv="refresh" content="30"></head>
<body style="background:#111;text-align:center">
<img src="/training_progress.png" style="max-width:95%"/>
</body></html>
"""


def list_videos(base: Path):
    vids = []
    d = base / "training_videos"
    if d.is_dir():
        for f in d.glob("*.mp4"):
            st = f.stat()
            vids.append(
                dict(name=f.name, size=st.st_size, mtime=st.st_mtime)
            )
    vids.sort(key=lambda v: v["mtime"], reverse=True)
    return vids


def parse_range_header(value: str, size: int):
    """'bytes=a-b' -> (start, end) clamped; None if unparsable
    (monitorserver.py:120-136)."""
    m = re.match(r"bytes=(\d*)-(\d*)", value or "")
    if not m:
        return None
    start = int(m.group(1)) if m.group(1) else 0
    end = int(m.group(2)) if m.group(2) else size - 1
    if start >= size:
        return None
    return start, min(end, size - 1)


class MonitorHandler(BaseHTTPRequestHandler):
    base = Path(".")

    def log_message(self, fmt, *args):  # quiet
        pass

    def _send(self, code, body: bytes, ctype="text/html; charset=utf-8",
              extra=None):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        base = self.base
        path = self.path.split("?")[0]
        if path in ("/", "/main"):
            items = "\n".join(
                f'<li><a href="#" data-src="/stream/{v["name"]}">'
                f'<img src="/thumb/{v["name"]}" loading="lazy" '
                f'alt="" width="96"/>'
                f'{v["name"]}</a> ({v["size"]//1024} KB)</li>'
                for v in list_videos(base)
            ) or "<li>(no videos yet)</li>"
            self._send(HTTPStatus.OK, INDEX_HTML.format(items=items).encode())
        elif path == "/showimage":
            self._send(HTTPStatus.OK, SHOWIMAGE_HTML.encode())
        elif path == "/training_progress.png":
            f = base / "training_progress.png"
            if f.exists():
                self._send(HTTPStatus.OK, f.read_bytes(), "image/png")
            else:
                self._send(HTTPStatus.NOT_FOUND, b"no plot yet",
                           "text/plain")
        elif path == "/api/videos":
            self._send(
                HTTPStatus.OK, json.dumps(list_videos(base)).encode(),
                "application/json",
            )
        elif path.startswith("/stream/"):
            self._stream(path[len("/stream/"):])
        elif path.startswith("/thumb/"):
            self._thumb(path[len("/thumb/"):])
        else:
            self._send(HTTPStatus.NOT_FOUND, b"not found", "text/plain")

    _THUMBS: dict = {}
    _THUMBS_LOCK = threading.Lock()

    def _thumb(self, filename: str):
        """First-frame JPEG thumbnail of a video (cached by mtime)."""
        name = os.path.basename(filename)
        f = self.base / "training_videos" / name
        if not f.is_file():
            self._send(HTTPStatus.NOT_FOUND, b"no such video", "text/plain")
            return
        key = (str(f), f.stat().st_mtime_ns)
        jpg = MonitorHandler._THUMBS.get(key)
        if jpg is None:
            try:
                import cv2

                cap = cv2.VideoCapture(str(f))
                ok, frame = cap.read()
                cap.release()
                if not ok:
                    raise ValueError("unreadable video")
                h, w = frame.shape[:2]
                tw = 192
                frame = cv2.resize(frame, (tw, max(1, h * tw // w)))
                ok, buf = cv2.imencode(".jpg", frame,
                                       [cv2.IMWRITE_JPEG_QUALITY, 70])
                if not ok:
                    raise ValueError("encode failed")
                jpg = buf.tobytes()
            except Exception:
                self._send(HTTPStatus.NOT_FOUND, b"no thumbnail",
                           "text/plain")
                return
            # evict stale mtimes of this file, bound total entries; the
            # ThreadingHTTPServer serves handlers concurrently, so cache
            # mutation is locked (two concurrent misses would double-del)
            with MonitorHandler._THUMBS_LOCK:
                for k in [
                    k for k in MonitorHandler._THUMBS if k[0] == str(f)
                ]:
                    MonitorHandler._THUMBS.pop(k, None)
                while len(MonitorHandler._THUMBS) >= 64:
                    MonitorHandler._THUMBS.pop(
                        next(iter(MonitorHandler._THUMBS))
                    )
                MonitorHandler._THUMBS[key] = jpg
        self._send(HTTPStatus.OK, jpg, "image/jpeg")

    def _stream(self, filename: str):
        # prevent path traversal
        name = os.path.basename(filename)
        f = self.base / "training_videos" / name
        if not f.is_file():
            self._send(HTTPStatus.NOT_FOUND, b"no such video", "text/plain")
            return
        size = f.stat().st_size
        rng = parse_range_header(self.headers.get("Range"), size)
        if rng is None:
            start, end, code = 0, size - 1, HTTPStatus.OK
        else:
            start, end = rng
            code = HTTPStatus.PARTIAL_CONTENT
        length = end - start + 1
        self.send_response(code)
        self.send_header("Content-Type", "video/mp4")
        self.send_header("Accept-Ranges", "bytes")
        self.send_header("Content-Length", str(length))
        if code == HTTPStatus.PARTIAL_CONTENT:
            self.send_header("Content-Range", f"bytes {start}-{end}/{size}")
        self.end_headers()
        try:
            with open(f, "rb") as fh:
                fh.seek(start)
                remaining = length
                while remaining > 0:
                    chunk = fh.read(min(CHUNK, remaining))
                    if not chunk:
                        break
                    self.wfile.write(chunk)
                    remaining -= len(chunk)
        except (BrokenPipeError, ConnectionResetError):
            pass


def serve(port: int = 8898, base: str = ".", background: bool = False,
          host: str = "127.0.0.1"):
    """Default bind is loopback (the reference binds 0.0.0.0 with no auth,
    monitorserver.py:211 — exposing artifacts to any network peer; pass
    host='0.0.0.0' explicitly to opt into that)."""
    handler = type("Handler", (MonitorHandler,), {"base": Path(base)})
    httpd = ThreadingHTTPServer((host, port), handler)
    if background:
        import threading

        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        return httpd
    print(f"monitor server on http://{host}:{port} (base {base})")
    httpd.serve_forever()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, default=8898)  # monitorserver.py:211
    p.add_argument("--dir", type=str, default=".")
    p.add_argument(
        "--host", type=str, default="127.0.0.1",
        help="bind address; use 0.0.0.0 to allow external access",
    )
    args = p.parse_args(argv)
    serve(args.port, args.dir, host=args.host)


if __name__ == "__main__":
    main()
