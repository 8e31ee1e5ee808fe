"""Headless serving API over the port: the Gradio UI's session flow as a
JSON API on the stdlib http.server (the JAX package's apps/server.py),
reusing MultiUserRouter. Per-user sessions and per-engine locks keep the
engines safe under the threaded server.

    python -m latentblending_tpu_torch.apps.server --tiny --device cpu --port 7861
    python -m latentblending_tpu_torch.apps.server --snapshots /path/to/sdxl-turbo

Endpoints (all JSON unless noted):
  POST /session   {"model": "...", "width": W, "height": H} → {"user_id"}
  POST /previews  {"user_id", "prompt", "negative_prompt"} → {"images": [url...]}
  POST /select    {"user_id", "index"}                     → {"ok"}
  POST /keyframe  {"user_id"}                              → {"movie": [url...]}
  POST /reorder   {"user_id", "index", "direction"}        → {"movie": [url...]}
  POST /delete    {"user_id", "index"}                     → {"movie": [url...]}
  POST /movie     {"user_id", "t_per_segment": s, "loop"?}  → {"movie_url", "json_url"}
  GET  /files/<token>                                       → image/video bytes
                  (only files this server handed out resolve, under
                   random tokens; no directory is ever exposed)
  GET  /health                                              → {"ok", "models"}

A malformed request gets 400: a body that is not a JSON object, a
user_id, model, prompt or direction that is not a string (direction
"later" or "earlier"), an index that is not a non-negative int (for
/select, one of the previews), a width, height or t_per_segment that is
not a finite number. An unknown user_id gets 404, a file token that this
server did not hand out (or whose session is gone) 403.
"""
from __future__ import annotations

import argparse
import collections
import json
import math
import os
import secrets
import threading
import types
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from latentblending_tpu_torch.utils import get_logger

log = get_logger(__name__)


class BadRequest(ValueError):
    """A request the server answers with 400."""


def _field(req: dict, name: str, kind: str, default=None):
    """req[name] (or default when absent) checked against `kind`: "str",
    "index" (an int >= 0, not a bool) or "number" (a finite int or float,
    not a bool)."""
    if name not in req:
        if default is None:
            raise BadRequest(f"missing field {name!r}")
        return default
    v = req[name]
    if kind == "str":
        ok = isinstance(v, str)
    elif kind == "index":
        ok = isinstance(v, int) and not isinstance(v, bool) and v >= 0
    else:
        ok = isinstance(v, (int, float)) and not isinstance(v, bool) and math.isfinite(v)
    if not ok:
        want = {"str": "a string", "index": "a non-negative integer", "number": "a finite number"}[kind]
        raise BadRequest(f"field {name!r} must be {want}, got {v!r}")
    return v


def make_handler(router, file_root: str, max_tokens_per_user: int = 256):
    # Only files this server handed out are servable: _file_url registers
    # the absolute path under a random token (a path hash could be computed
    # by a client), and GET /files/ resolves the tokens of live sessions
    # only; at most max_tokens_per_user per user, oldest dropped first.
    served: dict[str, tuple[str, str]] = {}  # token -> (user_id, abspath)
    user_tokens: dict[str, collections.deque] = {}
    served_lock = threading.Lock()

    def _register(fp: str, uid: str) -> str:
        with served_lock:
            # drop the registrations of evicted sessions
            for u in [u for u in user_tokens if u not in router.sessions]:
                for tok in user_tokens.pop(u):
                    served.pop(tok, None)
            token = secrets.token_urlsafe(18)
            served[token] = (uid, os.path.abspath(fp))
            q = user_tokens.setdefault(uid, collections.deque())
            q.append(token)
            while len(q) > max_tokens_per_user:
                served.pop(q.popleft(), None)
        return token

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _file_url(self, fp: str, uid: str) -> str:
            return f"/files/{_register(fp, uid)}"

        def _urls(self, fps, uid: str) -> list[str]:
            return [self._file_url(f, uid) for f in fps]

        def do_GET(self):
            path = urllib.parse.urlparse(self.path).path
            if path == "/health":
                return self._json(200, {"ok": True, "models": router.list_models})
            if path.startswith("/files/"):
                token = urllib.parse.unquote(path[len("/files/"):])
                with served_lock:
                    entry = served.get(token)
                if entry is None or entry[0] not in router.sessions:
                    return self._json(403, {"error": "forbidden"})
                fp = entry[1]
                if not os.path.isfile(fp):
                    return self._json(404, {"error": "not found"})
                ctype = "video/mp4" if fp.endswith(".mp4") else "image/jpeg"
                with open(fp, "rb") as f:
                    data = f.read()
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            return self._json(404, {"error": "not found"})

        def do_POST(self):
            path = urllib.parse.urlparse(self.path).path
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
            except ValueError:
                return self._json(400, {"error": "bad json"})
            try:
                return self._post(path, req)
            except (BadRequest, KeyError, ValueError, AssertionError) as e:
                return self._json(400, {"error": str(e)})
            except Exception as e:  # a fault of the server, not of the request
                log.exception(f"POST {path} failed")
                return self._json(500, {"error": f"{type(e).__name__}: {e}"})

        def _post(self, path: str, req):
            if not isinstance(req, dict):
                raise BadRequest(f"the body must be a JSON object, got {type(req).__name__}")
            if path == "/session":
                model = _field(req, "model", "str", router.list_models[0])
                if model not in router.engines:
                    return self._json(400, {"error": f"unknown model {model!r}", "models": router.list_models})
                # bound dimensions like the Gradio UI sliders (2048 max)
                w = min(max(int(_field(req, "width", "number", 512)), 64), 2048)
                h = min(max(int(_field(req, "height", "number", 512)), 64), 2048)
                return self._json(200, {"user_id": router.register_new_user(model, w, h)})
            uid = _field(req, "user_id", "str")
            if uid not in router.sessions:
                return self._json(404, {"error": "unknown user_id"})
            if path == "/previews":
                imgs = router.compute_imgs(uid, _field(req, "prompt", "str", ""),
                                           _field(req, "negative_prompt", "str", ""))
                return self._json(200, {"images": self._urls(imgs, uid)})
            if path == "/select":
                index = _field(req, "index", "index")
                if index >= len(router.sessions[uid].list_seeds):
                    raise BadRequest(f"index {index} is not one of the session's previews")
                router.preview_img_selected(uid, types.SimpleNamespace(index=index), None)
                return self._json(200, {"ok": True})
            if path == "/keyframe":
                return self._json(200, {"movie": self._urls(router.add_image_to_video(uid), uid)})
            if path == "/reorder":
                index = _field(req, "index", "index")
                direction = _field(req, "direction", "str", "later")
                if direction not in ("later", "earlier"):
                    raise BadRequest(f"direction must be 'later' or 'earlier', got {direction!r}")
                router.movie_img_selected(uid, types.SimpleNamespace(index=index), None)
                fn = router.img_movie_later if direction == "later" else router.img_movie_earlier
                return self._json(200, {"movie": self._urls(fn(uid), uid)})
            if path == "/delete":
                router.movie_img_selected(uid, types.SimpleNamespace(index=_field(req, "index", "index")), None)
                return self._json(200, {"movie": self._urls(router.img_movie_delete(uid), uid)})
            if path == "/movie":
                t_seg = _field(req, "t_per_segment", "number", 10.0)
                if t_seg <= 0:
                    raise BadRequest(f"t_per_segment must be positive, got {t_seg!r}")
                fp_movie = router.generate_movie(uid, float(t_seg), loop=bool(req.get("loop", False)))
                s = router.sessions[uid]
                return self._json(200, {
                    "movie_url": self._file_url(fp_movie, uid),
                    "json_url": self._file_url(s.fp_json, uid) if os.path.isfile(s.fp_json) else None,
                })
            return self._json(404, {"error": "not found"})

    return Handler


def serve(router, port: int = 7861, file_root: str | None = None, host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """Start the server on a daemon thread and return it (.shutdown() stops
    it; server_address[1] is the port, chosen by the OS for port=0).
    file_root is informational only: /files/ serves exclusively the
    token-registered files the API handed out."""
    file_root = file_root or os.getcwd()
    httpd = ThreadingHTTPServer((host, port), make_handler(router, file_root))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd


def main(argv=None):
    from latentblending_tpu_torch.apps.gradio_ui import MultiUserRouter, build_engines
    from latentblending_tpu_torch.precision import disable_tf32

    p = argparse.ArgumentParser()
    p.add_argument("--tiny", action="store_true", help="tiny random-weight model (smoke)")
    p.add_argument("--snapshots", nargs="*", default=[], help="HF snapshot dirs to serve")
    p.add_argument("--device", type=str, default="cuda", help="torch device (cuda, or cpu)")
    p.add_argument("--host", type=str, default="0.0.0.0")
    p.add_argument("--port", type=int, default=7861)
    p.add_argument("--nmb_preview_images", type=int, default=4)
    args = p.parse_args(argv)
    disable_tf32()
    router = MultiUserRouter(build_engines(args), nmb_preview_images=args.nmb_preview_images)
    httpd = serve(router, port=args.port, host=args.host)
    print(f"serving on {args.host}:{httpd.server_address[1]} (models: {router.list_models})", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        httpd.shutdown()


if __name__ == "__main__":
    main()
