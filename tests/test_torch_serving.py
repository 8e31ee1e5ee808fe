"""The port's serving path (latentblending_tpu_torch/apps/gradio_ui.py and
apps/server.py) on a tiny-turbo engine on the CPU: the port's versions of
tests/test_gradio_router.py, tests/test_gradio_blocks.py (through
tests/gradio_stub.py) and tests/test_server.py, plus:

- preview JPEGs (encoded by the port's JPEG path, J1's RGB route and J3)
  decode, with PIL and with the port's decoder, to exactly the pixels of
  PIL's decode of `PIL.Image.save(quality=80, optimize=True)` of the same
  uint8 image, which is how the JAX router writes them (only the Huffman
  tables differ);
- parity with the JAX router: the same parameters (params_from_jax), the
  JAX noise injected, np.random.randint pinned in both: preview images
  within 1 LSB, the movie project JSON equal but for its file paths;
- malformed requests give 400: a body that is not a JSON object, wrong-typed
  or missing fields, an unknown direction. (The JAX server answers a body
  of "x" with an unhandled AttributeError, a 500 at best: its handler calls
  req.get on the string.)
- two users' previews sent concurrently both succeed.
"""
import importlib.util
import io
import itertools
import json
import os
import threading
import types
import urllib.error
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from latentblending_tpu.engine.blending import BlendingEngine as JEngine
from latentblending_tpu.runtime.holder import SDXLHolder as JHolder
from latentblending_tpu_torch.apps import gradio_ui as G
from latentblending_tpu_torch.apps import server as S
from latentblending_tpu_torch.engine.blending import BlendingEngine as TEngine
from latentblending_tpu_torch.video import jpeg, jpeg_decode
from latentblending_tpu_torch.video.writer import read_movie_frames
from tests.gradio_stub import StubGradio
from tests.torch_port_util import inject_jax_noise, port_holder_from_jax

ROOT = Path(__file__).resolve().parent.parent


def _jax_gradio_ui():
    """The JAX package's apps/gradio_ui.py, loaded from its file."""
    spec = importlib.util.spec_from_file_location("jax_apps_gradio_ui", ROOT / "apps" / "gradio_ui.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def engines():
    """The JAX tiny-turbo engine and the port's, carrying the same
    parameters and drawing the JAX noise."""
    jdh = JHolder.from_random("tiny-turbo", seed=0, dtype=jnp.float32)
    tdh = port_holder_from_jax(jdh, "tiny-turbo")
    inject_jax_noise(tdh, jdh)
    jbe, tbe = JEngine(jdh, run_benchmark=False), TEngine(tdh)
    for be in (jbe, tbe):
        be.set_branching(nmb_max_branches=2)
    return jbe, tbe


@pytest.fixture(scope="module")
def router(engines):
    return G.MultiUserRouter({"tiny-turbo": engines[1]}, nmb_preview_images=2)


def _select(idx):
    return types.SimpleNamespace(index=idx)


def _pil_decode(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def _capture_previews(monkeypatch, be) -> list:
    """Record the uint8 images compute_preview_images returns."""
    seen = []
    orig = be.compute_preview_images

    def spy(seeds):
        imgs = orig(seeds)
        seen.append([np.asarray(im) for im in imgs])
        return imgs

    monkeypatch.setattr(be, "compute_preview_images", spy)
    return seen


# ------------------------------------------------------------------ router

def test_register_and_isolated_sessions(router):
    u1 = router.register_new_user("tiny-turbo", 128, 128)
    u2 = router.register_new_user("tiny-turbo", 128, 128)
    assert u1 != u2
    assert router.sessions[u1] is not router.sessions[u2]


def test_compute_previews_and_add(router, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    u = router.register_new_user("tiny-turbo", 128, 128)
    previews = router.compute_imgs(u, "a forest", "ugly")
    assert len(previews) == 2
    router.preview_img_selected(u, _select(0), None)
    movie = router.add_image_to_video(u)
    assert movie == [previews[0]]
    s = router.sessions[u]
    assert os.path.isfile(s.fp_json)
    data = json.load(open(s.fp_json))
    assert data[0]["settings"] == "sdxl" and data[0]["width"] == 128
    assert data[1]["prompt"] == "a forest" and data[1]["negative_prompt"] == "ugly"
    assert data[1]["seed"] == s.list_seeds[0]


def test_previews_are_batched(router, tmp_path, monkeypatch):
    """N previews are ONE batched denoise, ONE J1 call and ONE J3 call for
    their JPEGs."""
    monkeypatch.chdir(tmp_path)
    u = router.register_new_user("tiny-turbo", 128, 128)
    be = router.engines["tiny-turbo"]
    calls, j1, j3 = [], [], []
    orig, fdct, huff = be.dh.run_diffusion_batched, jpeg.fdct_quant, jpeg.huffman_scan_batch

    def spy(cond, lat0, **kw):
        calls.append(int(lat0.shape[0]))
        return orig(cond, lat0, **kw)

    monkeypatch.setattr(be.dh, "run_diffusion_batched", spy)
    monkeypatch.setattr(jpeg, "fdct_quant", lambda f, q, fmt="i420": j1.append((tuple(f.shape), q, fmt)) or fdct(f, q, fmt))
    monkeypatch.setattr(jpeg, "huffman_scan_batch", lambda c: j3.append(tuple(c.shape)) or huff(c))
    previews = router.compute_imgs(u, "a cat", "")
    assert len(previews) == 2
    assert calls == [2]
    assert j1 == [((2, 128, 128, 3), 80, "rgb")] and j3 == [(2, jpeg.num_blocks(128, 128), 64)]


def test_preview_jpegs_decode_to_pils_pixels(router, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    be = router.engines["tiny-turbo"]
    seen = _capture_previews(monkeypatch, be)
    for prompt in ("a lighthouse", "a red door"):
        u = router.register_new_user("tiny-turbo", 128, 128)
        files = router.compute_imgs(u, prompt, "")
        for fp, img in zip(files, seen[-1]):
            assert img.shape == (128, 128, 3)
            data = open(fp, "rb").read()
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, "JPEG", quality=80, optimize=True)
            want = _pil_decode(buf.getvalue())
            np.testing.assert_array_equal(_pil_decode(data), want)
            np.testing.assert_array_equal(jpeg_decode.decode(data), want)


def test_router_matches_jax_router(engines, tmp_path, monkeypatch):
    """The JAX router and the port's over engines with the same parameters
    and noise, np.random.randint pinned in both: previews within 1 LSB and
    the movie project JSON equal but for the preview file paths."""
    jbe, tbe = engines
    JG = _jax_gradio_ui()
    jr = JG.MultiUserRouter({"tiny-turbo": jbe}, nmb_preview_images=2)
    tr = G.MultiUserRouter({"tiny-turbo": tbe}, nmb_preview_images=2)
    seeds = itertools.cycle([np.array([11, 12]), np.array([21, 22])])  # each router's 1st and 2nd draw
    monkeypatch.setattr(np.random, "randint", lambda *a, **k: next(seeds))
    jseen, tseen = _capture_previews(monkeypatch, jbe), _capture_previews(monkeypatch, tbe)
    jsons = []
    for r, name in ((jr, "jax"), (tr, "port")):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        u = r.register_new_user("tiny-turbo", 128, 128)
        for prompt, idx in (("a quiet harbour", 1), ("a storm at sea", 0)):
            r.compute_imgs(u, prompt, "blurry")
            r.preview_img_selected(u, _select(idx), None)
            r.add_image_to_video(u)
        data = json.load(open(r.sessions[u].fp_json))
        for e in data[1:]:
            assert os.path.isfile(e.pop("preview_image"))
        jsons.append(data)
    assert jsons[0] == jsons[1]
    assert [e["seed"] for e in jsons[1][1:]] == [12, 21]
    for j, t in zip(jseen, tseen):
        assert len(j) == len(t) == 2
        for a, b in zip(j, t):
            assert a.shape == b.shape and np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_reorder_and_delete(router, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    u = router.register_new_user("tiny-turbo", 128, 128)
    router.compute_imgs(u, "p1", "")
    router.preview_img_selected(u, _select(0), None)
    router.add_image_to_video(u)
    router.compute_imgs(u, "p2", "")
    router.preview_img_selected(u, _select(1), None)
    router.add_image_to_video(u)
    s = router.sessions[u]
    assert [e["prompt"] for e in s.data] == ["p1", "p2"]
    router.movie_img_selected(u, _select(0), None)
    router.img_movie_later(u)
    assert [e["prompt"] for e in s.data] == ["p2", "p1"]
    router.movie_img_selected(u, _select(1), None)
    router.img_movie_earlier(u)
    assert [e["prompt"] for e in s.data] == ["p1", "p2"]
    router.movie_img_selected(u, _select(0), None)
    router.img_movie_delete(u)
    assert [e["prompt"] for e in s.data] == ["p2"]
    assert router.write_json(u) == s.fp_json and json.load(open(s.fp_json))[1]["prompt"] == "p2"


def test_generate_movie(router, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    u = router.register_new_user("tiny-turbo", 128, 128)
    for p in ("sunrise", "sunset"):
        router.compute_imgs(u, p, "")
        router.preview_img_selected(u, _select(0), None)
        router.add_image_to_video(u)
    fp = router.generate_movie(u, t_per_segment=1.0)
    frames = read_movie_frames(fp)
    assert len(frames) == 30 and frames[0].shape == (128, 128, 3)


def test_user_overflow_protection(router, tmp_path, monkeypatch):
    """The oldest idle sessions are evicted past max_users (the reference's
    stub at gradio_ui.py:56-57, made functional), and their files go."""
    import time

    monkeypatch.chdir(tmp_path)
    old_cap = router.max_users
    try:
        router.max_users = len(router.sessions) + 3
        ids = [router.register_new_user("tiny-turbo", 128, 128) for _ in range(3)]
        files = router.compute_imgs(ids[0], "a cave", "")
        for k in router.sessions:
            router.sessions[k].last_active = time.time()
        router.sessions[ids[0]].last_active = time.time() - 100  # oldest
        newest = router.register_new_user("tiny-turbo", 128, 128)
        assert ids[0] not in router.sessions
        assert newest in router.sessions and ids[1] in router.sessions
        assert not any(os.path.exists(f) for f in files)
    finally:
        router.max_users = old_cap


def test_build_engines_takes_a_device(monkeypatch):
    args = types.SimpleNamespace(tiny=True, snapshots=None, device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        G.build_engines(args)
    args.device = "cpu"
    engines = G.build_engines(args)
    assert list(engines) == ["tiny-turbo"] and engines["tiny-turbo"].dh.device.type == "cpu"


def test_main_needs_gradio(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(SystemExit, match="gradio is not installed"):
        G.main(["--tiny", "--device", "cpu"])


# ------------------------------------------------------------------ the Blocks UI

@pytest.fixture(scope="module")
def ui(engines):
    mur = G.MultiUserRouter({"tiny-turbo": engines[1]}, nmb_preview_images=2)
    gr = StubGradio()
    demo = G.build_ui(gr, mur, nmb_preview_images=2)
    return types.SimpleNamespace(gr=gr, mur=mur, demo=demo)


def test_widget_surface_matches_reference(ui):
    gr = ui.gr
    assert {b.label for b in gr.of_type("Button")} == {
        "start session", "generate preview images", "add selected image to video", "delete selected image",
        "move image to earlier time", "move image to later time", "generate movie",
    }
    assert {s.label for s in gr.of_type("Slider")} == {"width", "height", "time per segment"}
    assert {t.label for t in gr.of_type("Textbox")} == {"prompt", "negative prompt", "user id (filled automatically)"}
    assert len(gr.of_type("Gallery")) == 2
    assert len(gr.of_type("Video")) == 1
    (dropdown,) = gr.of_type("Dropdown")
    assert dropdown.args[0] == ["tiny-turbo"]


def test_bindings_target_router(ui):
    gr, mur = ui.gr, ui.mur
    assert gr.bound_fn("start session").fn == mur.register_new_user
    assert gr.bound_fn("generate preview images").fn == mur.compute_imgs
    assert gr.bound_fn("add selected image to video").fn == mur.add_image_to_video
    assert gr.bound_fn("generate movie").fn == mur.generate_movie
    previews, movie_gallery = gr.of_type("Gallery")
    assert previews.select_bindings[0].fn == mur.preview_img_selected
    assert movie_gallery.select_bindings[0].fn == mur.movie_img_selected
    b = gr.bound_fn("generate preview images")
    assert [c.label for c in b.inputs] == ["user id (filled automatically)", "prompt", "negative prompt"]
    assert b.outputs == [previews]


def test_drive_recorded_bindings_end_to_end(ui, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    gr = ui.gr
    user_id = gr.bound_fn("start session").fn("tiny-turbo", 128, 128)
    assert user_id in ui.mur.sessions
    previews = gr.bound_fn("generate preview images").fn(user_id, "a forest", "ugly")
    assert len(previews) == 2
    gr.of_type("Gallery")[0].select_bindings[0].fn(user_id, types.SimpleNamespace(index=1), None)
    movie_imgs = gr.bound_fn("add selected image to video").fn(user_id)
    assert movie_imgs == [previews[1]]
    s = ui.mur.sessions[user_id]
    assert s.data[0]["prompt"] == "a forest" and s.data[0]["seed"] == s.list_seeds[1]


# ------------------------------------------------------------------ the HTTP server

@pytest.fixture(scope="module")
def server(tmp_path_factory):
    """The server over a router of its own, on a port engine that draws
    its own (torch) noise, so sessions of any size work."""
    from latentblending_tpu_torch.runtime.holder import SDXLHolder

    workdir = tmp_path_factory.mktemp("srv")
    cwd = os.getcwd()
    os.chdir(workdir)
    be = TEngine(SDXLHolder.from_random("tiny-turbo", seed=0, dtype=torch.float32, device="cpu"))
    be.set_branching(nmb_max_branches=2)
    router = G.MultiUserRouter({"tiny-turbo": be}, nmb_preview_images=2)
    httpd = S.serve(router, port=0, file_root=str(workdir), host="127.0.0.1")
    yield types.SimpleNamespace(base=f"http://127.0.0.1:{httpd.server_address[1]}", router=router)
    httpd.shutdown()
    httpd.server_close()
    os.chdir(cwd)


# requests go straight to the local server, never through a proxy
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _post(base, path, payload, raw: bytes | None = None):
    data = raw if raw is not None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data, headers={"Content-Type": "application/json"})
    with _OPENER.open(req) as r:
        return json.loads(r.read())


def _get(base, path):
    with _OPENER.open(base + path) as r:
        return r.read(), r.headers.get("Content-Type")


def _status(fn) -> int:
    with pytest.raises(urllib.error.HTTPError) as e:
        fn()
    return e.value.code


def test_health(server):
    body, _ = _get(server.base, "/health")
    data = json.loads(body)
    assert data["ok"] and data["models"] == ["tiny-turbo"]


def test_full_session_flow(server):
    base = server.base
    uid = _post(base, "/session", {"model": "tiny-turbo", "width": 128, "height": 128})["user_id"]
    r = _post(base, "/previews", {"user_id": uid, "prompt": "a forest", "negative_prompt": ""})
    assert len(r["images"]) == 2
    img_bytes, ctype = _get(base, r["images"][0])
    assert ctype == "image/jpeg" and jpeg_decode.decode(img_bytes).shape == (128, 128, 3)
    _post(base, "/select", {"user_id": uid, "index": 0})
    assert len(_post(base, "/keyframe", {"user_id": uid})["movie"]) == 1
    _post(base, "/previews", {"user_id": uid, "prompt": "a city", "negative_prompt": ""})
    _post(base, "/select", {"user_id": uid, "index": 1})
    assert len(_post(base, "/keyframe", {"user_id": uid})["movie"]) == 2
    r = _post(base, "/reorder", {"user_id": uid, "index": 0, "direction": "later"})
    assert len(r["movie"]) == 2
    assert [e["prompt"] for e in server.router.sessions[uid].data] == ["a city", "a forest"]
    r = _post(base, "/movie", {"user_id": uid, "t_per_segment": 1.0})
    vid, ctype = _get(base, r["movie_url"])
    assert ctype == "video/mp4"
    fp = Path(server.router.sessions[uid].fp_movie)
    assert fp.read_bytes() == vid and len(read_movie_frames(str(fp))) == 30
    project, _ = _get(base, r["json_url"])
    # the project file is written when a keyframe is added (as in the JAX
    # router), so it holds the order from before the reorder
    assert [e["prompt"] for e in json.loads(project)[1:]] == ["a forest", "a city"]
    assert len(_post(base, "/delete", {"user_id": uid, "index": 0})["movie"]) == 1


def test_unknown_user_404(server):
    assert _status(lambda: _post(server.base, "/previews", {"user_id": "nope", "prompt": "x"})) == 404


def test_file_escape_forbidden(server):
    assert _status(lambda: _get(server.base, "/files/../../etc/passwd")) in (400, 403, 404)


def test_unknown_model_400(server):
    assert _status(lambda: _post(server.base, "/session", {"model": "bogus"})) == 400


def test_unregistered_file_token_403(server):
    assert _status(lambda: _get(server.base, "/files/deadbeefdeadbeefdeadbeef")) == 403


def test_tokens_are_random_not_path_hashes(server):
    """A client cannot compute a token from a path: the sha256 of a served
    file's path does not resolve, and the same file registered again gets
    a fresh URL."""
    import hashlib

    base = server.base
    uid = _post(base, "/session", {"model": "tiny-turbo", "width": 128, "height": 128})["user_id"]
    url = _post(base, "/previews", {"user_id": uid, "prompt": "a beach", "negative_prompt": ""})["images"][0]
    fp = server.router.sessions[uid].list_images_preview[0]
    hash_token = hashlib.sha256(os.path.abspath(fp).encode()).hexdigest()[:24]
    assert _status(lambda: _get(base, f"/files/{hash_token}")) == 403
    r2 = _post(base, "/previews", {"user_id": uid, "prompt": "a beach", "negative_prompt": ""})
    assert url != r2["images"][0]


def test_evicted_session_tokens_stop_resolving(server):
    base = server.base
    uid = _post(base, "/session", {"model": "tiny-turbo", "width": 128, "height": 128})["user_id"]
    url = _post(base, "/previews", {"user_id": uid, "prompt": "a cave", "negative_prompt": ""})["images"][0]
    _get(base, url)  # resolves while the session lives
    server.router.sessions.pop(uid)  # what user_overflow_protection does
    assert _status(lambda: _get(base, url)) == 403


MALFORMED = [
    ("/previews", b'"x"'), ("/previews", b"[1]"), ("/previews", b"3"), ("/previews", b"null"),
    ("/previews", b"{not json"),
    ("/previews", {"user_id": 5}), ("/select", {"user_id": ["U"], "index": 0}),
    ("/select", {"index": 0}),
    ("/select", "USER"), ("/select", {"index": "0"}), ("/select", {"index": 1.5}), ("/select", {"index": True}),
    ("/select", {"index": -1}), ("/select", {"index": 7}), ("/reorder", {}), ("/delete", {"index": None}),
    ("/reorder", {"index": 0, "direction": "up"}), ("/reorder", {"index": 0, "direction": 1}),
    ("/previews", {"prompt": 5}), ("/previews", {"negative_prompt": ["x"]}),
    ("/session", {"width": "512"}), ("/session", {"height": None}), ("/session", {"width": float("inf")}),
    ("/session", {"model": ["tiny-turbo"]}),
    ("/movie", {"t_per_segment": "2"}), ("/movie", {"t_per_segment": float("nan")}), ("/movie", {"t_per_segment": 0}),
]


@pytest.mark.parametrize("path, body", MALFORMED, ids=[f"{p}-{i}" for i, (p, _) in enumerate(MALFORMED)])
def test_malformed_requests_give_400(server, path, body):
    """Every malformed request is a 400, never a 500 or a dropped
    connection. "USER" stands for a live session's user_id."""
    base = server.base
    if isinstance(body, bytes):
        assert _status(lambda: _post(base, path, None, raw=body)) == 400
        return
    uid = _post(base, "/session", {"width": 64, "height": 64})["user_id"]
    if body == "USER":
        body = {"user_id": uid}
    elif "user_id" not in body and path != "/session":
        body = {"user_id": uid, **body}
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, path, body)
    assert e.value.code == 400
    assert "error" in json.loads(e.value.read())


def test_concurrent_users_previews(server):
    """Two users' previews sent at once from two threads: both 200, with
    decodable JPEGs of their own sizes (the engine lock serializes the
    compute; the JPEG encodes run outside it)."""
    base = server.base
    users = [(_post(base, "/session", {"width": w, "height": h})["user_id"], (h, w)) for w, h in ((128, 128), (96, 64))]
    results, errors = {}, []

    def run(uid):
        try:
            results[uid] = _post(base, "/previews", {"user_id": uid, "prompt": f"user {uid}", "negative_prompt": ""})
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(u,)) for u, _ in users]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    for uid, hw in users:
        assert len(results[uid]["images"]) == 2
        for url in results[uid]["images"]:
            assert jpeg_decode.decode(_get(base, url)[0]).shape == (*hw, 3)
