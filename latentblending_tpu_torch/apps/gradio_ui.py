"""Multi-user Gradio web app over the port (the JAX package's
apps/gradio_ui.py), with per-user session state.

Every user gets a UserSession holding their own prompts, seeds and
keyframe list, and engine access is serialized through a lock per engine,
so two users never mutate one BlendingEngine at once (the reference's
gradio_ui.py:40-53 shares one engine with no lock).

Preview JPEGs are encoded on the engine's device by the port's JPEG
kernels (video/jpeg.encode_rgb: J1's RGB route and J3, once each for the
N previews) at quality 80, outside the engine lock; the JAX app saves
them with PIL at the same quality, so both decode to the same pixels.

    python -m latentblending_tpu_torch.apps.gradio_ui --tiny --device cpu
    python -m latentblending_tpu_torch.apps.gradio_ui --snapshots /path/to/sdxl-turbo

Needs `gradio`, imported in main() only; the router runs without it
(apps/server.py serves it over plain HTTP).
"""
from __future__ import annotations

import argparse
import datetime
import os
import tempfile
import threading
import time
import uuid

import numpy as np
import torch

from latentblending_tpu_torch.engine.blending import BlendingEngine
from latentblending_tpu_torch.engine.session import Keyframe, MovieProject, run_multi_transition
from latentblending_tpu_torch.runtime.holder import SDXLHolder
from latentblending_tpu_torch.utils import get_logger

log = get_logger(__name__)


class UserSession:
    """Per-user mutable state (reference BlendingVariableHolder,
    gradio_ui.py:93-262) — one instance per registered user."""

    def __init__(self, engine_name: str, width: int, height: int, nmb_preview_images: int = 4):
        self.engine_name = engine_name
        # unique per-session tag: two users rendering in the same minute
        # never share an output path
        self.session_tag = uuid.uuid4().hex[:8]
        self.width = width
        self.height = height
        self.nmb_preview_images = nmb_preview_images
        self.prompt = None
        self.negative_prompt = ""
        self.list_seeds: list[int] = []
        self.list_images_preview: list[str] = []
        self.idx_img_preview_selected: int | None = None
        self.idx_img_movie_selected: int | None = None
        self.data: list[dict] = []
        self.idx_movie = 0
        self.jpg_quality = 80
        self.fp_movie = ""
        self.fp_json = ""
        self.last_active = time.time()

    def touch(self):
        self.last_active = time.time()

    def init_new_movie(self):
        stamp = datetime.datetime.now().strftime("%y%m%d_%H%M")
        self.fp_movie = f"movie_{self.session_tag}_{stamp}.mp4"
        self.fp_json = f"movie_{self.session_tag}_{stamp}.json"

    def to_project(self, num_inference_steps: int) -> MovieProject:
        return MovieProject(
            keyframes=[
                Keyframe(e["prompt"], e["seed"], e.get("negative_prompt", ""), e.get("preview_image"))
                for e in self.data
            ],
            width=self.width,
            height=self.height,
            num_inference_steps=num_inference_steps,
        )


class MultiUserRouter:
    def __init__(self, engines: dict[str, BlendingEngine], nmb_preview_images: int = 4, max_users: int = 100):
        self.engines = engines
        self.locks = {name: threading.Lock() for name in engines}
        self.sessions: dict[str, UserSession] = {}
        self.nmb_preview_images = nmb_preview_images
        self.list_models = list(engines.keys())
        self.max_users = max_users
        # guards the sessions dict itself (registration and eviction run on
        # concurrent server threads; the per-engine locks guard compute)
        self._sessions_lock = threading.Lock()

    def register_new_user(self, model: str, width: int, height: int) -> str:
        with self._sessions_lock:
            self.user_overflow_protection()
            user_id = str(uuid.uuid4().hex.upper()[0:8])
            self.sessions[user_id] = UserSession(model, int(width), int(height), self.nmb_preview_images)
        return user_id

    def user_overflow_protection(self):
        """Evict the least recently active sessions beyond max_users, and
        remove their files (previews, movie, project JSON: each session's
        own, by its session tag). Callers hold _sessions_lock."""
        while len(self.sessions) >= self.max_users:
            oldest = min(self.sessions, key=lambda k: self.sessions[k].last_active)
            s = self.sessions.pop(oldest)
            for fp in s.list_images_preview + [s.fp_movie, s.fp_json]:
                if not fp:
                    continue
                try:
                    os.remove(fp)
                except OSError:
                    pass
            log.info(f"evicted idle session {oldest} (user overflow protection)")

    def _session(self, user_id: str) -> UserSession:
        """Session lookup that refreshes last_active: every user action
        counts as activity, not just engine compute."""
        s = self.sessions[user_id]
        s.touch()
        return s

    def _engine_for(self, s: UserSession) -> tuple[BlendingEngine, threading.Lock]:
        s.touch()
        return self.engines[s.engine_name], self.locks[s.engine_name]

    def compute_imgs(self, user_id: str, prompt: str, negative_prompt: str):
        """N preview images as ONE batched denoise and decode inside ONE
        lock hold; their JPEGs are encoded after it, on the engine's device
        (one J1 and one J3 call for the N images), and written to
        the temporary directory."""
        from latentblending_tpu_torch.video.jpeg import encode_rgb

        s = self._session(user_id)
        be, lock = self._engine_for(s)
        s.prompt, s.negative_prompt = prompt, negative_prompt
        seeds = [int(x) for x in np.random.randint(0, np.iinfo(np.int32).max, s.nmb_preview_images)]
        s.list_seeds, s.list_images_preview, s.idx_img_preview_selected = list(seeds), [], None
        with lock:
            be.set_dimensions((s.width, s.height))
            be.set_prompt1(prompt)
            be.set_negative_prompt(negative_prompt)
            imgs = be.compute_preview_images(seeds)
            device = be.dh.device
        frames = torch.from_numpy(np.stack([np.asarray(im) for im in imgs])).to(device)
        for data in encode_rgb(frames, quality=s.jpg_quality):
            fp = os.path.join(tempfile.gettempdir(), f"image_{uuid.uuid4()}.jpg")
            with open(fp, "wb") as f:
                f.write(data)
            s.list_images_preview.append(fp)
        return s.list_images_preview

    def preview_img_selected(self, user_id, data, button):
        self._session(user_id).idx_img_preview_selected = data.index

    def movie_img_selected(self, user_id, data, button):
        self._session(user_id).idx_img_movie_selected = data.index

    def get_list_images_movie(self, user_id):
        return [e["preview_image"] for e in self._session(user_id).data]

    def add_image_to_video(self, user_id):
        s = self._session(user_id)
        if s.prompt is None or s.idx_img_preview_selected is None:
            log.warning("no prompt set or no preview selected")
            return self.get_list_images_movie(user_id)
        if s.idx_movie == 0:
            s.init_new_movie()
        s.data.append(
            {
                "iteration": s.idx_movie,
                "seed": s.list_seeds[s.idx_img_preview_selected],
                "prompt": s.prompt,
                "negative_prompt": s.negative_prompt,
                "preview_image": s.list_images_preview[s.idx_img_preview_selected],
            }
        )
        be, _ = self._engine_for(s)
        s.to_project(be.num_inference_steps).save(s.fp_json)
        s.idx_movie += 1
        return self.get_list_images_movie(user_id)

    def write_json(self, user_id):
        """Persist the user's movie project (reference gradio_ui.py:168-173)."""
        s = self._session(user_id)
        if not s.fp_json:
            s.init_new_movie()
        be, _ = self._engine_for(s)
        s.to_project(be.num_inference_steps).save(s.fp_json)
        return s.fp_json

    def img_movie_delete(self, user_id):
        s = self._session(user_id)
        if s.idx_img_movie_selected is not None and 0 <= s.idx_img_movie_selected < len(s.data):
            del s.data[s.idx_img_movie_selected]
            s.idx_img_movie_selected = None
        return self.get_list_images_movie(user_id)

    def _swap(self, user_id, offset):
        s = self._session(user_id)
        i = s.idx_img_movie_selected
        if i is not None and 0 <= i + offset < len(s.data):
            s.data[i], s.data[i + offset] = s.data[i + offset], s.data[i]
            s.idx_img_movie_selected = None
        return self.get_list_images_movie(user_id)

    def img_movie_later(self, user_id):
        return self._swap(user_id, +1)

    def img_movie_earlier(self, user_id):
        return self._swap(user_id, -1)

    def generate_movie(self, user_id, t_per_segment=10.0, loop=False):
        """Render the session's keyframes into its movie. The engine lock is
        held for the whole render: another user's previews on the same
        engine wait, as in the JAX app."""
        s = self._session(user_id)
        be, lock = self._engine_for(s)
        with lock:
            project = s.to_project(be.num_inference_steps)
            run_multi_transition(
                be, project, s.fp_movie, duration_single_trans=float(t_per_segment),
                apply_settings=True, loop=bool(loop),
            )
        return s.fp_movie


def build_engines(args) -> dict[str, BlendingEngine]:
    """One engine per model, on args.device (the card unless "cpu" is asked
    for; "cuda" without a card raises): the tiny random-weight turbo model
    with --tiny or no snapshot, else one engine per --snapshots directory."""
    device = torch.device(getattr(args, "device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_engines: --device cuda but torch sees no CUDA device (pass --device cpu)")
    engines = {}
    if args.tiny or not args.snapshots:
        dh = SDXLHolder.from_random("tiny-turbo", dtype=torch.float32, device=device)
        engines["tiny-turbo"] = BlendingEngine(dh)
    else:
        for snap in args.snapshots:
            dh = SDXLHolder.from_pretrained(snap, device=device)
            engines[dh.spec.name] = BlendingEngine(dh)
    return engines


def build_ui(gr, mur: MultiUserRouter, nmb_preview_images: int = 4):
    """Construct the Blocks UI (reference gradio_ui.py:286-338: the same
    widgets, labels and event bindings) and return the demo object. The
    gradio module is a parameter, so tests run the construction against a
    recording stub."""
    with gr.Blocks() as demo:
        with gr.Accordion("Setup", open=True):
            with gr.Row():
                model = gr.Dropdown(mur.list_models, value=mur.list_models[0], label="model")
                width = gr.Slider(256, 2048, 512, step=128, label="width", interactive=True)
                height = gr.Slider(256, 2048, 512, step=128, label="height", interactive=True)
                user_id = gr.Textbox(label="user id (filled automatically)", interactive=False)
                b_start_session = gr.Button("start session", variant="primary")

        with gr.Accordion("Latent Blending", open=False):
            with gr.Row():
                prompt = gr.Textbox(label="prompt")
                negative_prompt = gr.Textbox(label="negative prompt")
                b_compute = gr.Button("generate preview images", variant="primary")
                b_select = gr.Button("add selected image to video", variant="primary")
            with gr.Row():
                gallery_preview = gr.Gallery(
                    show_label=False, columns=[nmb_preview_images], rows=[1],
                    object_fit="contain", height="auto", allow_preview=False, interactive=False,
                )
            with gr.Row():
                gallery_movie = gr.Gallery(
                    show_label=False, columns=[20], rows=[1], object_fit="contain",
                    height="auto", allow_preview=False, interactive=False,
                )
            with gr.Row():
                b_delete = gr.Button("delete selected image")
                b_move_earlier = gr.Button("move image to earlier time")
                b_move_later = gr.Button("move image to later time")
            with gr.Row():
                b_generate_movie = gr.Button("generate movie", variant="primary")
                t_per_segment = gr.Slider(1, 30, 10, step=0.1, label="time per segment", interactive=True)
            with gr.Row():
                movie = gr.Video()

            b_start_session.click(mur.register_new_user, inputs=[model, width, height], outputs=user_id)
            b_compute.click(mur.compute_imgs, inputs=[user_id, prompt, negative_prompt], outputs=gallery_preview)
            b_select.click(mur.add_image_to_video, user_id, gallery_movie)
            gallery_preview.select(mur.preview_img_selected, user_id, None)
            gallery_movie.select(mur.movie_img_selected, user_id, None)
            b_delete.click(mur.img_movie_delete, user_id, gallery_movie)
            b_move_earlier.click(mur.img_movie_earlier, user_id, gallery_movie)
            b_move_later.click(mur.img_movie_later, user_id, gallery_movie)
            b_generate_movie.click(mur.generate_movie, [user_id, t_per_segment], movie)

    return demo


def main(argv=None):
    from latentblending_tpu_torch.precision import disable_tf32

    parser = argparse.ArgumentParser(description="Latent Blending GUI (PyTorch/CUDA)")
    parser.add_argument("--nmb_preview_images", type=int, default=4)
    parser.add_argument("--server_name", type=str, default=None)
    parser.add_argument("--snapshots", type=str, nargs="*", default=None, help="HF snapshot dirs")
    parser.add_argument("--tiny", action="store_true", help="tiny random-weight model")
    parser.add_argument("--device", type=str, default="cuda", help="torch device (cuda, or cpu)")
    args = parser.parse_args(argv)

    try:
        import gradio as gr
    except ImportError as e:
        raise SystemExit("gradio is not installed in this environment; `pip install gradio` to use the UI "
                         "(latentblending_tpu_torch.apps.server serves the same flow over plain HTTP)") from e

    disable_tf32()
    mur = MultiUserRouter(build_engines(args), args.nmb_preview_images)
    demo = build_ui(gr, mur, args.nmb_preview_images)
    demo.launch(share=False, inbrowser=True, inline=False, server_name=args.server_name)


if __name__ == "__main__":
    main()
