"""Movie-project sessions: the JSON format the reference's Gradio UI saves
(reference gradio_ui.py:168-189) and example_multi_trans_json.py replays
(:24-45) — kept schema-compatible so existing project files work — plus the
chained multi-transition runner both the UI (:235-260) and
example_multi_trans.py (:39-62) share.

Counterpart of latentblending_tpu/engine/session.py: the same JSON, and
run_multi_transition streaming every part into one MovieSaver on the
engine's device (the port's JPEG kernels encode the samples).
"""
from __future__ import annotations

import dataclasses
import json
import os

from latentblending_tpu_torch import profiling
from latentblending_tpu_torch.utils import get_logger

log = get_logger(__name__)


@dataclasses.dataclass
class Keyframe:
    prompt: str
    seed: int = 420
    negative_prompt: str = ""
    preview_image: str | None = None


@dataclasses.dataclass
class MovieProject:
    keyframes: list[Keyframe]
    width: int = 512
    height: int = 512
    num_inference_steps: int = 4

    def save(self, fp_json: str):
        """Write the project as the reference UI's JSON. Under a process
        group global rank 0 writes it and the other ranks wait for it
        (parallel/mesh.write_on_rank0)."""
        from latentblending_tpu_torch.parallel.mesh import write_on_rank0

        write_on_rank0(self._write, fp_json)

    def _write(self, fp_json: str):
        data = [
            {
                "settings": "sdxl",
                "width": self.width,
                "height": self.height,
                "num_inference_steps": self.num_inference_steps,
            }
        ]
        for i, kf in enumerate(self.keyframes):
            entry = {
                "iteration": i,
                "seed": int(kf.seed),
                "prompt": kf.prompt,
                "negative_prompt": kf.negative_prompt,
            }
            if kf.preview_image:
                entry["preview_image"] = kf.preview_image
            data.append(entry)
        with open(fp_json, "w") as f:
            json.dump(data, f, indent=4)

    @classmethod
    def load(cls, fp_json: str) -> "MovieProject":
        with open(fp_json) as f:
            data = json.load(f)
        settings = data[0]
        keyframes = [
            Keyframe(
                prompt=e["prompt"],
                seed=int(e.get("seed", 420)),
                negative_prompt=e.get("negative_prompt", ""),
                preview_image=e.get("preview_image"),
            )
            for e in data[1:]
        ]
        return cls(
            keyframes=keyframes,
            width=int(settings.get("width", 512)),
            height=int(settings.get("height", 512)),
            num_inference_steps=int(settings.get("num_inference_steps", 4)),
        )


def _write_part(imgs: list, ms, target: int, errs: list, trace=None):
    """Resolve + lerp + append one transition's frames to the SHARED movie
    writer. Runs on a background thread in the overlapped chained pipeline:
    the encoder's launches and host copies interleave with the NEXT
    transition's, and waits on the device release the GIL. Its spans land
    in `trace`, the span tree of the transition it writes."""
    try:
        from latentblending_tpu_torch.engine.blending import resolve_image
        from latentblending_tpu_torch.video.writer import write_frames_interp

        batch_cache: dict = {}
        with profiling.recording(trace):
            write_frames_interp(ms, imgs, target, resolve=lambda im: resolve_image(im, batch_cache))
        log.info(f"wrote {target} frames ({ms.nmb_frames} total)")
    except BaseException as e:  # re-raised on the main thread after join
        errs.append(e)


def run_multi_transition(
    be,
    project: MovieProject,
    fp_movie: str,
    duration_single_trans: float = 10.0,
    fps: int = 30,
    apply_settings: bool = True,
    workdir: str | None = None,
    overlap_write: bool | None = None,
    loop: bool = False,
) -> str:
    """Chain K keyframes into K-1 transitions with latent recycling
    (reference example_multi_trans.py:39-62 / gradio_ui.py:235-260).

    loop=True appends a final transition from the last keyframe back to
    the first, so the movie tiles seamlessly (K transitions; the last
    frame's prompt/seed equal the first keyframe's). Beyond-reference
    convenience — the reference leaves loop closure to the user.

    All transitions stream into ONE movie writer — unlike the reference's
    per-part files + concat (example_multi_trans.py:58-62), which without
    an ffmpeg binary would cost a full decode+re-encode of every frame
    (and a generation loss) at the concat step.

    overlap_write (default on; LB_OVERLAP_PARTS=0 disables): part i's
    frame encode runs on a background thread while part i+1's transition
    computes on the device — a depth-1 pipeline bounded to one part in
    flight. The reference serializes transition → write → next transition
    (example_multi_trans.py:52-58).

    Under a process group every rank runs the transitions and global rank
    0 alone writes the movie; the others wait for it at the end."""
    import threading

    from latentblending_tpu_torch.parallel.mesh import is_file_writer, write_on_rank0
    from latentblending_tpu_torch.video.writer import MovieSaver

    assert len(project.keyframes) >= 2, "need at least two keyframes"
    if overlap_write is None:
        overlap_write = os.environ.get("LB_OVERLAP_PARTS") != "0"
    if apply_settings:
        be.set_dimensions((project.width, project.height))
        be.set_num_inference_steps(project.num_inference_steps)

    workdir = workdir or os.path.dirname(os.path.abspath(fp_movie))
    os.makedirs(workdir, exist_ok=True)
    kfs = list(project.keyframes) + ([project.keyframes[0]] if loop else [])
    target = int(round(fps * duration_single_trans))
    writes = is_file_writer()
    ms = None
    if writes:
        ms = MovieSaver(fp_movie, fps=fps, shape_hw=(be.dh.height_img, be.dh.width_img), device=be.dh.device)
    pending: threading.Thread | None = None
    errs: list[BaseException] = []
    part_reports = []
    try:
        for i in range(len(kfs) - 1):
            if i == 0:
                # negative prompt FIRST: embeddings bake it in at encode time
                # (the reference UI gets this wrong, gradio_ui.py:238-239 —
                # its first keyframe silently ignores the negative prompt)
                be.set_negative_prompt(kfs[i].negative_prompt)
                be.set_prompt1(kfs[i].prompt)
                be.set_prompt2(kfs[i + 1].prompt)
                recycle_img1 = False
            else:
                be.swap_forward()
                be.set_negative_prompt(kfs[i + 1].negative_prompt)
                be.set_prompt2(kfs[i + 1].prompt)
                recycle_img1 = True

            # streaming contract: keyframe HANDLES come back with their
            # device→host copies possibly still in flight; the writer
            # resolves them lazily. Keyframes ship as packed I420 planes
            # when possible (half the bytes; the MJPEG path encodes planes
            # directly). Snapshotting the handles here is safe across the
            # next iteration's swap_forward — the device batches they
            # reference are immutable, so the writer thread owns them.
            imgs = be.run_transition_streaming(
                recycle_img1=recycle_img1, fixed_seeds=[kfs[i].seed, kfs[i + 1].seed]
            )
            if pending is not None:
                pending.join()  # depth-1 pipeline: one part in flight
                if errs:
                    raise errs[0]
            trace = be.last_report.traces[-1]
            if writes and overlap_write:
                pending = threading.Thread(
                    target=_write_part, args=(imgs, ms, target, errs, trace), daemon=True
                )
                pending.start()
            elif writes:
                _write_part(imgs, ms, target, errs, trace)
                if errs:
                    raise errs[0]
            # sims are report-only and sit at the END of this part's device
            # queue — syncing here would serialize the host against the
            # whole part before the next one dispatches. Defer: the handle
            # rides on the report; all parts resolve after the last is in
            # flight (measured: 0.78 s blocked per part at 512²)
            be.finalize_report(sync_sims=False)
            part_reports.append(be.last_report)
            log.info(f"transition {i + 1}/{len(kfs) - 1} done")
    finally:
        if pending is not None:
            pending.join()
    if errs:
        raise errs[0]
    # leave the engine with the last transition's keyframes materialized
    be.resolve_keyframes()
    # last_report covers the WHOLE movie (phases summed across parts) —
    # per-transition MFU/phase math over a chained run was 3× off when it
    # read only the final part's report
    if part_reports:
        # land the deferred per-part similarity handles (device work is
        # long done — this is host copies only), each part's blocked wall
        # a span of the movie's lpips_sync phase
        timer = profiling.PhaseTimer()
        for rep in part_reports:
            with timer.phase("lpips_sync"):
                rep.resolve_sims()
        be.tree_similarities = list(part_reports[-1].lpips_gaps)
        be.last_report = profiling.TransitionReport.merged(part_reports)
        be.last_report.phases.update(timer.summary())

    def finalize():
        ms.finalize()
        be.note_writer(ms)
        log.info(f"movie saved to {fp_movie} ({ms.nmb_frames} frames)")

    write_on_rank0(finalize)
    return fp_movie
