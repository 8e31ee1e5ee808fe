"""Isolation of the PyTorch port from JAX, and its copies of the JAX
package's host modules.

- The port never imports jax or flax: every module of
  latentblending_tpu_torch (the movie path's tree cache, video layer and
  sessions, LPIPS, the checkpoint reader, the YAML writer and the example
  scripts included), and chip_smoke.py, imports in a subprocess in which
  `import jax` and `import latentblending_tpu` fail, and so do PIL, yaml,
  safetensors, cv2 and gradio, which the card's machine lacks (the serving
  apps import gradio in their main() only).
- The multi-GPU layer (parallel/) and ops/flops.py are among the modules
  checked; flops.py counts what the JAX package's counts (tiny, SDXL-Turbo
  512², SDXL-base 1024²), and ops/ exports the JAX ops package's names.
- Every name of latentblending_tpu.__all__ resolves on the port's package
  (lazily: importing the package builds no model), read_movie_frames to
  the port's decoder, yml_load / yml_save to the PyYAML-free ones.
- The copied host modules equal their originals: configs, schedules,
  utils, video/i420 and engine/config (EngineConfig) byte for byte; the tokenizer (its `regex` import moved inside the
  BPE path) by behaviour. The port's profiling is its own tracer, but
  PhaseTimer and TransitionReport behave as the JAX package's: the same
  phases give the same summary, the same reports the same merged report
  (and it has no jax.profiler hook).
- chip_smoke.py refuses to run without a CUDA device, and from a
  directory that holds nothing else of the repo.
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import latentblending_tpu
import latentblending_tpu_torch
from latentblending_tpu import profiling as jprof
from latentblending_tpu.models import tokenizer as jtok
from latentblending_tpu_torch import profiling as tprof
from latentblending_tpu_torch.models import tokenizer as ttok

ROOT = Path(__file__).resolve().parent.parent
JPKG = Path(latentblending_tpu.__file__).parent
TPKG = Path(latentblending_tpu_torch.__file__).parent


@pytest.mark.parametrize("rel", ["models/configs.py", "ops/schedules.py", "utils.py", "video/i420.py",
                                 "engine/config.py"])
def test_copied_modules_are_identical(rel):
    assert (TPKG / rel).read_bytes() == (JPKG / rel).read_bytes()


def test_profiling_copy_matches(monkeypatch):
    """The same phase sequence, on one scripted clock, gives the same
    summary() in both packages; the same part reports (one with a deferred
    similarity handle) merge into the same totals."""
    import time

    def run_phases(prof):
        ticks = iter([0.0, 0.5, 0.5, 0.75, 1.0, 3.0, 3.0, 3.125])
        clock = lambda: next(ticks)  # noqa: E731
        monkeypatch.setattr(time, "perf_counter", clock)
        monkeypatch.setattr(time, "perf_counter_ns", lambda: round(clock() * 1e9))
        timer = prof.PhaseTimer()
        for name in ("denoise", "vae_decode", "denoise", "movie_write"):
            with timer.phase(name):
                pass
        monkeypatch.undo()
        return timer.summary()

    assert run_phases(tprof) == run_phases(jprof) == {
        "denoise": {"total_s": 2.5, "count": 2, "mean_s": 1.25},
        "movie_write": {"total_s": 0.125, "count": 1, "mean_s": 0.125},
        "vae_decode": {"total_s": 0.25, "count": 1, "mean_s": 0.25}}

    def merged(prof):
        r1 = prof.TransitionReport(num_keyframes=5, num_steps=4, wall_s=1.0, levels=[{"stems": 3}])
        r1.phases = {"denoise": {"total_s": 0.5, "count": 2, "mean_s": 0.25}}
        r1.sims_pending = np.asarray([0.25, 0.5, 0.125, 1.0])
        r2 = prof.TransitionReport(num_keyframes=5, num_steps=4, wall_s=2.0, lpips_gaps=[0.5] * 4)
        r2.phases = {"denoise": {"total_s": 1.5, "count": 2, "mean_s": 0.75},
                     "movie_write": {"total_s": 0.25, "count": 1, "mean_s": 0.25}}
        out = prof.TransitionReport.merged([r1, r2]).as_dict()
        return {k: out[k] for k in ("num_keyframes", "num_steps", "wall_s", "levels", "lpips_gaps", "phases")}

    assert merged(tprof) == merged(jprof)
    assert merged(tprof)["phases"]["denoise"] == {"total_s": 2.0, "count": 4, "mean_s": 0.5}
    assert not hasattr(tprof, "trace")


def _toy_vocab():
    vocab = {
        "<|startoftext|>": 0, "<|endoftext|>": 1, "h": 2, "e": 3, "l": 4, "o": 5, "o</w>": 6, "he": 7,
        "ll": 8, "hell": 9, "hello</w>": 10, "w": 11, "r": 12, "d": 13, "d</w>": 14, "wo": 15, "wor": 16,
        "l</w>": 17, "!</w>": 18,
    }
    merges = [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o</w>"), ("w", "o"), ("wo", "r")]
    return vocab, merges


TEXTS = ["hello world!", "  HELLO\t\nworld  ", "<|startoftext|>hello<|endoftext|>", "héllo wörld 42", "",
         "photo of a forest at dawn, mist between the trees " * 12]


def test_tokenizer_copy_gives_the_same_ids():
    pytest.importorskip("regex")
    vocab, merges = _toy_vocab()
    jt = jtok.CLIPTokenizer(vocab, merges, bos_token_id=0, eos_token_id=1, pad_token_id=1)
    tt = ttok.CLIPTokenizer(vocab, merges, bos_token_id=0, eos_token_id=1, pad_token_id=1)
    np.testing.assert_array_equal(tt(TEXTS), jt(TEXTS))
    for kw in ({}, {"vocab_size": 1000, "bos_token_id": 0, "eos_token_id": 999, "pad_token_id": 0}):
        np.testing.assert_array_equal(ttok.HashTokenizer(**kw)(TEXTS), jtok.HashTokenizer(**kw)(TEXTS))


def _port_modules() -> list[str]:
    mods = []
    for p in sorted(TPKG.rglob("*.py")):
        rel = p.relative_to(TPKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


# the movie path's modules (tree cache, video layer, sessions) are among
# them, and the reference-facing ones (LPIPS, checkpoint reading, YAML, apps)
MOVIE_MODULES = ["engine.tree_cache", "engine.session", "video.frames", "video.jpeg", "video.mjpeg_mp4",
                 "video.writer"]
REFERENCE_MODULES = ["models.lpips", "models.weights", "precision", "yaml_text", "apps.example_single_trans",
                     "apps.example_multi_trans", "apps.example_multi_trans_json"]
# the serving path and the movie reader
SERVING_MODULES = ["apps.gradio_ui", "apps.server", "video.jpeg_decode"]
# the multi-GPU layer and the analytic FLOP counts
PARALLEL_MODULES = ["parallel", "parallel.distributed", "parallel.mesh", "parallel.tp", "ops.flops"]


def test_port_never_imports_jax():
    mods = _port_modules()
    assert "latentblending_tpu_torch.engine.blending" in mods and len(mods) > 15
    assert all(f"latentblending_tpu_torch.{m}" in mods
               for m in MOVIE_MODULES + REFERENCE_MODULES + SERVING_MODULES + PARALLEL_MODULES)
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'jaxlib', 'latentblending_tpu', 'PIL', 'yaml', 'safetensors', 'cv2', 'gradio'):\n"
        "    sys.modules[name] = None\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import importlib\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "print('imported', len(sys.modules))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert "imported" in res.stdout


def test_package_exports_the_jax_names():
    from latentblending_tpu_torch import yaml_text
    from latentblending_tpu_torch.runtime.holder import SDXLHolder
    from latentblending_tpu_torch.video import writer

    assert latentblending_tpu_torch.__all__ == latentblending_tpu.__all__
    for name in latentblending_tpu.__all__:
        assert getattr(latentblending_tpu_torch, name) is not None, name
    assert latentblending_tpu_torch.DiffusersHolder is SDXLHolder
    assert latentblending_tpu_torch.read_movie_frames is writer.read_movie_frames
    assert latentblending_tpu_torch.yml_load is yaml_text.yml_load
    assert latentblending_tpu_torch.yml_save is yaml_text.yml_save
    with pytest.raises(AttributeError):
        latentblending_tpu_torch.not_a_name
    # importing the package alone loads no torch
    code = "import sys; import latentblending_tpu_torch; print('torch' in sys.modules)"
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0 and res.stdout.strip() == "False", res.stderr


def test_ops_exports_the_jax_names():
    """latentblending_tpu_torch.ops exports the JAX ops package's __all__,
    each from the port's module of the same name, and loads none of them
    on import."""
    import latentblending_tpu.ops as jops
    import latentblending_tpu_torch.ops as tops

    assert tops.__all__ == jops.__all__
    for name in jops.__all__:
        value = getattr(tops, name)
        assert value.__module__.startswith("latentblending_tpu_torch.ops."), name
        assert value.__module__.rsplit(".", 1)[1] == getattr(jops, name).__module__.rsplit(".", 1)[1], name
    with pytest.raises(AttributeError):
        tops.not_a_name


@pytest.mark.parametrize("spec, hw, batch", [("tiny-turbo", (128, 128), 3), ("sdxl-turbo", (512, 512), 12),
                                             ("sdxl-base", (1024, 1024), 20)])
def test_flops_match_the_jax_package(spec, hw, batch):
    """ops/flops.py, the jax-free copy, counts what the JAX package's counts:
    one UNet forward at the latent size and one VAE decode, and it differs
    from the original only in the configs it imports."""
    from latentblending_tpu.ops import flops as jflops
    from latentblending_tpu.runtime.holder import SPECS as JSPECS
    from latentblending_tpu_torch.ops import flops as tflops
    from latentblending_tpu_torch.runtime.holder import SPECS as TSPECS

    j, t = JSPECS[spec], TSPECS[spec]
    h, w = hw[0] // 8, hw[1] // 8
    assert tflops.unet_forward_flops(t.unet, h, w, batch) == jflops.unet_forward_flops(j.unet, h, w, batch) > 0
    assert tflops.vae_decode_flops(t.vae, *hw, batch=2) == jflops.vae_decode_flops(j.vae, *hw, batch=2) > 0
    src = (TPKG / "ops/flops.py").read_text().replace("latentblending_tpu_torch.", "latentblending_tpu.")
    body = src.split('"""', 2)[2]
    assert body == (JPKG / "ops/flops.py").read_text().split('"""', 2)[2]


def _run_smoke(cwd: Path) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True, timeout=300,
                          cwd=cwd, env=env)


def test_chip_smoke_fails_without_cuda():
    res = _run_smoke(ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
