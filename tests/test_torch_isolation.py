"""Isolation of the PyTorch port from JAX, and its copies of the JAX
package's host modules.

- The port never imports jax or flax: every module of
  latentblending_tpu_torch (the movie path's tree cache, video layer and
  sessions, LPIPS, the checkpoint reader, the YAML writer and the example
  scripts included), and chip_smoke.py, imports in a subprocess in which
  `import jax` and `import latentblending_tpu` fail, and so do PIL, yaml
  and safetensors, which the card's machine lacks.
- The copied host modules equal their originals: configs, schedules,
  utils, video/i420 and engine/config (EngineConfig) byte for byte; the tokenizer (its `regex` import moved inside the
  BPE path) and profiling (without the jax.profiler hook) by behaviour.
- chip_smoke.py refuses to run without a CUDA device, and from a
  directory that holds nothing else of the repo.
"""
import inspect
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


def test_profiling_copy_matches():
    for name in ("PhaseTimer", "TransitionReport"):
        assert inspect.getsource(getattr(tprof, name)) == inspect.getsource(getattr(jprof, name))
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


def test_port_never_imports_jax():
    mods = _port_modules()
    assert "latentblending_tpu_torch.engine.blending" in mods and len(mods) > 15
    assert all(f"latentblending_tpu_torch.{m}" in mods for m in MOVIE_MODULES + REFERENCE_MODULES)
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'jaxlib', 'latentblending_tpu', 'PIL', 'yaml', 'safetensors'):\n"
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
