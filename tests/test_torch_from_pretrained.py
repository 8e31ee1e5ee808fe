"""Checkpoint loading in the port: its safetensors reader and
SDXLHolder.from_pretrained against the JAX package's loader.

The test writes a tiny-turbo HF snapshot itself with
safetensors.numpy.save_file (no download): the JAX holder's random weights
under HF names in unet/, vae/, text_encoder/ and text_encoder_2/; beside
the UNet's file an `.fp16.` twin holding other values (both loaders read
every file in sorted order, so the full-precision twin wins); the CLIP
files carry `logit_scale` and an int64 `text_model.embeddings.position_ids`,
as real checkpoints do; scheduler/scheduler_config.json names
DPMSolverMultistepScheduler (dpmpp_2m, not the spec's Euler); tokenizer/
and tokenizer_2/ hold a small BPE vocabulary.

- JAX SDXLHolder.from_pretrained(dir, spec="tiny-turbo") and the port's
  (device="cpu") give the same scheduler config, and at f32 text
  embeddings within rtol 1e-4 / atol 1e-5 and a fused run_transition with
  tree_fracts equal, uint8 keyframes within 1 LSB and similarities within
  rtol 1e-4 (the JAX seeded noise injected); at bf16 the port rounds each
  CLIP tensor to bf16 and keeps it in f32, and the embeddings (bf16) agree
  within one bf16 step (rtol 2**-7, atol 1e-5);
- the reader equals safetensors.numpy.load_file bit for bit on F32 and
  F16 tensors and safetensors.torch.load_file on BF16 (safetensors.numpy
  has no BF16), __metadata__ and an empty tensor included;
- a truncated file, a header longer than the file, and an unknown dtype
  raise.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from latentblending_tpu.engine.blending import BlendingEngine as JEngine
from latentblending_tpu.runtime.holder import SDXLHolder as JHolder
from latentblending_tpu_torch.engine.blending import BlendingEngine as TEngine
from latentblending_tpu_torch.models.weights import params_from_jax, read_safetensors
from latentblending_tpu_torch.runtime import holder as th
from tests.torch_port_util import inject_jax_noise, np_tree

PROMPTS = ("photo of a forest at dawn", "photo of a city at night")


def _write_tokenizer(d):
    """A byte-level-free toy CLIP BPE vocabulary: specials, every lowercase
    letter alone and word-final, and a few merges."""
    os.makedirs(d)
    letters = "abcdefghijklmnopqrstuvwxyz"
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for ch in letters:
        vocab[ch] = len(vocab)
        vocab[ch + "</w>"] = len(vocab)
    merges = [("o", "t"), ("h", "o"), ("ho", "t</w>"), ("a", "t</w>"), ("i", "n")]
    for a, b in merges:
        vocab[a + b] = len(vocab)
    with open(os.path.join(d, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(d, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    root = tmp_path_factory.mktemp("snap") / "tiny-snapshot"
    src = JHolder.from_random("tiny-turbo", seed=0, dtype=jnp.float32)
    metas = th.build_modules(th.SPECS["tiny-turbo"], torch.float32, torch.device("meta"))
    hf = {k: {n: t.numpy() for n, t in params_from_jax(np_tree(src.params[k]), m).items()} for k, m in metas.items()}
    for sub, key, name in (("unet", "unet", "diffusion_pytorch_model"), ("vae", "vae", "diffusion_pytorch_model"),
                           ("text_encoder", "clip1", "model"), ("text_encoder_2", "clip2", "model")):
        os.makedirs(root / sub)
        state = dict(hf[key])
        if key.startswith("clip"):
            state["logit_scale"] = np.array(4.6052, np.float32)
            state["text_model.embeddings.position_ids"] = np.arange(77, dtype=np.int64)[None]
        save_file(state, str(root / sub / f"{name}.safetensors"), metadata={"format": "pt"})
        if key == "unet":
            twin = {n: (v + 1.0).astype(np.float16) for n, v in state.items()}
            save_file(twin, str(root / sub / f"{name}.fp16.safetensors"))
    os.makedirs(root / "scheduler")
    with open(root / "scheduler" / "scheduler_config.json", "w") as f:
        json.dump({"_class_name": "DPMSolverMultistepScheduler", "beta_start": 0.00085, "beta_end": 0.012,
                   "beta_schedule": "scaled_linear", "num_train_timesteps": 1000, "prediction_type": "epsilon",
                   "steps_offset": 1, "timestep_spacing": "trailing"}, f)
    _write_tokenizer(root / "tokenizer")
    _write_tokenizer(root / "tokenizer_2")
    return str(root), hf


def _setup(be):
    be.set_prompt1(PROMPTS[0])
    be.set_prompt2(PROMPTS[1])
    return be


def test_from_pretrained_matches_jax(snapshot, monkeypatch):
    monkeypatch.delenv("LB_FUSED", raising=False)
    root, hf = snapshot
    jdh = JHolder.from_pretrained(root, spec="tiny-turbo", dtype=jnp.float32)
    tdh = th.SDXLHolder.from_pretrained(root, spec="tiny-turbo", dtype=torch.float32, device="cpu")
    assert tdh.schedule.config.scheduler_type == "dpmpp_2m"
    jcfg, tcfg = jdh.schedule.config, tdh.schedule.config
    assert {f: getattr(tcfg, f) for f in vars(tcfg)} == {f: getattr(jcfg, f) for f in vars(tcfg)}
    np.testing.assert_allclose(np.asarray(tdh.schedule.sigmas), np.asarray(jdh.schedule.sigmas), rtol=1e-6)
    # the full-precision twin won over the .fp16. file
    for k, v in tdh.unet.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), hf["unet"][k])
    assert type(tdh.tokenizer1).__name__ == "CLIPTokenizer"
    for j, t in zip(jdh.get_text_embedding("hot cat in a box"), tdh.get_text_embedding("hot cat in a box")):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-5)

    inject_jax_noise(tdh, jdh)
    jbe = _setup(JEngine(jdh, run_benchmark=False))
    tbe = _setup(TEngine(tdh))
    jimgs = jbe.run_transition(fixed_seeds=[420, 421])
    timgs = tbe.run_transition(fixed_seeds=[420, 421])
    assert tbe.last_report.levels[0].get("fused") is True
    assert tbe.tree_fracts == list(jbe.tree_fracts) and len(timgs) == len(jimgs) == 12
    for t, j in zip(timgs, jimgs):
        assert np.abs(t.astype(int) - np.asarray(j).astype(int)).max() <= 1
    np.testing.assert_allclose(tbe.tree_similarities, jbe.tree_similarities, rtol=1e-4)


def test_from_pretrained_bf16_clip_rounding(snapshot):
    root, hf = snapshot
    jdh = JHolder.from_pretrained(root, spec="tiny-turbo")
    tdh = th.SDXLHolder.from_pretrained(root, spec="tiny-turbo", device="cpu")
    assert tdh.dtype == torch.bfloat16 and tdh.clip1.text_model.final_layer_norm.weight.dtype == torch.float32
    for k, v in tdh.clip2.state_dict().items():
        assert torch.equal(v, torch.from_numpy(hf["clip2"][k]).to(torch.bfloat16).float()), k
    for j, t in zip(jdh.get_text_embedding("a cat at night"), tdh.get_text_embedding("a cat at night")):
        assert t.dtype == torch.bfloat16
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), rtol=2**-7, atol=1e-5)


def test_reader_matches_safetensors(tmp_path):
    from safetensors.torch import load_file as load_torch
    from safetensors.torch import save_file as save_torch

    rng = np.random.default_rng(0)
    state = {"a": rng.normal(size=(3, 5)).astype(np.float32), "b": rng.normal(size=(7,)).astype(np.float16),
             "c": np.array(2.5, np.float32), "d": rng.normal(size=(2, 1, 3)).astype(np.float16),
             "e": np.zeros((0, 4), np.float32), "f": rng.normal(size=(4, 3)).astype(np.float32)}
    fp = str(tmp_path / "np.safetensors")
    save_file(state, fp, metadata={"note": "x"})
    got, want = read_safetensors(fp), load_file(fp)
    assert set(got) == set(want)
    for k in want:
        assert got[k].numpy().dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].numpy().tobytes() == want[k].tobytes()
    bf = {"w": torch.randn(5, 3).to(torch.bfloat16), "x": torch.randn(3).to(torch.float16),
          "y": torch.randn(2, 2).to(torch.bfloat16)}
    fp2 = str(tmp_path / "bf16.safetensors")
    save_torch(bf, fp2)
    got2, want2 = read_safetensors(fp2), load_torch(fp2)
    for k in want2:
        assert got2[k].dtype == want2[k].dtype and got2[k].shape == want2[k].shape
        assert torch.equal(got2[k].reshape(-1).view(torch.uint8), want2[k].reshape(-1).view(torch.uint8))


def test_reader_refuses_bad_files(tmp_path):
    fp = str(tmp_path / "ok.safetensors")
    save_file({"a": np.arange(64, dtype=np.float32)}, fp)
    data = open(fp, "rb").read()
    (tmp_path / "trunc.safetensors").write_bytes(data[:-4])
    with pytest.raises(ValueError):
        read_safetensors(str(tmp_path / "trunc.safetensors"))
    (tmp_path / "head.safetensors").write_bytes(data[:20])
    with pytest.raises(ValueError):
        read_safetensors(str(tmp_path / "head.safetensors"))
    (tmp_path / "tiny.safetensors").write_bytes(data[:5])
    with pytest.raises(ValueError):
        read_safetensors(str(tmp_path / "tiny.safetensors"))
    save_file({"i": np.arange(4, dtype=np.int32)}, str(tmp_path / "int.safetensors"))
    with pytest.raises(ValueError, match="I32"):
        read_safetensors(str(tmp_path / "int.safetensors"))
    # a name in `skip` is not read, whatever its dtype
    assert read_safetensors(str(tmp_path / "int.safetensors"), skip={"i"}) == {}
