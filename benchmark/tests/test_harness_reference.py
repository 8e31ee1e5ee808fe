"""The plain reference against the port on the CPU at tiny sizes: the same
weights land under the same names, a whole run of each kind of cell comes
out correct, and the control (the reference one precision below the
configuration's) fails the comparison.

Tiny limits (tiny.LIMITS) are set from tiny runs' own readings over seeds
1-6: the program read latent_rel 0.0055-0.0070 (turbo) and 0.0125-0.0169
(base), keyframe_mad 0.32-0.41 and 0.65-0.91, decode_mad under 1.5e-4; the
control (seeds 1-3) read latent_rel 0.054-0.076 and 0.126-0.146,
keyframe_mad 2.6-5.3 and 6.4-9.7. The tiny movie (2 s at 30 fps) read
movie_key_coef and movie_mid_coef 0 (seeds 1-3), exact comparisons.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import run, weights
from benchmark.calibrate import readings
from benchmark.reference.clip import hash_tokenize
from benchmark.tests.tiny import LIMITS, tiny_config, tiny_root

SEED = 2 ** 31 + 977  # larger than 32 signed bits hold, as the driver's are
CELLS = {"t.turbo": ("turbo", "transition"), "t.base": ("base", "transition"), "t.pred": ("base", "predictive"),
         "t.movie": ("turbo", "movie")}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    tmp = str(tmp_path_factory.mktemp("bench"))
    return tmp, tiny_root(tmp, CELLS)


@pytest.mark.parametrize("kind", ["turbo", "base"])
def test_weights_land_under_the_programs_names(kind):
    from latentblending_tpu_torch.runtime.holder import SPECS, build_modules
    from benchmark.reference import sdxl

    cfg = tiny_config(kind)
    mods = build_modules(SPECS[cfg["port_spec"]], torch.bfloat16, "cpu")
    ref = sdxl.parts(cfg)
    assert [p for p, _ in sdxl.PARTS] == ["unet", "vae", "clip1", "clip2"]  # the order that seeds the draws
    for part, names in ((p, weights.names_of(ref[p])) for p, _ in sdxl.PARTS):
        have = {k: tuple(v.shape) for k, v in mods[part].state_dict().items()}
        for name, shape in names:
            assert have.get(name) == shape, (part, name)
        extra = set(have) - dict(names).keys()
        # the program's VAE also holds the encoder, which no keyframe runs
        assert all(k.startswith(("encoder.", "quant_conv.")) for k in extra), (part, sorted(extra)[:5])


def test_weights_are_a_function_of_seed_and_name():
    a = {"x.weight": torch.empty(3, 4), "norm1.weight": torch.empty(4)}
    b = {"x.weight": torch.empty(3, 4), "norm1.weight": torch.empty(4), "extra.bias": torch.empty(2)}
    names = [("norm1.weight", (4,)), ("x.weight", (3, 4))]
    weights.fill(a, names, 5, 0, "float32", "cpu")
    weights.fill(b, names, 5, 0, "float32", "cpu")
    for k in a:
        assert torch.equal(a[k], b[k])
    c = {k: torch.empty_like(v) for k, v in a.items()}
    weights.fill(c, names, 6, 0, "float32", "cpu")
    assert not torch.equal(a["x.weight"], c["x.weight"])


def _vae(**keys):
    from benchmark.reference.vae import VAEDecoder

    cfg = dict(latent_channels=2, block_out_channels=[8, 8], layers_per_block=1, norm_num_groups=4,
               out_channels=3, scaling_factor=2.0, **keys)
    m = VAEDecoder(cfg).to_empty(device="cpu")
    m.decoder = torch.nn.Identity()  # what reaches the decoder, clamped, is the [-1,1] image
    return m


@pytest.mark.parametrize("keys, want", [
    # z / 2 + 0.25, no post_quant_conv: [0.1 + 0.25, -0.6 + 0.25]
    ({"shift_factor": 0.25, "use_post_quant_conv": False}, [0.35, -0.35]),
    # absent keys: post_quant_conv on z / 2 (weights [[1, 2], [0, -1]], bias [0.5, 0]), no shift
    ({}, [0.1 * 1 - 0.6 * 2 + 0.5, 0.6]),
    ({"shift_factor": None}, [0.1 * 1 - 0.6 * 2 + 0.5, 0.6]),
])
def test_vae_shift_factor_and_post_quant_conv(keys, want):
    m = _vae(**keys)
    assert hasattr(m, "post_quant_conv") == keys.get("use_post_quant_conv", True)
    if hasattr(m, "post_quant_conv"):
        with torch.no_grad():
            m.post_quant_conv.weight.copy_(torch.tensor([[1.0, 2.0], [0.0, -1.0]])[:, :, None, None])
            m.post_quant_conv.bias.copy_(torch.tensor([0.5, 0.0]))
    z = torch.tensor([0.2, -1.2]).expand(1, 2, 2, 2)
    with torch.no_grad():
        _, pm1 = m(z)
    assert torch.allclose(pm1, torch.tensor(want).expand(1, 2, 2, 2), atol=1e-6), pm1


def test_hash_tokenizer_is_the_programs():
    from latentblending_tpu_torch.models.tokenizer import HashTokenizer

    tok = HashTokenizer(49408, bos_token_id=0, eos_token_id=49407, pad_token_id=0)
    for text in ["", "a  Lighthouse\ton a cliff", " ".join(["word"] * 90)]:
        np.testing.assert_array_equal(tok([text])[0], hash_tokenize(text, 49408, 0, 49407, 0))


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_run_of_the_port_is_correct(root, cell):
    tmp, bench = root
    res = run.run_cell(bench, cell, SEED, 0.1, False, "cpu", root=tmp)
    assert res["correct"], res["check"]
    # every end-to-end metric of the cell but the peak memory, which the CPU has not
    names = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    assert res["attempted"] >= 1 and set(res["metrics"]) == names - {"peak_mem_gib"}


@pytest.mark.parametrize("cell", ["t.turbo", "t.base"])
def test_the_control_fails(root, cell):
    tmp, bench = root
    rows = readings(bench, cell, 3, 1, True, "cpu", root=tmp)
    limits = LIMITS[CELLS[cell][0]]
    program = [r for r in rows if r["side"] == "program"]
    control = [r for r in rows if r["side"] == "control"]
    assert all(r[k] <= limits[k] for r in program for k in limits)
    assert control and all(any(r[k] > limits[k] for k in limits) for r in control)
