"""BENCHMARK.json is whole: every cell's configuration, traffic mix and
check file exist, every metric has its reader, and the names, units and
bounds keep the benchmark's rules."""
from __future__ import annotations

import json
import os
import re

import pytest
import torch

from benchmark import calls
from benchmark.run import reader
from benchmark.tests.tiny import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_cells_name_existing_files(bench):
    confs = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert os.path.isfile(os.path.join(REPO, confs[w["config"]]["file"]))
        for sub, name in (("traffic", w["traffic"]), ("checks", w["name"])):
            with open(os.path.join(REPO, "benchmark", sub, name + ".json")) as f:
                json.load(f)
    assert {w["config"] for w in bench["workloads"]} == set(confs)


def test_metrics_have_readers_and_rules(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert callable(reader(m["name"]).read)
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e


def test_checks_compare_every_number(bench):
    for w in bench["workloads"]:
        with open(os.path.join(REPO, "benchmark", "checks", w["name"] + ".json")) as f:
            check = json.load(f)
        with open(os.path.join(REPO, "benchmark", "traffic", w["traffic"] + ".json")) as f:
            call = calls.load(json.load(f)["call"])
        numbers = {"latent_rel", "keyframe_mad", "decode_mad", "placement", "structure"}
        assert set(check["limits"]) == numbers | set(call.NUMBERS)


@pytest.mark.gpu
def test_tiny_cells_on_the_card(tmp_path):
    """The tiny cells through a whole run on the card (the port's kernels
    where their shapes allow), correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from benchmark import run
    from benchmark.tests.test_harness_reference import CELLS, SEED
    from benchmark.tests.tiny import tiny_root

    root = tiny_root(str(tmp_path), CELLS)
    for cell in CELLS:
        res = run.run_cell(root, cell, SEED, 0.5, True, "cuda", root=str(tmp_path))
        assert res["correct"], res["check"]
