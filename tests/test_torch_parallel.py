"""The port's multi-GPU layer (latentblending_tpu_torch/parallel) against
the JAX package, on the CPU.

Single-process tests (no process group): pad_to_multiple and the trivial
(1, 1) mesh; unet_tp_specs on the tiny UNet against the JAX unet_tp_specs,
name for name through models/weights.jax_path; strict TP at SDXL's real
shapes (a meta-device UNet) with no fallback; the fallback's warning and
strict raise; the sharding arithmetic of one transformer block, two ranks
run in lockstep on threads whose all-reduce sums their partials, against
the unsharded block (a contiguous split of GEGLU's proj, or a row-parallel
bias added on every rank, fails it); a trivial-mesh engine takes the
per-level path and its holder refuses the fused tree scans.

Multi-process tests: this file run as a script is a child rank (it imports
no jax): `python tests/test_torch_parallel.py child RANK WORLD PORT DIR
MESHES`. One launch of 2 ranks runs meshes (2,1) then (1,2), one of 4
ranks (2,2), over gloo on the CPU, with port weights from seed 0 in
float32. The parent holds each mesh's results against the JAX package's
unsharded run on the same weights (converted by
torch_port_util.jax_params_from_port) and inputs (numpy latents from a
seed, the port's conditioning and seeded noise handed to JAX, the JAX
ancestral draws handed to the port):
- run_diffusion_batched at B=4 and B=5 (the pad path), last step within
  rtol/atol 5e-4 (tests/test_sharding.py's bound: sharded execution sums
  in another order);
- tiny-ancestral at B=4, the same bound;
- run_transition(nmb_max_branches=5) on the per-level path: tree_fracts
  equal, keyframes within 1 LSB of JAX's (LB_FUSED=0 there), every rank's
  keyframes byte-equal;
- the reference's single-branch loop (compute_latents1/2,
  get_mixing_parameters, insert_into_tree) x 3: tree_fracts equal,
  keyframes within 1 LSB of JAX's, rank 0's similarities on every rank;
- write_movie_transition from every rank to one path: one file, byte-equal
  to the unsharded port's writer on the same keyframes; save_tree,
  write_imgs_transition, MovieProject.save and run_multi_transition each
  write their files once.
"""
from __future__ import annotations

import logging
import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from latentblending_tpu_torch.models import configs as TC  # noqa: E402
from latentblending_tpu_torch.models.layers import BasicTransformerBlock  # noqa: E402
from latentblending_tpu_torch.parallel import tp as ttp  # noqa: E402
from latentblending_tpu_torch.parallel.mesh import Mesh, auto_mesh, make_mesh, pad_to_multiple  # noqa: E402

PROMPTS = ("photo of a forest at dawn", "photo of a city at night", "blurry, low quality")
MESHES = {2: ((2, 1), (1, 2)), 4: ((2, 2),)}
SEEDS = [420, 421]
MOVIE = {"duration_transition": 1.0, "fps": 10}
CHILD_TIMEOUT_S = 300


def _setup(be):
    be.set_negative_prompt(PROMPTS[2])  # read by the next embeddings
    be.set_prompt1(PROMPTS[0])
    be.set_prompt2(PROMPTS[1])
    be.set_branching(depth_strength=0.5, nmb_max_branches=5)
    return be


# --------------------------------------------------------------- child rank


def _single_branch_loop(be) -> dict:
    """The reference's single-branch loop (compute_latents1/2,
    get_tree_similarities on the host keyframes, then get_mixing_parameters,
    set_guidance_mid_dampening, compute_latents_mix and insert_into_tree
    three times at depth 2): the same calls on the port's engine and the
    JAX package's."""
    be.seed1, be.seed2 = SEEDS
    be.tree_latents = [be.compute_latents1(), be.compute_latents2()]
    be.tree_fracts = [0.0, 1.0]
    be.tree_idx_injection = [0, 0]
    be.tree_final_imgs = [be.dh.latent2image(be.tree_latents[0][-1]), be.dh.latent2image(be.tree_latents[-1][-1])]
    be._imgs_dev = []
    be.tree_similarities = be.get_tree_similarities()
    for _ in range(3):
        fract, b1, b2 = be.get_mixing_parameters(2)
        be.set_guidance_mid_dampening(fract)
        be.insert_into_tree(fract, 2, be.compute_latents_mix(fract, b1, b2, 2))
    return {"sb_imgs": np.stack([np.asarray(im) for im in be.tree_final_imgs]), "sb_fracts": np.asarray(be.tree_fracts),
            "sb_idx": np.asarray(be.tree_idx_injection), "sb_sims": np.asarray(be.tree_similarities)}


def _mesh_run(mesh, inputs: dict, movie_dir: Path) -> dict:
    """Everything one rank computes on one mesh."""
    from latentblending_tpu_torch.engine.blending import BlendingEngine
    from latentblending_tpu_torch.runtime.holder import SDXLHolder

    out = {}
    dh = SDXLHolder.from_random("tiny-turbo", seed=0, dtype=torch.float32, device="cpu", mesh=mesh)
    te = dh.get_text_embedding(PROMPTS[0])
    lat = torch.from_numpy(inputs["lat"])
    out["traj5"] = dh.run_diffusion_batched(dh._conditioning(te, 5), lat).numpy()
    out["traj4"] = dh.run_diffusion_batched(dh._conditioning(te, 4), lat[:4]).numpy()

    dha = SDXLHolder.from_random("tiny-ancestral", seed=0, dtype=torch.float32, device="cpu", mesh=mesh)
    anc = torch.from_numpy(inputs["anc4"])

    def ancestral_noise(steps, shape):  # the JAX draws, for the unsharded batch
        if (steps,) + tuple(shape) != tuple(anc.shape):
            raise AssertionError(f"ancestral draws of {(steps,) + tuple(shape)} asked, {tuple(anc.shape)} given")
        return anc

    dha.ancestral_noise = ancestral_noise
    out["anc4"] = dha.run_diffusion_batched(dha._conditioning(te, 4), lat[:4]).numpy()

    # count the files this rank opens for writing through each writer
    from latentblending_tpu_torch.engine import tree_cache
    from latentblending_tpu_torch.video import writer

    opened = {"movie": 0, "npz": 0}
    saver_init, savez = writer.MovieSaver.__init__, np.savez_compressed

    def counting_saver(self, *a, **kw):
        opened["movie"] += 1
        saver_init(self, *a, **kw)

    def counting_savez(*a, **kw):
        opened["npz"] += 1
        savez(*a, **kw)

    writer.MovieSaver.__init__ = counting_saver
    tree_cache.np.savez_compressed = counting_savez

    be = _setup(BlendingEngine(dh))
    before = dict(mesh.collectives)
    imgs = be.run_transition(fixed_seeds=SEEDS)
    out["collectives"] = np.asarray([mesh.collectives[k] - before[k] for k in sorted(before)])
    out["fused"] = np.asarray([bool(lv.get("fused") or lv.get("seg")) for lv in be.last_report.levels])
    out["imgs"] = np.stack(imgs)
    out["fracts"] = np.asarray(be.tree_fracts)
    out["sims"] = np.asarray(be.tree_similarities)
    # the single-branch loop: its similarities (host keyframes, and each
    # insert's two neighbours) are rank 0's, one broadcast each
    before = mesh.collectives["broadcast"]
    out.update(_single_branch_loop(_setup(BlendingEngine(dh))))
    out["sb_broadcasts"] = np.asarray(mesh.collectives["broadcast"] - before)
    be.write_movie_transition(str(movie_dir / "movie.mp4"), **MOVIE)
    # the other writers: rank 0 writes, every rank waits
    from latentblending_tpu_torch.engine.session import Keyframe, MovieProject, run_multi_transition
    from latentblending_tpu_torch.engine.tree_cache import save_tree

    save_tree(be, str(movie_dir / "tree.npz"))
    be.write_imgs_transition(str(movie_dir / "imgs"))
    project = MovieProject([Keyframe(PROMPTS[0], SEEDS[0]), Keyframe(PROMPTS[1], SEEDS[1])], width=128, height=128)
    project.save(str(movie_dir / "project.json"))
    run_multi_transition(be, project, str(movie_dir / "multi.mp4"), duration_single_trans=0.5, fps=10,
                         apply_settings=False)
    writer.MovieSaver.__init__, tree_cache.np.savez_compressed = saver_init, savez
    out["opened"] = np.asarray([opened["movie"], opened["npz"]])
    return out


def _child_main(argv: list[str]) -> int:
    """A child rank: python tests/test_torch_parallel.py child RANK WORLD PORT DIR MESHES."""
    for name in ("jax", "jaxlib", "flax", "latentblending_tpu"):
        sys.modules[name] = None  # the port runs without JAX
    import torch.distributed as dist

    from latentblending_tpu_torch.parallel.distributed import init_distributed

    torch.set_num_threads(1)
    rank, world, port, workdir = int(argv[1]), int(argv[2]), int(argv[3]), Path(argv[4])
    meshes = [tuple(int(n) for n in m.split("x")) for m in argv[5].split(",")]
    if not init_distributed(f"tcp://127.0.0.1:{port}", world_size=world, rank=rank):
        raise AssertionError("expected a multi-process run")
    inputs = dict(np.load(workdir / "inputs.npz"))
    for n_data, n_model in meshes:
        mesh = make_mesh(n_data, n_model)
        tag = f"{n_data}x{n_model}"
        movie_dir = workdir / f"movie_{tag}"
        if rank == 0:
            movie_dir.mkdir()
        mesh.barrier()
        np.savez(workdir / f"{tag}_rank{rank}.npz", **_mesh_run(mesh, inputs, movie_dir))
    dist.destroy_process_group()
    print(f"child {rank}: OK", flush=True)
    return 0


# ------------------------------------------------------------------ parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(world: int, workdir: Path) -> list:
    port = _free_port()
    meshes = ",".join(f"{d}x{m}" for d, m in MESHES[world])
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    return [subprocess.Popen([sys.executable, "-u", __file__, "child", str(r), str(world), str(port), str(workdir),
                              meshes], cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
            for r in range(world)]


def _wait(procs: list) -> None:
    """Wait for every child (each with its own time limit); on a failure
    or a timeout kill the others and fail with the child's output."""
    try:
        for r, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=CHILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                raise AssertionError(f"child {r} timed out:\n{out[-4000:]}")
            if p.returncode != 0 or f"child {r}: OK" not in out:
                raise AssertionError(f"child {r} failed ({p.returncode}):\n{out[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Launch both meshes' children, compute the JAX references meanwhile,
    and return ({mesh: [rank results]}, references, workdir, port holder)."""
    import jax
    import jax.numpy as jnp

    from latentblending_tpu.engine.blending import BlendingEngine as JEngine
    from latentblending_tpu.runtime.denoise import Conditioning as JCond
    from latentblending_tpu.runtime.holder import SDXLHolder as JHolder
    from latentblending_tpu_torch.models.weights import params_from_jax
    from latentblending_tpu_torch.runtime.holder import SDXLHolder
    from tests.torch_port_util import jax_ancestral_draws, jax_params_from_port, np_tree

    workdir = tmp_path_factory.mktemp("mesh")
    tdh = SDXLHolder.from_random("tiny-turbo", seed=0, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    lat = (rng.standard_normal((5, 16, 16, 4)) * tdh.schedule.init_noise_sigma).astype(np.float32)
    anc4 = jax_ancestral_draws(0, 0, 4, (4, 16, 16, 4))
    np.savez(workdir / "inputs.npz", lat=lat, anc4=anc4)
    procs = {world: _launch(world, workdir) for world in MESHES}
    try:
        kinds = {"unet": "unet", "vae": "vae", "clip1": "clip", "clip2": "clip"}
        params = {k: jax_params_from_port(getattr(tdh, k), kind) for k, kind in kinds.items()}
        for k in kinds:  # the inverse map is exact: every leaf lands on its key
            back = params_from_jax(np_tree(params[k]), getattr(tdh, k))
            assert all(torch.equal(v, back[n]) for n, v in getattr(tdh, k).state_dict().items())
        jdh = JHolder("tiny-turbo", params, dtype=jnp.float32)
        te = tdh.get_text_embedding(PROMPTS[0])
        c = tdh._conditioning(te, 5)
        jcond = JCond(*(jnp.asarray(getattr(c, f).numpy()) for f in (
            "prompt_embeds", "pooled_embeds", "time_ids", "neg_prompt_embeds", "neg_pooled_embeds", "neg_time_ids")))
        ref = {"traj5": np.asarray(jdh.run_diffusion_batched(jcond, jnp.asarray(lat))[-1])}
        # rows of a batch are independent: B=4's reference is B=5's first 4 rows
        ref["traj4"] = ref["traj5"][:4]
        jdha = JHolder("tiny-ancestral", params, dtype=jnp.float32)
        jcond4 = jax.tree_util.tree_map(lambda x: x[:4], jcond)
        ref["anc4"] = np.asarray(jdha.run_diffusion_batched(jcond4, jnp.asarray(lat[:4]))[-1])
        # the port's seeded noise, handed to JAX
        jdh.get_noise = lambda seed: jnp.asarray(tdh.get_noise(seed).numpy())
        old = os.environ.get("LB_FUSED")
        os.environ["LB_FUSED"] = "0"
        try:
            jbe = _setup(JEngine(jdh, run_benchmark=False))
            ref["imgs"] = [np.asarray(im) for im in jbe.run_transition(fixed_seeds=SEEDS)]
        finally:
            os.environ.pop("LB_FUSED")
            if old is not None:
                os.environ["LB_FUSED"] = old
        ref["fracts"] = list(jbe.tree_fracts)
        ref["levels"] = jbe.last_report.levels
        ref.update(_single_branch_loop(_setup(JEngine(jdh, run_benchmark=False))))
    finally:
        for ps in procs.values():
            _wait(ps)
    results = {}
    for world, meshes in MESHES.items():
        for d, m in meshes:
            results[(d, m)] = [dict(np.load(workdir / f"{d}x{m}_rank{r}.npz")) for r in range(world)]
    return results, ref, workdir, tdh


ALL_MESHES = [m for ms in MESHES.values() for m in ms]


@pytest.mark.parametrize("mesh", ALL_MESHES, ids=[f"{d}x{m}" for d, m in ALL_MESHES])
def test_batched_denoise_matches_jax(runs, mesh):
    results, ref, _, _ = runs
    for r, res in enumerate(results[mesh]):
        for key in ("traj4", "traj5"):
            assert res[key].shape == (4, int(key[-1]), 16, 16, 4), (r, key)
            np.testing.assert_allclose(res[key][-1], ref[key], rtol=5e-4, atol=5e-4, err_msg=f"rank {r} {key}")


@pytest.mark.parametrize("mesh", ALL_MESHES, ids=[f"{d}x{m}" for d, m in ALL_MESHES])
def test_ancestral_matches_jax(runs, mesh):
    results, ref, _, _ = runs
    for r, res in enumerate(results[mesh]):
        np.testing.assert_allclose(res["anc4"][-1], ref["anc4"], rtol=5e-4, atol=5e-4, err_msg=f"rank {r}")


@pytest.mark.parametrize("mesh", ALL_MESHES, ids=[f"{d}x{m}" for d, m in ALL_MESHES])
def test_transition_matches_jax(runs, mesh):
    results, ref, _, _ = runs
    assert not any(lv.get("fused") for lv in ref["levels"])
    first = results[mesh][0]
    for r, res in enumerate(results[mesh]):
        assert not res["fused"].any(), f"rank {r} took a fused path"
        assert res["fracts"].tolist() == ref["fracts"], r
        assert len(res["imgs"]) == len(ref["imgs"]) == 7
        assert np.array_equal(res["imgs"], first["imgs"]), f"rank {r}'s keyframes differ from rank 0's"
        assert np.array_equal(res["sims"], first["sims"]), r
        lsb = max(int(np.abs(a.astype(int) - b.astype(int)).max()) for a, b in zip(res["imgs"], ref["imgs"]))
        assert lsb <= 1, f"rank {r}: {lsb} LSB from JAX"
    # the collectives of one transition: stem gathers over data, the
    # row-parallel all-reduces over model, one similarity broadcast a pass
    gathers, reduces, _, broadcasts = (int(x) for x in first["collectives"])  # sorted keys
    assert broadcasts >= 1 and gathers >= 1
    assert (reduces > 0) == (mesh[1] > 1)


@pytest.mark.parametrize("mesh", ALL_MESHES, ids=[f"{d}x{m}" for d, m in ALL_MESHES])
def test_single_branch_loop_matches_jax(runs, mesh):
    """The single-branch loop under a mesh (its denoises sharded, B=1
    padded on (2,1) and (2,2)) against the JAX package's: tree_fracts and
    tree_idx_injection equal, keyframes within 1 LSB, similarities within
    rtol 1e-4 (tests/test_torch_single_branch.py's bounds); every rank's
    keyframes and similarities equal rank 0's, and each of the loop's 7
    similarity computations (the host keyframes' gaps, then two per
    insert) broadcast rank 0's values."""
    results, ref, _, _ = runs
    first = results[mesh][0]
    for r, res in enumerate(results[mesh]):
        assert res["sb_fracts"].tolist() == ref["sb_fracts"].tolist(), r
        assert res["sb_idx"].tolist() == ref["sb_idx"].tolist() == [0, 2, 2, 2, 0], r
        assert res["sb_imgs"].shape == ref["sb_imgs"].shape == (5, 128, 128, 3)
        assert int(np.abs(res["sb_imgs"].astype(int) - ref["sb_imgs"].astype(int)).max()) <= 1, r
        np.testing.assert_allclose(res["sb_sims"], ref["sb_sims"], rtol=1e-4, err_msg=f"rank {r}")
        assert np.array_equal(res["sb_imgs"], first["sb_imgs"]) and np.array_equal(res["sb_sims"], first["sb_sims"]), r
        assert int(res["sb_broadcasts"]) == 7, f"rank {r}: {int(res['sb_broadcasts'])} similarity broadcasts"


@pytest.mark.parametrize("mesh", ALL_MESHES, ids=[f"{d}x{m}" for d, m in ALL_MESHES])
def test_files_written_once(runs, mesh):
    """Every rank called each writer with the same paths: one movie,
    byte-equal to the unsharded port's writer on the same keyframes, and
    one tree cache, JPEG set, project file and chained movie."""
    results, _, workdir, tdh = runs
    from latentblending_tpu_torch.engine.blending import BlendingEngine

    d, m = mesh
    movie_dir = workdir / f"movie_{d}x{m}"
    assert sorted(os.listdir(movie_dir)) == ["imgs", "movie.mp4", "multi.mp4", "project.json", "tree.npz"]
    assert sorted(os.listdir(movie_dir / "imgs")) == sorted([f"lowres_img_{i:04d}.jpg" for i in range(7)] + ["lowres.yaml"])
    assert np.array_equal(np.load(movie_dir / "tree.npz")["imgs"], results[mesh][0]["imgs"])
    # rank 0 opened both movies and the tree cache; no other rank opened any
    assert [res["opened"].tolist() for res in results[mesh]] == [[2, 1]] + [[0, 0]] * (len(results[mesh]) - 1)
    from latentblending_tpu_torch.engine.session import MovieProject
    from latentblending_tpu_torch.video.mjpeg_mp4 import read_samples

    assert [k.seed for k in MovieProject.load(str(movie_dir / "project.json")).keyframes] == SEEDS
    # 0.5 s at 10 fps is fewer frames than the part's 7 keyframes: one each
    assert len(read_samples(str(movie_dir / "multi.mp4"))[0]) == 7
    be = BlendingEngine(tdh)
    be.tree_final_imgs = list(results[mesh][0]["imgs"])
    fp = workdir / f"unsharded_{d}x{m}.mp4"
    be.write_movie_transition(str(fp), **MOVIE)
    assert (movie_dir / "movie.mp4").read_bytes() == fp.read_bytes()


# --------------------------------------------------------- single process


def test_pad_to_multiple_and_trivial_mesh():
    assert [pad_to_multiple(n, 8) for n in (5, 8, 9)] == [8, 8, 16]
    assert pad_to_multiple(3, 1) == 3
    mesh = make_mesh(1, 1)
    assert mesh.shape == {"data": 1, "model": 1} and not mesh.distributed
    assert (mesh.rank, mesh.data_index, mesh.model_index) == (0, 0, 0)
    with pytest.raises(ValueError, match="process group"):
        make_mesh(2, 1)
    assert auto_mesh() is None
    x = torch.arange(12.0).reshape(3, 4)
    from latentblending_tpu_torch.parallel.mesh import gather_stem_batch, shard_stem_batch

    assert torch.equal(gather_stem_batch(shard_stem_batch(x, mesh), mesh), x)
    assert torch.equal(shard_stem_batch(x, Mesh(3, 1, rank=1), 0), x[1:2])
    assert torch.equal(shard_stem_batch(x, Mesh(2, 2, rank=3), 1), x[:, 2:])


def test_jax_padded_draws_keep_the_real_rows():
    """The JAX holder draws a padded batch's ancestral noise at the padded
    shape, the port at the unsharded one: the real rows agree because
    JAX's partitionable threefry draws each element from its index."""
    import jax

    from tests.torch_port_util import jax_ancestral_draws

    assert jax.config.jax_threefry_partitionable
    padded = jax_ancestral_draws(7, 3, 2, (8, 4, 4, 4))
    assert np.array_equal(padded[:, :5], jax_ancestral_draws(7, 3, 2, (5, 4, 4, 4)))


def test_init_distributed_single_process(monkeypatch):
    from latentblending_tpu_torch.parallel import distributed

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.init_distributed() is False
    assert distributed.global_mesh().shape == {"data": 1, "model": 1}


def _meta_unet(cfg, pooled: int):
    from latentblending_tpu_torch.models.unet import UNet2DCondition

    with torch.device("meta"):
        return UNet2DCondition(cfg, pooled)


JAX_SPEC = {None: "PartitionSpec()", ("column", 0, 2): "PartitionSpec(None, 'model')",
            ("column", 0, 1): "PartitionSpec('model',)", ("row", 1, 2): "PartitionSpec('model', None)"}
# The rules differ where an attention block's heads do not divide the model
# axis: JAX shards its projections through a head, the port replicates the
# block. In the tiny UNet (heads 1, 2, 4; the 1-head level has no
# attention) that is n_model=4 on the 2-head level's blocks.
TINY_DIFFER = {
    2: set(),
    4: {f"{blk}.transformer_blocks.0.{attn}.{p}.weight"
        for blk in ("down_blocks.1.attentions.0", "up_blocks.1.attentions.0", "up_blocks.1.attentions.1")
        for attn in ("attn1", "attn2") for p in ("to_q", "to_k", "to_v", "to_out.0")},
}


@pytest.mark.parametrize("n_model", [2, 4])
def test_tp_specs_match_jax_on_tiny_unet(n_model):
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict

    from latentblending_tpu.models import configs as JC
    from latentblending_tpu.models.unet import UNet2DCondition as JUNet
    from latentblending_tpu.parallel.mesh import make_mesh as jmake_mesh
    from latentblending_tpu.parallel.tp import unet_tp_specs as junet_tp_specs
    from latentblending_tpu_torch.models.weights import jax_path

    ju = JUNet(JC.TINY_UNET)
    abstract = jax.eval_shape(ju.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 4)), jnp.float32(0.0),
                              jnp.zeros((1, 77, 64)), jnp.zeros((1, 48)), jnp.zeros((1, 6)))["params"]
    jspecs = flatten_dict(junet_tp_specs(abstract, jmake_mesh(n_data=8 // n_model, n_model=n_model)))
    unet = _meta_unet(TC.TINY_UNET, 48)
    specs = ttp.unet_tp_specs(unet, Mesh(1, n_model))
    params = dict(unet.named_parameters())
    assert set(specs) == set(params)
    differ = set()
    for key, spec in specs.items():
        path, _ = jax_path(key, params[key].ndim, "unet")
        want = JAX_SPEC[None if spec is None else spec + (params[key].ndim,)]
        if str(jspecs[path]) != want:
            differ.add(key)
    assert differ == TINY_DIFFER[n_model]
    for key in differ:  # where they differ, JAX shards and the port replicates
        assert specs[key] is None and "model" in str(jspecs[jax_path(key, params[key].ndim, "unet")[0]])
    assert sum(s is not None for s in specs.values()) > 0


@pytest.mark.parametrize("spec", ["sdxl-base", "sdxl-turbo"])
def test_tp_specs_real_sdxl_strict_no_fallback(spec):
    """SDXL's real shapes (heads 10 and 20, d=64; inner 2560 and 5120) shard
    over n_model=2 with strict on: no block falls back, and the sharded
    share of the parameters is the JAX test's (tests/test_tp_real_shapes.py)."""
    from latentblending_tpu_torch.runtime.holder import SPECS

    s = SPECS[spec]
    unet = _meta_unet(s.unet, s.pooled_dim)
    specs = ttp.unet_tp_specs(unet, Mesh(1, 2), strict=True)
    n_sharded = sum(v is not None for v in specs.values())
    assert n_sharded >= 700, n_sharded
    sizes = {k: p.numel() for k, p in unet.named_parameters()}
    share = sum(sizes[k] for k, v in specs.items() if v is not None) / sum(sizes.values())
    assert share > 0.4, share


def test_tp_fallback_warns_and_strict_raises(caplog, monkeypatch):
    unet = _meta_unet(TC.TINY_UNET, 48)
    mesh = Mesh(1, 4)  # the 2-head level's blocks do not split over 4
    with caplog.at_level(logging.WARNING, logger="latentblending_tpu_torch.parallel.tp"):
        specs = ttp.unet_tp_specs(unet, mesh, strict=False)
    key = "down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_q.weight"
    assert specs[key] is None
    warnings = [r.message for r in caplog.records if "REPLICATED" in r.message]
    # one warning per (rule, size): to_q|k|v and to_out.0 of the 2-head level
    assert len(warnings) == 2, warnings
    with pytest.raises(ValueError, match="does not divide"):
        ttp.unet_tp_specs(unet, mesh, strict=True)
    monkeypatch.setenv("LB_TP_STRICT", "1")
    with pytest.raises(ValueError, match="does not divide"):
        ttp.unet_tp_specs(unet, mesh)


class _LockstepMesh(Mesh):
    """Rank `rank` of an in-process model group whose ranks run on threads:
    all_reduce sums every rank's partial, in rank order."""

    def __init__(self, rank: int, n: int, slots: list, barrier: threading.Barrier):
        super().__init__(1, n, rank)
        self.slots, self.sync = slots, barrier

    def all_reduce(self, x, group):
        self.slots[self.rank] = x
        self.sync.wait()
        total = sum(self.slots[1:], self.slots[0].clone())
        self.sync.wait()
        return total


def _block(seed: int = 0) -> BasicTransformerBlock:
    torch.manual_seed(seed)
    blk = BasicTransformerBlock(64, 4, 16, context_dim=32).eval()
    with torch.no_grad():
        for p in blk.parameters():  # biases and norms too: nothing left at 0/1
            p.copy_(torch.randn_like(p) * 0.2)
    return blk


def _sharded_block(n: int, x, ctx, tamper=None) -> torch.Tensor:
    """Each rank's shard of _block() run on its own thread in lockstep;
    returns rank 0's output (every rank's must be the same)."""
    import copy

    from latentblending_tpu_torch.parallel.tp import shard_unet_params

    slots, sync = [None] * n, threading.Barrier(n)
    outs, errs = [None] * n, []
    base = _block()

    class Wrap(torch.nn.Module):  # the rules match keys under a UNet-like prefix
        def __init__(self, blk):
            super().__init__()
            self.transformer_blocks = torch.nn.ModuleList([blk])

    def run(rank):
        try:
            h = Wrap(copy.deepcopy(base))
            shard_unet_params(h, _LockstepMesh(rank, n, slots, sync))
            with torch.no_grad():
                if tamper is not None:
                    tamper(h.transformer_blocks[0], rank)
                outs[rank] = h.transformer_blocks[0](x, ctx)
        except BaseException as e:  # re-raised below, after the join
            errs.append(e)
            sync.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    if errs:
        raise errs[0]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    return outs[0]


def _inputs():
    g = torch.Generator().manual_seed(1)
    return torch.randn(2, 24, 64, generator=g), torch.randn(2, 7, 32, generator=g)


@pytest.mark.parametrize("n", [2, 4])
def test_block_sharding_math(n):
    """The column- and row-parallel slices of one transformer block (both
    attentions and the GEGLU feed-forward), their partials summed across
    the ranks, give the unsharded block (f32; bound 1e-5: the partial sums
    add in another order)."""
    x, ctx = _inputs()
    with torch.no_grad():
        want = _block()(x, ctx)
    got = _sharded_block(n, x, ctx)
    assert (got - want).abs().max().item() < 1e-5 * max(1.0, want.abs().max().item())


def test_block_sharding_fails_with_a_contiguous_geglu_split():
    """A contiguous split of GEGLU's 2·inner outputs (rank 0 all of h,
    rank 1 all of gate) breaks the block: the test above would catch it."""
    x, ctx = _inputs()
    full = _block()

    def contiguous(blk, rank):
        proj = full.ff.net[0].proj
        half = proj.out_features // 2
        blk.ff.net[0].proj.weight.copy_(proj.weight[rank * half:(rank + 1) * half])
        blk.ff.net[0].proj.bias.copy_(proj.bias[rank * half:(rank + 1) * half])

    with torch.no_grad():
        want = full(x, ctx)
    got = _sharded_block(2, x, ctx, tamper=contiguous)
    assert (got - want).abs().max().item() > 1e-2


def test_block_sharding_fails_with_bias_on_every_rank(monkeypatch):
    """A row-parallel layer that adds its bias before the sum (on every
    rank) breaks the block."""
    import torch.nn.functional as F

    def every_rank(self, x):
        return self.mesh.all_reduce(F.linear(x, self.weight, self.bias).float(), None).to(x.dtype)

    x, ctx = _inputs()
    with torch.no_grad():
        want = _block()(x, ctx)
    monkeypatch.setattr(ttp.RowParallelLinear, "forward", every_rank)
    got = _sharded_block(2, x, ctx)
    assert (got - want).abs().max().item() > 1e-2


def test_mesh_engine_takes_the_per_level_path(monkeypatch):
    """Under a mesh the three fused gates are shut: the cost model and the
    auto gate pick the per-level path, the segmented scan is not fusable,
    and the holder refuses the fused tree scans. The trivial (1, 1) mesh's
    keyframes are byte-equal to the unsharded per-level run's."""
    from latentblending_tpu_torch.engine.blending import BlendingEngine
    from latentblending_tpu_torch.runtime.holder import SDXLHolder

    torch.set_num_threads(1)
    mk = lambda mesh: _setup(BlendingEngine(SDXLHolder.from_random(  # noqa: E731
        "tiny-turbo", seed=0, dtype=torch.float32, device="cpu", mesh=mesh)))
    be = mk(make_mesh(1, 1))
    assert be.predict_transition_time()["path"] == "per-level"
    imgs = be.run_transition(fixed_seeds=SEEDS)
    assert not be.last_report.levels[0].get("fused")
    be.placement_policy = "predictive"
    be.list_idx_injection, be.list_nmb_stems = [1, 2], [2, 2]
    assert not be._multilevel_fusable()
    lat = torch.zeros((3, 16, 16, 4))
    cond = be.dh._conditioning(be.text_embedding1, 3)
    with pytest.raises(RuntimeError, match="single-device"):
        be.dh.run_tree_batched(cond, lat, np.zeros((3, 2), int), np.zeros(3), np.zeros((4, 3)))
    with pytest.raises(RuntimeError, match="single-device"):
        be.dh.run_tree_seg_batched(cond, lat, np.zeros((3, 2), int), np.zeros(3), np.zeros((4, 3)),
                                   torch.zeros(3), ((0, 3),))
    monkeypatch.setenv("LB_FUSED", "0")
    plain = mk(None).run_transition(fixed_seeds=SEEDS)
    assert len(imgs) == len(plain) == 7
    assert all(np.array_equal(a, b) for a, b in zip(imgs, plain))


if __name__ == "__main__" and sys.argv[1:2] == ["child"]:
    sys.exit(_child_main(sys.argv[1:]))
