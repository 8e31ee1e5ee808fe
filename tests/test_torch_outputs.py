"""The port's keyframe outputs against the JAX package, and its streaming
keyframe contract.

- SDXLHolder.to_i420_device, port vs JAX and vs the host conversion
  video/i420.rgb_to_i420: planes within 1 (a float32 [-1,1] round trip can
  move a value across a .5 boundary; the bound of tests/test_i420.py).
- latents2images_batched / latent2image / pm1_to_uint8, port vs JAX, same
  weights: uint8 within 1 LSB.
- run_transition_streaming + resolve_image + finalize_report(sync_sims=
  False): I420 handles resolve to planes within 1 of the RGB keyframes'
  host conversion; the deferred similarities land later, equal to the
  synchronous ones (rtol 1e-6).
- The handles keep their fetch chunk's uint8 batch (one tensor shared by
  a chunk's handles, each its row) for the movie writer, and let go of it
  once resolve_keyframes has replaced them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentblending_tpu.runtime.holder import SDXLHolder as JHolder
from latentblending_tpu_torch.engine.blending import BlendingEngine, _PendingImage, resolve_image
from latentblending_tpu_torch.runtime.holder import SDXLHolder
from latentblending_tpu_torch.video.i420 import rgb_to_i420, to_rgb
from tests.torch_port_util import port_holder_from_jax


def test_to_i420_device_matches_jax_and_host():
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (3, 32, 48, 3), dtype=np.uint8)
    pm1 = rgb.astype(np.float32) / 255.0 * 2.0 - 1.0
    got = SDXLHolder.to_i420_device(torch.from_numpy(pm1)).numpy()
    want = np.asarray(JHolder.to_i420_device(jnp.asarray(pm1)))
    assert got.shape == want.shape == (3, 48, 48) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    for b in range(3):
        assert np.abs(got[b].astype(int) - rgb_to_i420(rgb[b]).astype(int)).max() <= 1
    with pytest.raises(ValueError, match="I420"):
        SDXLHolder.to_i420_device(torch.zeros(1, 30, 48, 3))


@pytest.fixture(scope="module")
def holders():
    jdh = JHolder.from_random("tiny-turbo", seed=0, dtype=jnp.float32)
    return jdh, port_holder_from_jax(jdh, "tiny-turbo")


def test_decoded_images_match_jax(holders):
    """Five latents (decode chunks of 4 + 1) through latents2images_batched,
    and one through latent2image (round to nearest), on both packages."""
    jdh, tdh = holders
    lat = np.random.default_rng(11).normal(size=(5, 16, 16, 4)).astype(np.float32)
    got = tdh.latents2images_batched(torch.from_numpy(lat))
    want = jdh.latents2images_batched(jnp.asarray(lat))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.shape == (128, 128, 3) and g.dtype == np.uint8
        assert np.abs(g.astype(int) - np.asarray(w).astype(int)).max() <= 1
    one = tdh.latent2image(torch.from_numpy(lat[2]))
    assert one.shape == (128, 128, 3) and one.dtype == np.uint8
    assert np.abs(one.astype(int) - jdh.latent2image(jnp.asarray(lat[2])).astype(int)).max() <= 1
    pm1 = tdh.decode_to_pm1_batched(torch.from_numpy(lat[:2]))
    np.testing.assert_array_equal(tdh.pm1_to_uint8(pm1), np.stack(got[:2]))


def test_streaming_contract(monkeypatch):
    monkeypatch.delenv("LB_FUSED", raising=False)
    monkeypatch.delenv("LB_KEYFRAME_I420", raising=False)
    be = BlendingEngine(SDXLHolder.from_random("tiny-turbo", seed=2, dtype=torch.float32, device="cpu"))
    be.set_prompt1("a forest")
    be.set_prompt2("a city")
    rgb = [im.copy() for im in be.run_transition(fixed_seeds=[3, 4])]
    sims = list(be.tree_similarities)
    assert be._sims_pending is None and be.last_report.lpips_gaps == sims and len(sims) == 11

    # 'auto' ships I420 planes when the dimensions allow it
    handles = be.run_transition_streaming(fixed_seeds=[3, 4])
    assert all(isinstance(h, _PendingImage) for h in handles)
    cache: dict = {}
    planes = [resolve_image(h, cache) for h in handles]
    assert len(cache) == 3  # one host batch per chunk of LB_FETCH_CHUNK=4
    for p, r in zip(planes, rgb):
        assert p.shape == (192, 128) and p.dtype == np.uint8
        assert np.abs(p.astype(int) - rgb_to_i420(r).astype(int)).max() <= 1
    report = be.finalize_report(sync_sims=False)
    assert report.sims_pending is not None and report.lpips_gaps == [] and be.tree_similarities == []
    assert report.num_keyframes == 12
    imgs = be.resolve_keyframes(cache)
    for im, p in zip(imgs, planes):
        np.testing.assert_array_equal(im, to_rgb(p))
    report.resolve_sims()
    np.testing.assert_allclose(report.lpips_gaps, sims, rtol=1e-6)

    # the next transition drains the deferred tail first; 'rgb' handles
    # resolve to the run_transition keyframes exactly
    handles = be.run_transition_streaming(fixed_seeds=[3, 4], keyframe_format="rgb")
    assert be._queue_tail is None
    for h, r in zip(handles, rgb):
        np.testing.assert_array_equal(resolve_image(h, {}), r)
    np.testing.assert_allclose(be.finalize_report().lpips_gaps, sims, rtol=1e-6)
    monkeypatch.setenv("LB_KEYFRAME_I420", "0")
    handles = be.run_transition_streaming(fixed_seeds=[3, 4])
    assert resolve_image(handles[0], {}).shape == (128, 128, 3)
    with pytest.raises(ValueError):
        be.run_transition_streaming(fixed_seeds=[3, 4], keyframe_format="yuv")


def test_streaming_handles_hold_their_chunk(monkeypatch):
    monkeypatch.delenv("LB_FUSED", raising=False)
    monkeypatch.delenv("LB_KEYFRAME_I420", raising=False)
    monkeypatch.delenv("LB_FETCH_CHUNK", raising=False)
    be = BlendingEngine(SDXLHolder.from_random("tiny-turbo", seed=2, dtype=torch.float32, device="cpu"))
    be.set_prompt1("a forest")
    be.set_prompt2("a city")
    handles = be.run_transition_streaming(fixed_seeds=[3, 4])
    batches = [h.device_batch for h in handles]
    # the fused path's chunks of LB_FETCH_CHUNK=4 in fract order: one uint8 I420 batch each
    assert [id(b) for b in batches] == [id(batches[4 * (i // 4)]) for i in range(12)]
    assert [h.row for h in handles] == [i % 4 for i in range(12)]
    for h in handles:
        assert h.ready is None and h.device_batch.dtype == torch.uint8  # no event on the CPU
        np.testing.assert_array_equal(h.device_batch[h.row].numpy(), resolve_image(h, {}))
    be.finalize_report()
    imgs = be.resolve_keyframes()
    assert all(h.device_batch is None and h.ready is None for h in handles)
    assert all(im.shape == (128, 128, 3) for im in imgs)


@pytest.mark.gpu
def test_host_copy_handle_on_gpu():
    """A CUDA keyframe batch becomes a pinned host copy behind a CUDA event;
    reading it waits for the copy and gives the device values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (pinned copies and events have no CPU mode)")
    from latentblending_tpu_torch.engine.blending import _fetch, _HostCopy

    dev = torch.randint(0, 256, (4, 768, 512), dtype=torch.uint8, device="cuda")
    h = _fetch(dev)
    assert isinstance(h, _HostCopy) and h.host.is_pinned()
    np.testing.assert_array_equal(resolve_image(_PendingImage(h, 2), {}), dev[2].cpu().numpy())
    cpu = torch.arange(6, dtype=torch.float32)
    assert _fetch(cpu) is cpu
