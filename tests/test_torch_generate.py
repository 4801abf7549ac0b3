"""The slice end to end on the CPU: DADD.generate parity with psd_tpu, and
the port's GenerationServer; `DADD.sample` then `decode_latents` against
psd_tpu's generate, `GenerationServer(fused=False)` against `fused=True`,
the captured programs' key, and that the CPU path captures no CUDA graph
(on the card generate, sample and decode_latents replay graphs; there
chip_smoke.py holds each replay against the eager run).

generate: tiny_dadd(), 4 DDIM steps, steer 1.0, the same bridged
parameters and the same initial latents (drawn by psd_tpu's own recipe,
dadd.py:483-487, and handed to the port). Tolerance atol 1e-4 on images in
[0, 1]: fp32 on both sides, the UNet band (2e-4 relative) carried through
four sampler steps and the decoder.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psd_tpu.testing import tiny_dadd as jax_tiny_dadd
from psd_tpu_torch.core.mode import (disable_kernels, eager, is_eager, kernel_disabled,
                                     training_mode)
from psd_tpu_torch.diffusion import dadd as dadd_module
from psd_tpu_torch.diffusion import graphs
from psd_tpu_torch.diffusion.graphs import program_key
from psd_tpu_torch.pipelines.serve import GenerationServer
from psd_tpu_torch.testing import tiny_dadd


@pytest.fixture(scope="module")
def pair():
    model = jax_tiny_dadd()
    core = jax.device_get(model.init_core(jax.random.PRNGKey(0), image_size=32))
    vae = jax.device_get(model.vae.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)),
                                        jax.random.PRNGKey(2)))
    return model, core, vae, tiny_dadd(seed=None).load_flax(core, vae)


@pytest.mark.parametrize("steer,guidance", [(0.0, None), (1.0, None), (1.0, 2.5)])
def test_generate_matches_psd_tpu(pair, steer, guidance):
    """guidance: classifier-free guidance against the zero-AOE, zero-image
    conditioning, as one UNet call at twice the batch on both sides."""
    model, core, vae, port = pair
    rng = np.random.default_rng(8)
    feats = rng.standard_normal((2, 17, 32)).astype(np.float32)
    tgt = np.array([3.0, 0.5], np.float32)
    src = np.array([0.0, 2.0], np.float32)
    cond = model.prepare_inference_cond(core, jnp.asarray(tgt), jnp.asarray(src),
                                        jnp.asarray(feats))
    kw_j, kw_t = {}, {}
    if guidance is not None:
        unc = model.prepare_inference_cond(core, jnp.asarray(tgt), jnp.asarray(src),
                                           jnp.asarray(feats), zero_aoe=True, zero_image=True)
        kw_j = dict(cond_uncond=unc, guidance_scale=guidance)
        kw_t = dict(cond_uncond=port.prepare_inference_cond(tgt, src, feats, zero_aoe=True,
                                                            zero_image=True),
                    guidance_scale=guidance)
    key = jax.random.PRNGKey(11)
    ref = np.asarray(model.generate(core, vae, cond, key, image_size=32, sampling_steps=4,
                                    steer_scale=steer, **kw_j))
    # psd_tpu's initial latents for shared_noise=True, handed to the port
    x0 = np.tile(np.asarray(jax.random.normal(key, (1, 16, 16, 4), jnp.float32)),
                 (2, 1, 1, 1))
    cond_t = port.prepare_inference_cond(tgt, src, feats)
    out = port.generate(cond_t, x0=torch.from_numpy(x0), image_size=32, sampling_steps=4,
                        steer_scale=steer, **kw_t).numpy()
    assert out.shape == (2, 32, 32, 3)
    assert out.min() >= 0.0 and out.max() <= 1.0
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_generate_draws_from_generator():
    port = tiny_dadd(seed=3)
    cond = port.prepare_inference_cond([1.0, 2.0], [0.0, 0.0],
                                       np.zeros((2, 17, 32), np.float32))

    def run(seed, shared):
        g = torch.Generator().manual_seed(seed)
        return port.generate(cond, generator=g, image_size=32, sampling_steps=2,
                             shared_noise=shared)

    a, b = run(5, False), run(5, False)
    assert torch.equal(a, b)
    assert not torch.equal(a, run(6, False))
    with pytest.raises(ValueError):
        port.generate(cond, image_size=32)


def test_server_batches_and_fulfills():
    """5 requests > max_batch=4: one full and one padded batch
    (tests/test_serve.py's scenario on the port)."""
    port = tiny_dadd(seed=0)
    server = GenerationServer(port, image_size=32, sampling_steps=2, max_batch=4,
                              max_wait_s=0.2)
    rng = np.random.default_rng(0)
    futures = [server.submit(rng.normal(size=(17, 32)).astype(np.float32),
                             target_label=t, source_label=1.0, seed=0)
               for t in [0.0, 1.0, 2.0, 3.0, 1.5]]
    images = [f.result(timeout=300) for f in futures]
    server.close()
    assert not server._worker.is_alive()
    assert all(img.shape == (32, 32, 3) for img in images)
    assert all(np.isfinite(img).all() for img in images)
    assert not np.allclose(images[0], images[3])


def test_server_pipelined_close_drains():
    """pipeline_depth=2 with several batches in flight; close() right after
    submitting still resolves every request."""
    port = tiny_dadd(seed=1)
    server = GenerationServer(port, image_size=32, sampling_steps=2, max_batch=2,
                              max_wait_s=0.05, pipeline_depth=2)
    rng = np.random.default_rng(3)
    futures = [server.submit(rng.normal(size=(17, 32)).astype(np.float32),
                             float(i % 4), 0.0, seed=i) for i in range(5)]
    server.close()
    images = [f.result(timeout=300) for f in futures]
    assert not server._worker.is_alive()
    assert all(img.shape == (32, 32, 3) and np.isfinite(img).all() for img in images)


def test_bf16_generate_tracks_fp32():
    """The serving dtype on the CPU: bf16 UNet compute with the weights
    stored in bf16 (as DADD does on the GPU) stays within the bf16 band of
    the fp32 model (atol 0.05 on images in [0, 1])."""
    f32 = tiny_dadd(seed=4)
    b16 = tiny_dadd(seed=4, dtype=torch.bfloat16)
    w = b16.core.unet.conv_in.weight
    assert w.dtype == torch.bfloat16 and b16.core.unet.conv_in.bias.dtype == torch.float32
    feats = np.random.default_rng(9).standard_normal((2, 17, 32)).astype(np.float32)
    x0 = torch.from_numpy(np.random.default_rng(10).standard_normal((2, 16, 16, 4))
                          .astype(np.float32))
    imgs = [m.generate(m.prepare_inference_cond([0.0, 3.0], [1.0, 1.0], feats), x0=x0,
                       image_size=32, sampling_steps=3, steer_scale=1.0) for m in (f32, b16)]
    assert imgs[1].dtype == torch.float32
    np.testing.assert_allclose(imgs[1].numpy(), imgs[0].numpy(), atol=0.05)


@pytest.mark.parametrize("guidance", [None, 2.5])
def test_sample_then_decode_matches_psd_tpu(pair, guidance):
    """The two programs of the unfused path, DADD.sample then
    decode_latents, against psd_tpu's one-program generate with the same
    noise (the setup of test_generate_matches_psd_tpu, steer 1.0)."""
    model, core, vae, port = pair
    rng = np.random.default_rng(12)
    feats = rng.standard_normal((2, 17, 32)).astype(np.float32)
    tgt = np.array([2.0, 1.0], np.float32)
    src = np.array([0.5, 3.0], np.float32)
    cond = model.prepare_inference_cond(core, jnp.asarray(tgt), jnp.asarray(src),
                                        jnp.asarray(feats))
    kw_j, kw_t = {}, {}
    if guidance is not None:
        unc = model.prepare_inference_cond(core, jnp.asarray(tgt), jnp.asarray(src),
                                           jnp.asarray(feats), zero_aoe=True, zero_image=True)
        kw_j = dict(cond_uncond=unc, guidance_scale=guidance)
        kw_t = dict(cond_uncond=port.prepare_inference_cond(tgt, src, feats, zero_aoe=True,
                                                            zero_image=True),
                    guidance_scale=guidance)
    key = jax.random.PRNGKey(13)
    ref = np.asarray(model.generate(core, vae, cond, key, image_size=32, sampling_steps=4,
                                    steer_scale=1.0, **kw_j))
    x0 = np.tile(np.asarray(jax.random.normal(key, (1, 16, 16, 4), jnp.float32)),
                 (2, 1, 1, 1))
    lat = port.sample(port.prepare_inference_cond(tgt, src, feats), torch.from_numpy(x0), 4,
                      1.0, **kw_t)
    assert lat.shape == (2, 16, 16, 4) and lat.dtype == torch.float32
    out = port.decode_latents(lat).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("turbo", [
    {},
    dict(sampler="dpm", encoder_stride=2, cache_mode="deep"),
], ids=["exact", "turbo"])
def test_server_unfused_matches_fused(turbo):
    """fused=False (two programs: sample, then decode_latents) gives the
    same images as fused=True (generate), the counterpart of psd_tpu's
    tests/test_serve.py:92; on the CPU both run op by op on the same noise,
    so bit for bit."""
    port = tiny_dadd(seed=2)
    feats = np.random.default_rng(5).standard_normal((3, 17, 32)).astype(np.float32)
    out = {}
    for fused in (True, False):
        server = GenerationServer(port, image_size=32, sampling_steps=4, max_batch=2,
                                  max_wait_s=0.05, fused=fused, pipeline_depth=1, **turbo)
        futures = [server.submit(feats[i], float(i), 0.0, seed=7) for i in range(3)]
        out[fused] = [f.result(timeout=300) for f in futures]
        server.close()
        assert not server._worker.is_alive()
    for a, b in zip(out[True], out[False]):
        np.testing.assert_array_equal(a, b)


KNOBS = dict(sampling_steps=4, steer_scale=1.0, guidance_scale=1.0, encoder_stride=1,
             cache_mode="encoder", sampler="ddim")
COND, X0 = torch.zeros((2, 12, 32)), torch.zeros((2, 16, 16, 4))


def _key(port, kind="generate", inputs=(COND, X0), **change):
    return program_key(kind, inputs, **port.static_knobs(**{**KNOBS, **change}))


def test_graph_key_is_a_pure_function_of_the_knobs():
    """Equal knobs give equal keys, whichever model or call computes them;
    a knob given as an int or a float is the same knob."""
    a, b = tiny_dadd(seed=0), tiny_dadd(seed=1)
    assert _key(a) == _key(a) == _key(b)
    assert _key(a, steer_scale=1, guidance_scale=1) == _key(a)
    # the default steps are the config's
    assert _key(a, sampling_steps=None) == _key(a, sampling_steps=a.cfg.diffusion.sampling_steps)
    hash(_key(a))


@pytest.mark.parametrize("change", [
    dict(steer_scale=0.5), dict(guidance_scale=2.5), dict(sampler="dpm"),
    dict(encoder_stride=2), dict(cache_mode="deep"), dict(sampling_steps=5),
], ids=["steer", "guidance", "sampler", "stride", "cache_mode", "steps"])
def test_graph_key_changes_with_each_knob(change):
    port = tiny_dadd(seed=0)
    assert _key(port, **change) != _key(port)


@pytest.mark.parametrize("inputs,kind", [
    ((COND, X0, COND), "generate"),                              # CFG on
    ((torch.zeros((4, 12, 32)), torch.zeros((4, 16, 16, 4))), "generate"),  # batch
    ((COND, torch.zeros((2, 32, 32, 4))), "generate"),           # image size
    ((COND, X0), "sample"),                                      # another program
], ids=["cfg", "batch", "image_size", "kind"])
def test_graph_key_changes_with_inputs_and_kind(inputs, kind):
    port = tiny_dadd(seed=0)
    assert _key(port, kind, inputs) != _key(port)


@pytest.mark.parametrize("flags", ["disable_kernels", "training_mode"])
def test_graph_key_holds_the_mode_flags(flags):
    """A graph bakes in the kill switches and the training flag it was
    captured under, so each enters the key."""
    port = tiny_dadd(seed=0)
    base = _key(port)
    ctx = disable_kernels("split3") if flags == "disable_kernels" else training_mode()
    with ctx:
        changed = _key(port)
    assert changed != base and _key(port) == base


def test_cpu_path_captures_no_cuda_graph(monkeypatch):
    """On the CPU generate, sample, decode_latents and both server paths
    run op by op: nothing constructs a torch.cuda.CUDAGraph or a captured
    program, and the model keeps none."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA graph on the CPU path")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    monkeypatch.setattr(graphs, "CapturedProgram", refuse)
    monkeypatch.setattr(dadd_module, "CapturedProgram", refuse)
    port = tiny_dadd(seed=5)
    feats = np.random.default_rng(6).standard_normal((2, 17, 32)).astype(np.float32)
    cond = port.prepare_inference_cond([1.0, 2.0], [0.0, 0.0], feats)
    x0 = torch.zeros((2, 16, 16, 4))
    a = port.generate(cond, x0=x0, image_size=32, sampling_steps=2)
    b = port.decode_latents(port.sample(cond, x0, 2))
    assert torch.equal(a, b)
    for fused in (True, False):
        server = GenerationServer(port, image_size=32, sampling_steps=2, max_batch=2,
                                  max_wait_s=0.05, fused=fused)
        img = server.submit(feats[0], 1.0, 0.0).result(timeout=300)
        server.close()
        assert img.shape == (32, 32, 3)
    assert port.programs == {}


def test_failed_capture_raises_again_without_capturing(monkeypatch):
    """A key whose capture failed raises at every later call without
    capturing again (torch keeps a failed capture's pool, so each attempt
    would hold another); other keys still capture, and clearing
    `failed_captures` lets the key capture again. The card is stood in for
    by the model's device and a program that fails its first capture."""
    attempts = []

    class Program:
        def __init__(self, body, inputs):
            attempts.append(tuple(inputs[0].shape))
            if len(attempts) == 1:
                raise RuntimeError("operation not permitted when stream is capturing")
            self.body = body

        def __call__(self, *inputs):
            return self.body(*inputs)

    monkeypatch.setattr(dadd_module, "CapturedProgram", Program)
    port = tiny_dadd(seed=7)
    port.device = torch.device("cuda")
    lat, other = torch.zeros((1, 8, 8, 4)), torch.zeros((2, 8, 8, 4))
    with pytest.raises(RuntimeError, match="stream is capturing"):
        port.decode_latents(lat)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="failed to capture before"):
            port.decode_latents(lat)
    assert attempts == [(1, 8, 8, 4)]
    assert port.programs == {} and len(port.failed_captures) == 1
    assert port.decode_latents(other).shape == (2, 16, 16, 3)
    port.failed_captures.clear()
    assert port.decode_latents(lat).shape == (1, 16, 16, 3)
    assert attempts == [(1, 8, 8, 4), (2, 8, 8, 4), (1, 8, 8, 4)] and len(port.programs) == 2


def test_server_worker_runs_in_the_construction_context():
    """The worker thread sees the mode flags in force where the server was
    built: eager() and disable_kernels(...) around the construction hold
    for every batch, and a server built outside them sees neither."""
    port = tiny_dadd(seed=6)
    seen = []
    real = port.generate

    def spy(*args, **kwargs):
        seen.append((is_eager(), kernel_disabled("split3")))
        return real(*args, **kwargs)

    port.generate = spy
    feats = np.zeros((17, 32), np.float32)
    with eager(), disable_kernels("split3"):
        server = GenerationServer(port, image_size=32, sampling_steps=1, max_batch=1)
    server.submit(feats, 1.0, 0.0).result(timeout=300)
    server.close()
    server = GenerationServer(port, image_size=32, sampling_steps=1, max_batch=1)
    server.submit(feats, 1.0, 0.0).result(timeout=300)
    server.close()
    assert seen == [(True, True), (False, False)]
