"""The slice end to end on the CPU: DADD.generate parity with psd_tpu, and
the port's GenerationServer.

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
