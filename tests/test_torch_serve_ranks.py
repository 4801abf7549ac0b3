"""Sampling and serving across ranks (`DADD.sample(mesh=)`,
`decode_latents(mesh=)`, `GenerationServer(mesh=)`) on two gloo ranks on
the CPU (tests/torch_dist.py: spawned processes, a file:// store, two
threads and a timeout each), all cases in one spawn at the tiny config
(32², 4 steps, steer 1.0).

Bands, with their reasons:
  * the ranks at (dp 2, fsdp 1), and at (dp 1, fsdp 2) with CFG 2.5,
    against psd_tpu's `DADD.sample(mesh=create_mesh(MeshConfig(...)))` on
    conftest's virtual CPU devices, then its decode, on the same
    parameters (the port's seeded weights in psd_tpu's layout) with JAX's
    per-sample noise fed as x0: atol 1e-4 on images in [0, 1], the
    one-process parity test's band (tests/test_torch_generate.py);
    psd_tpu's own sharded-vs-single gap is rtol 2e-4 / atol 1e-4
    (tests/test_dadd.py);
  * DDIM with eta 0.5 on the ranks against the port's one process on the
    same eta_noise, and the servers on the ranks against the port's
    one-process server on the same requests and seeds: fp32 on the CPU at
    2 rows a rank against 4, the same operations row by row, so bit for
    bit;
  * every rank holds the whole batch: the ranks' images are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from psd_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from psd_tpu.parallel.mesh import create_mesh as jax_create_mesh
from psd_tpu.testing import tiny_dadd as jax_tiny_dadd
from psd_tpu_torch.pipelines.serve import GenerationServer
from psd_tpu_torch.testing import tiny_dadd
from tests.torch_cli_parity import few_threads, seeded_load_params
from tests.torch_dist import SERVE_TURBO, Ranks, serve_ranks

B, STEPS, GUIDANCE = 4, 4, 2.5
MESHES = {"dp2": (2, 1), "fsdp2_cfg": (1, 2)}


def _inputs():
    """The global batch every rank gets: CLIP features, labels, JAX's
    per-sample initial noise, eta noise, and six requests (seeds 3..8: two
    batches at max_batch 4, led by seeds 3 and 7)."""
    rng = np.random.default_rng(31)
    key = jax.random.PRNGKey(41)
    req = rng.standard_normal((6, 17, 32)).astype(np.float32)
    return {"feats": rng.standard_normal((B, 17, 32)).astype(np.float32),
            "tgt": np.array([3.0, 0.5, 2.0, 1.0], np.float32),
            "src": np.array([0.0, 2.0, 1.0, 3.0], np.float32),
            "x0": np.array(jax.random.normal(key, (B, 16, 16, 4), jnp.float32)),
            "eta_noise": rng.standard_normal((STEPS, B, 16, 16, 4)).astype(np.float32),
            "requests": [(req[i], float(i % 4), 1.0, 3 + i) for i in range(6)]}, key


def _psd_tpu_images(inputs, key):
    """psd_tpu's sharded sample, then its decode, at each of MESHES."""
    jm = jax_tiny_dadd()
    load, _ = seeded_load_params(tiny_dadd(seed=0))
    core, vae, _ = load(jm, None, 0, 32)
    args = [jnp.asarray(inputs[k]) for k in ("tgt", "src", "feats")]
    cond = jm.prepare_inference_cond(core, *args)
    out = {}
    for name, (dp, fsdp) in MESHES.items():
        kw = {}
        if name.endswith("cfg"):
            kw = dict(cond_uncond=jm.prepare_inference_cond(core, *args, zero_aoe=True,
                                                            zero_image=True),
                      guidance_scale=GUIDANCE)
        lat = jm.sample(core, cond, key, image_size=32, sampling_steps=STEPS, steer_scale=1.0,
                        shared_noise=False, mesh=jax_create_mesh(JaxMeshConfig(dp=dp, fsdp=fsdp)),
                        **kw)
        out[name] = np.asarray(jm.decode_latents(vae, lat))
    return out


def _one_process(inputs):
    """The port in one process: eta 0.5 on the same eta_noise, and the
    server on the same requests (exact and turbo)."""
    import torch

    port = tiny_dadd(seed=0)
    t = {k: torch.from_numpy(inputs[k]) for k in ("tgt", "src", "feats", "x0", "eta_noise")}
    cond = port.prepare_inference_cond(t["tgt"], t["src"], t["feats"])
    out = {"eta": port.decode_latents(port.sample(cond, t["x0"], STEPS, 1.0, eta=0.5,
                                                  eta_noise=t["eta_noise"])).numpy()}
    for name, turbo in SERVE_TURBO.items():
        server = GenerationServer(port, image_size=32, sampling_steps=STEPS, max_batch=4,
                                  max_wait_s=0.05, **turbo)
        futures = [server.submit(*r) for r in inputs["requests"]]
        out[name] = [f.result(timeout=300) for f in futures]
        server.close()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks started first; psd_tpu's two sharded samplers and the
    port's one process run beside them."""
    inputs, key = _inputs()
    ranks = Ranks(serve_ranks, 2, tmp_path_factory.mktemp("serve_ranks"), inputs)
    jax_images = _psd_tpu_images(inputs, key)
    with few_threads():
        one = _one_process(inputs)
    return {"ranks": ranks.join(), "jax": jax_images, "one": one}


@pytest.mark.parametrize("name", list(MESHES))
def test_sample_on_ranks_matches_psd_tpu_sharded_sample(runs, name):
    """Each rank's gathered images, against psd_tpu's sharded sampler on the
    same mesh shape and its decode; both ranks hold the whole batch."""
    r0, r1 = (r[name] for r in runs["ranks"])
    assert r0.shape == (B, 32, 32, 3)
    np.testing.assert_array_equal(r1, r0)
    np.testing.assert_allclose(r0, runs["jax"][name], rtol=0, atol=1e-4)


def test_eta_noise_rows_give_the_one_process_result(runs):
    """DDIM with eta 0.5: each rank's rows of eta_noise (dim 1) give the
    images of the one process."""
    for r in runs["ranks"]:
        np.testing.assert_array_equal(r["eta"], runs["one"]["eta"])


@pytest.mark.parametrize("name", list(SERVE_TURBO))
def test_server_on_ranks_matches_one_process_server(runs, name):
    """Six requests at max_batch 4 (a full batch and a padded one) through
    the ranks' server: rank 0's images are the one-process server's."""
    got, want = runs["ranks"][0][name], runs["one"][name]
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert not np.allclose(got[0], got[4])  # two batches, two seeds


def test_submit_on_another_rank_raises(runs):
    assert "rank 0 owns the queue" in runs["ranks"][1]["submit"]


def test_batches_the_ranks_do_not_split_raise(runs):
    """A sample or decode batch of 3, and a max_batch of 3, raise ValueError
    on every rank before any collective."""
    for r in runs["ranks"]:
        for what in ("odd_sample", "odd_decode", "odd_server"):
            assert r[what] is not None and "does not split over 2" in r[what], what


def test_close_on_rank_zero_ends_every_rank(runs):
    """Rank 0's close sends the stop; rank 1's close returns with its
    worker ended, both within the ranks' timeout."""
    for r in runs["ranks"]:
        for name in SERVE_TURBO:
            assert r[f"{name}_alive"] is False
            assert r[f"{name}_close_s"] < 60


def test_failed_batch_stops_the_server_on_every_rank(runs):
    """A batch that fails on rank 0 (requests of two feature shapes) fails
    its futures, the server takes no more requests, and rank 1's loop ends
    with rank 0's stop: no batch goes on with fewer ranks."""
    r0, r1 = runs["ranks"]
    assert r0["failed"] == ["ValueError", "ValueError"]
    assert "stopped after a failed batch" in r0["after_failure"]
    assert r0["failed_alive"] is False and r1["failed_alive"] is False
