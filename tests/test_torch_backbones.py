"""The port's metric backbones and classifier (`models/{inception,vgg,resnet}
.py`) against psd_tpu's, on the CPU, with psd_tpu's variables (params and
batch_stats, drawn from a seed with numpy into `jax.eval_shape` of its
init) bridged in.

  * InceptionV3 pool3 (batch 2 at 299²) and VGG16 fc7 (batch 2 at 224²) in
    float32: relative L2 ≤ 1e-5 over the features (48 and 15 float32
    layers, sums in another order; the same preprocessing). In bf16, as the
    evaluation sweep runs them: port and psd_tpu each within relative L2
    3e-2 of the float32 features, and of each other (bf16 operands through
    every layer, rounded at other points).
  * ResNet-18 float32 logits in eval mode within relative L2 1e-5, and one
    training-mode forward: logits within 1e-4 (batch statistics of 4
    samples, layer4's over 1×1 maps, E[x²] − E[x]² cancelling in float32)
    and the updated BatchNorm `batch_stats` (flax's momentum 0.9 and biased
    batch variance) within 1e-5 relative (float32 means over the batch in
    another order).
  * The resize (`jax.image.resize(..., "bilinear")`, antialiased when it
    shrinks) in both directions and at odd sizes, float32, max abs 1e-5.
  * Inception's branch pools do not count the padding; its BatchNorms use
    eps 1e-3.
  * Full-size trees without allocation: every variant's `jax.eval_shape`
    tree against a meta-device port module through the bridge's key map,
    strict both ways; and the bridge's round trip (`load_variables_`, then
    `to_flax_variables`) gives the tree back.
"""

import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psd_tpu.models import inception as jinc
from psd_tpu.models import resnet as jres
from psd_tpu.models import vgg as jvgg
from psd_tpu_torch.convert.from_jax import (_leaves, load_variables_, merge_variables,
                                            to_flax_variables, torch_key)
from psd_tpu_torch.models import inception, resnet, vgg
from psd_tpu_torch.models.resize import resize_bilinear
from tests.torch_cli_parity import few_threads


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    with few_threads():
        yield


def random_variables(module, x, seed, **kw):
    """psd_tpu's init tree (shapes only) filled from a numpy seed: He-scaled
    kernels, small biases, BatchNorm scales and variances near 1."""
    tree = jax.eval_shape(lambda k: module.init(k, jnp.zeros(x), **kw), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            a = rng.standard_normal(shape) * math.sqrt(2.0 / np.prod(shape[:-1]))
        elif name in ("bias", "mean"):
            a = rng.standard_normal(shape) * 0.1
        else:  # scale, var
            a = rng.uniform(0.5, 1.5, shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def inception_vars():
    return random_variables(jinc.InceptionV3Features(), (1, 299, 299, 3), 1)


@pytest.fixture(scope="module")
def vgg_vars():
    return random_variables(jvgg.VGG16Features(), (1, 224, 224, 3), 2)


def _images(n, h, w, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n, h, w, 3)).astype(np.float32)


def test_inception_matches_psd_tpu(inception_vars):
    x = _images(2, 40, 52)
    port = load_variables_(inception.InceptionV3Features().eval(), inception_vars)
    with torch.inference_mode():
        got = port(inception.inception_preprocess(torch.from_numpy(x))).numpy()
        got16 = inception.InceptionV3Features(torch.bfloat16).eval()
        load_variables_(got16, inception_vars)
        got16 = got16(inception.inception_preprocess(
            torch.from_numpy(x).to(torch.bfloat16))).float().numpy()

    def features(dtype):
        jm = jinc.InceptionV3Features(dtype=dtype)
        return jax.jit(lambda v, x: jm.apply(v, jinc.inception_preprocess(x.astype(dtype))))

    want = np.asarray(features(jnp.float32)(inception_vars, jnp.asarray(x)))
    want16 = np.asarray(features(jnp.bfloat16)(inception_vars, jnp.asarray(x)), np.float32)
    assert got.shape == (2, 2048)
    assert rel_l2(got, want) <= 1e-5
    assert rel_l2(got16, want) <= 3e-2 and rel_l2(want16, want) <= 3e-2
    assert rel_l2(got16, want16) <= 3e-2


def test_vgg_matches_psd_tpu(vgg_vars):
    x = _images(2, 256, 256, 1)
    port = load_variables_(vgg.VGG16Features().eval(), vgg_vars)
    port16 = load_variables_(vgg.VGG16Features(torch.bfloat16).eval(), vgg_vars)
    with torch.inference_mode():
        small = resize_bilinear(torch.from_numpy(x), 224, 224)
        got = port(vgg.imagenet_normalize(small)).numpy()
        got16 = port16(vgg.imagenet_normalize(small.to(torch.bfloat16))).float().numpy()
    jsmall = jax.image.resize(jnp.asarray(x), (2, 224, 224, 3), method="bilinear")

    def features(dtype):
        jm = jvgg.VGG16Features(dtype=dtype)
        return jax.jit(lambda v, x: jm.apply(v, jvgg.imagenet_normalize(x.astype(dtype))))

    want = np.asarray(features(jnp.float32)(vgg_vars, jsmall))
    want16 = np.asarray(features(jnp.bfloat16)(vgg_vars, jsmall), np.float32)
    assert got.shape == (2, 4096)
    assert rel_l2(got, want) <= 1e-5
    assert rel_l2(got16, want) <= 3e-2 and rel_l2(want16, want) <= 3e-2
    assert rel_l2(got16, want16) <= 3e-2


def test_resnet18_eval_and_train_step_statistics_match_psd_tpu():
    cfg = jres.ResNetConfig(variant="resnet18", num_classes=4, dropout=0.0)
    jm = jres.ResNet(cfg)
    variables = random_variables(jm, (1, 32, 32, 3), 3)
    x = np.random.default_rng(4).standard_normal((4, 32, 32, 3)).astype(np.float32)
    port = load_variables_(resnet.ResNet(resnet.ResNetConfig(dropout=0.0)), variables)
    with torch.no_grad():
        logits_eval = port.eval()(torch.from_numpy(x)).numpy()
        logits_train = port.train()(torch.from_numpy(x)).numpy()
    want_eval = np.asarray(jm.apply(variables, jnp.asarray(x), False))
    want_train, mutated = jm.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"],
                                   rngs={"dropout": jax.random.PRNGKey(0)})
    assert rel_l2(logits_eval, want_eval) <= 1e-5
    assert rel_l2(logits_train, np.asarray(want_train)) <= 1e-4
    stats = to_flax_variables(port)["batch_stats"]
    for path, leaf in _leaves(jax.device_get(mutated["batch_stats"])):
        node = stats
        for p in path:
            node = node[p]
        np.testing.assert_allclose(node, leaf, rtol=1e-5, atol=1e-6, err_msg="/".join(path))
    # the running statistics moved: 0.9 old + 0.1 batch
    assert not np.allclose(stats["bn1"]["var"], variables["batch_stats"]["bn1"]["var"])


@pytest.mark.parametrize("src,dst", [((256, 256), (224, 224)), ((256, 256), (299, 299)),
                                     ((512, 512), (299, 299)), ((37, 53), (299, 17)),
                                     ((64, 48), (64, 31)), ((33, 33), (33, 33))])
def test_resize_matches_jax_image_resize(src, dst):
    x = _images(2, *src, seed=src[0])
    got = resize_bilinear(torch.from_numpy(x), *dst).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 3), method="bilinear"))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_inception_pools_exclude_padding_and_bn_eps():
    x = np.random.default_rng(5).standard_normal((1, 6, 7, 3)).astype(np.float32)
    got = inception._avg_pool_3x3_same(torch.from_numpy(x).permute(0, 3, 1, 2))
    want = np.asarray(jinc._avg_pool_3x3_same(jnp.asarray(x)))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-6)
    padded = fnn.avg_pool(jnp.asarray(x), (3, 3), (1, 1), ((1, 1), (1, 1)),
                          count_include_pad=True)
    assert not np.allclose(np.asarray(padded), want)  # the corners differ
    assert inception.BasicConv2d(3, 8).bn.eps == 1e-3


def _tree_shapes(tree):
    return {torch_key(path, len(leaf.shape))[0]:
            tuple(leaf.shape) if torch_key(path, len(leaf.shape))[1] is None else
            tuple(leaf.shape[p] for p in torch_key(path, len(leaf.shape))[1])
            for path, leaf in _leaves(merge_variables(tree))}


@pytest.mark.parametrize("name", ["inception", "vgg", "resnet18", "resnet34", "resnet50",
                                  "resnet101"])
def test_full_size_trees_through_the_bridge_without_allocation(name):
    if name == "inception":
        jm, x, make = jinc.InceptionV3Features(), (1, 299, 299, 3), inception.InceptionV3Features
    elif name == "vgg":
        jm, x, make = jvgg.VGG16Features(), (1, 224, 224, 3), vgg.VGG16Features
    else:
        jm, x = jres.ResNet(jres.ResNetConfig(variant=name)), (1, 224, 224, 3)

        def make():
            return resnet.ResNet(resnet.ResNetConfig(variant=name))
    tree = jax.eval_shape(lambda k: jm.init(k, jnp.zeros(x)), jax.random.PRNGKey(0))
    with torch.device("meta"):
        port = {k: tuple(v.shape) for k, v in make().state_dict().items()}
    assert _tree_shapes(tree) == port
    n_params = sum(int(np.prod(l.shape)) for _, l in _leaves(tree["params"]))
    assert n_params == {"inception": 21_785_568, "vgg": 134_260_544, "resnet18": 11_178_564,
                        "resnet34": 21_286_724, "resnet50": 23_516_228,
                        "resnet101": 42_508_356}[name]
    if name.startswith("resnet"):
        assert resnet.resnet_feature_dim(name) == jres.resnet_feature_dim(name)


def test_bridge_round_trip_and_strictness(vgg_vars):
    cfg = jres.ResNetConfig(variant="resnet18", num_classes=4)
    variables = random_variables(jres.ResNet(cfg), (1, 32, 32, 3), 6)
    port = load_variables_(resnet.ResNet(), variables)
    back = to_flax_variables(port)
    assert {p for p, _ in _leaves(back)} == {p for p, _ in _leaves(variables)}
    for path, leaf in _leaves(variables):
        node = back
        for p in path:
            node = node[p]
        np.testing.assert_array_equal(node, leaf)
    missing = {"params": dict(variables["params"]), "batch_stats": variables["batch_stats"]}
    del missing["params"]["fc"]
    with pytest.raises(KeyError, match="not filled"):
        load_variables_(resnet.ResNet(), missing)
    extra = {"params": {**variables["params"], "fc2": {"bias": np.zeros(4, np.float32)}},
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError, match="no such port parameter"):
        load_variables_(resnet.ResNet(), extra)
    port_vgg = load_variables_(vgg.VGG16Features(), vgg_vars)
    np.testing.assert_array_equal(to_flax_variables(port_vgg)["params"]["fc6"]["kernel"],
                                  vgg_vars["params"]["fc6"]["kernel"])
