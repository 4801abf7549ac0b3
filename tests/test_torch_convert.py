"""The port's checkpoint converters (`psd_tpu_torch/convert/{sd,clip,
backbones,manifest,gate}.py`) against psd_tpu's, on the CPU.

  * Every `--kind` of the weight scripts: psd_tpu's converter and the
    port's turn the same state dict into bit-equal trees (the same keys,
    dtypes and bytes). The inputs are drawn from a seed with numpy in the
    surfaces of the diffusers-named mirrors (`tests/torch_ref`; the tiny
    UNet and VAE of `tests/test_manifest.py`), of a tiny transformers CLIP
    and of the torchvision backbones at their real shapes (built on the meta
    device). The backbones' trees fill the port's modules through
    `load_variables_`'s walk.
  * A tiny mirror's weights through the port's converter and `load_flax_`
    into the port's module, float32 on the CPU: its forward equals the
    mirror's at rtol 1e-3, atol 1e-4 (the UNet in plain mode, the VAE
    decode, CLIP's `image_embeds`); split3's `to_k_dis` / `to_v_dis` start
    as attn2's `to_k` / `to_v`.
  * SD scale with no allocation (zero-stride arrays in the manifests'
    shapes): the converters consume every key of the published manifests
    and their trees pass the meta-device gate (`convert/gate.py`); a
    dropped key or a changed shape raises. The manifests equal psd_tpu's.
  * The `.safetensors` reader against `safetensors` (F32, F16, BF16; the
    integer dtypes, BOOL and F64 beside them), its refusals, and the `.bin`
    round trip.
"""

import json
import os

import numpy as np
import pytest
import torch

from psd_tpu.convert import backbones as jbb
from psd_tpu.convert import clip as jclip
from psd_tpu.convert import manifest as jman
from psd_tpu.convert import sd as jsd
from psd_tpu_torch.convert import backbones, clip, manifest, sd
from psd_tpu_torch.convert.from_jax import (_leaves, check_flax_shapes, load_flax_,
                                            merge_variables)
from psd_tpu_torch.convert.gate import GATED_KINDS, check_converted
from tests.torch_cli_parity import few_threads
from tests.torch_ref import backbones as ref_bb
from tests.torch_ref.unet import TorchUNet2DConditionModel
from tests.torch_ref.vae import TorchAutoencoderKL

TINY_UNET = dict(block_out_channels=(32, 64), layers_per_block=1, cross_attention_dim=32)
TINY_VAE = dict(block_out_channels=(32, 64), layers_per_block=2)
TINY_CLIP = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                 intermediate_size=64, patch_size=8, image_size=32, projection_dim=16)
# transformers imports TensorFlow and flax where they are installed; these
# tests take its PyTorch CLIP only
os.environ.setdefault("USE_TF", "0")
os.environ.setdefault("USE_FLAX", "0")
RESNETS = {"resnet18": ("BasicBlock", [2, 2, 2, 2]), "resnet34": ("BasicBlock", [3, 4, 6, 3]),
           "resnet50": ("Bottleneck", [3, 4, 6, 3]), "resnet101": ("Bottleneck", [3, 4, 23, 3])}
KINDS = ["unet", "unet_split3", "vae", "clip", *RESNETS, "vgg16", "inception"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    with few_threads():
        yield


def _meta(ctor, *args, **kwargs):
    with torch.device("meta"):
        return ctor(*args, **kwargs)


def _hf_clip(cfg=TINY_CLIP):
    from transformers import CLIPVisionConfig, CLIPVisionModelWithProjection

    return CLIPVisionModelWithProjection(CLIPVisionConfig(**cfg))


def mirror(kind: str):
    """The kind's torch module in the checkpoint's key names, on the meta
    device (tiny for the SD and CLIP kinds, real for the backbones)."""
    if kind in ("unet", "unet_split3"):
        return _meta(TorchUNet2DConditionModel, heads=2, **TINY_UNET)
    if kind == "vae":
        return _meta(TorchAutoencoderKL, **TINY_VAE)
    if kind == "clip":
        return _meta(_hf_clip)
    if kind in RESNETS:
        block, layers = RESNETS[kind]
        return _meta(ref_bb.TorchResNet, getattr(ref_bb, block), layers)
    if kind == "vgg16":
        return _meta(ref_bb.TorchVGG16)
    return _meta(ref_bb.TorchInceptionV3)


def seeded_state_dict(module, seed: int):
    """{key: numpy} in `module`'s state_dict surface, drawn from `seed`
    (integer buffers such as `num_batches_tracked` zero)."""
    rng = np.random.default_rng(seed)
    return {k: (rng.random(v.shape, np.float32) - 0.5 if v.is_floating_point()
                else np.zeros(v.shape, np.int64))
            for k, v in module.state_dict().items()}


def convert(pkg_sd, pkg_clip, pkg_bb, kind, state):
    if kind in ("unet", "unet_split3"):
        return pkg_sd.convert_sd_unet(state, warm_start_kv_dis=kind == "unet_split3")
    if kind == "vae":
        return pkg_sd.convert_sd_vae(state)
    if kind == "clip":
        return pkg_clip.convert_clip_vision(state, num_layers=TINY_CLIP["num_hidden_layers"])
    if kind in RESNETS:
        return pkg_bb.convert_resnet(state, keep_fc=False)
    if kind == "vgg16":
        return pkg_bb.convert_vgg16(state)
    return pkg_bb.convert_inception_v3(state)


def port_backbone(kind: str):
    from psd_tpu_torch.models import inception, resnet, vgg

    if kind in RESNETS:
        return _meta(resnet.ResNet, resnet.ResNetConfig(variant=kind, head="features"))
    if kind == "vgg16":
        return _meta(vgg.VGG16Features)
    return _meta(inception.InceptionV3Features)


@pytest.mark.parametrize("kind", KINDS)
def test_the_port_converts_as_psd_tpu_bit_for_bit(kind):
    state = seeded_state_dict(mirror(kind), seed=KINDS.index(kind))
    want = dict(_leaves(convert(jsd, jclip, jbb, kind, state)))
    tree = convert(sd, clip, backbones, kind, state)
    got = dict(_leaves(tree))
    assert list(got) == list(want)
    for path, w in want.items():
        g = got[path]
        assert (g.dtype, g.shape) == (w.dtype, w.shape), path
        bits = f"u{w.itemsize}"  # the bytes, compared in place
        assert np.array_equal(g.view(bits), w.view(bits)), path
    if kind in ("unet", "unet_split3", "vae", "clip"):
        return
    assert set(tree) == ({"params"} if kind == "vgg16" else {"params", "batch_stats"})
    check_flax_shapes(merge_variables(tree), port_backbone(kind))


def _forward(kind, state, x):
    """The mirror's float32 forward and the port's after the port's
    converter and `load_flax_`, both on the CPU (NCHW in and out)."""
    from psd_tpu_torch.models.clip import CLIPVisionTower, tiny_clip_config
    from psd_tpu_torch.models.unet import UNet2DCondition, tiny_unet_config
    from psd_tpu_torch.models.vae import AutoencoderKL, tiny_vae_config

    tensors = {k: torch.from_numpy(v) for k, v in state.items()}
    nhwc = torch.from_numpy(x.transpose(0, 2, 3, 1))
    with torch.no_grad():
        if kind == "unet":
            ref_net = TorchUNet2DConditionModel(heads=2, **TINY_UNET)
            ref_net.load_state_dict(tensors)
            t = torch.tensor([500])
            ctx = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 8, 32), np.float32))
            ref = ref_net.eval()(torch.from_numpy(x), t, ctx)
            net = load_flax_(UNet2DCondition(tiny_unet_config(attn_mode="plain")),
                             sd.convert_sd_unet(state, warm_start_kv_dis=False))
            return ref, net.eval()(nhwc, t, ctx, 0.0).permute(0, 3, 1, 2)
        if kind == "vae":
            ref_net = TorchAutoencoderKL(**TINY_VAE)
            ref_net.load_state_dict(tensors)
            ref = ref_net.eval().decode(torch.from_numpy(x))
            net = load_flax_(AutoencoderKL(tiny_vae_config(layers_per_block=2)),
                             sd.convert_sd_vae(state))
            return ref, net.eval()(nhwc).permute(0, 3, 1, 2)
        ref_net = _hf_clip()
        ref_net.load_state_dict(tensors)
        ref = ref_net.eval()(torch.from_numpy(x)).image_embeds
        net = load_flax_(CLIPVisionTower(tiny_clip_config()),
                         clip.convert_clip_vision(state, num_layers=TINY_CLIP["num_hidden_layers"]))
        return ref, net.eval().image_embeds(nhwc)


@pytest.mark.parametrize("kind,shape", [("unet", (1, 4, 16, 16)), ("vae", (1, 4, 8, 8)),
                                        ("clip", (1, 3, 32, 32))])
def test_a_tiny_mirror_through_the_port_converter_runs_as_the_mirror(kind, shape):
    torch.manual_seed(0)
    state = {k: v.numpy() for k, v in {"unet": lambda: TorchUNet2DConditionModel(
        heads=2, **TINY_UNET), "vae": lambda: TorchAutoencoderKL(**TINY_VAE),
        "clip": _hf_clip}[kind]().state_dict().items()}
    x = np.random.default_rng(0).standard_normal(shape, np.float32)
    ref, ours = _forward(kind, state, x)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=1e-3, atol=1e-4)


def test_split3_warm_starts_the_delta_banks_from_attn2():
    state = seeded_state_dict(mirror("unet"), seed=0)
    tree = sd.convert_sd_unet(state)["params"]
    sites = [(name, block) for name, node in tree.items() if "attentions" in name
             for block_name, block in node.items() if block_name.startswith("transformer_blocks")]
    assert len(sites) == 4  # down 1, mid 1, up 2 at the tiny width
    for name, block in sites:
        a = block["attn2"]
        for kv in "kv":
            np.testing.assert_array_equal(a[f"to_{kv}_dis"]["kernel"], a[f"to_{kv}"]["kernel"])


def _zeros(m):
    """A state dict in the manifest's shapes with no memory behind it."""
    return {k: np.broadcast_to(np.float32(0), s) for k, s in m.items()}


SD_MANIFESTS = {"unet": manifest.sd_unet_manifest, "unet_split3": manifest.sd_unet_manifest,
                "vae": manifest.sd_vae_manifest, "clip": manifest.clip_vision_manifest}


def _convert_sd(kind, state):
    if kind == "clip":
        return clip.convert_clip_vision(state, num_layers=24)
    return convert(sd, clip, backbones, kind, state)


@pytest.mark.parametrize("fault", ["none", "dropped", "reshaped"])
@pytest.mark.parametrize("kind", GATED_KINDS)
def test_sd_scale_trees_consume_the_manifest_and_fit_the_port(kind, fault):
    m = SD_MANIFESTS[kind]()
    state = _zeros(m)
    victim = sorted(k for k in m if k.endswith(".weight") and len(m[k]) >= 2)[7]
    if fault == "dropped":
        del state[victim]
    elif fault == "reshaped":
        o, i, *k = m[victim]
        state[victim] = np.broadcast_to(np.float32(0), (o, i + 1, *k))
    if fault != "none":
        with pytest.raises((KeyError, ValueError)):
            check_converted(kind, _convert_sd(kind, state))
        return
    tree = _convert_sd(kind, state)
    extra = 32 if kind == "unet_split3" else 0  # to_k_dis / to_v_dis at the 16 sites
    assert sum(1 for _ in _leaves(tree)) == len(m) + extra
    check_converted(kind, tree)


@pytest.mark.parametrize("name,kwargs", [
    ("sd_unet_manifest", {}), ("sd_unet_manifest", TINY_UNET),
    ("sd_vae_manifest", {}), ("sd_vae_manifest", TINY_VAE),
    ("clip_vision_manifest", {}), ("clip_vision_manifest", dict(hidden=32, layers=2, heads=2))])
def test_the_manifests_are_psd_tpus(name, kwargs):
    got, want = getattr(manifest, name)(**kwargs), getattr(jman, name)(**kwargs)
    assert list(got.items()) == list(want.items())
    assert manifest.diff_manifest(got, want) == ([], [], [])


# ---- the readers ------------------------------------------------------------------

def _tensors(seed):
    rng = np.random.default_rng(seed)
    names = ["z.weight", "a.bias", "m.conv.weight", "b.norm.weight", "empty"]
    shapes = [(3, 5), (7,), (4, 2, 3, 3), (1,), (0, 3)]
    return {n: rng.standard_normal(s).astype(np.float32) for n, s in zip(names, shapes)}


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_the_safetensors_reader_reads_as_safetensors(tmp_path, dtype):
    from safetensors.numpy import load_file, save_file

    path = tmp_path / "w.safetensors"
    save_file({k: v.astype(dtype) for k, v in _tensors(0).items()}, str(path),
              metadata={"format": "pt"})
    got, want = sd.load_torch_state_dict(path), load_file(str(path))
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == w.shape
        np.testing.assert_array_equal(got[k], w.astype(np.float32))


def test_the_safetensors_reader_keeps_the_files_byte_order(tmp_path):
    """Tensors laid out neither by name nor by dtype come out in the order
    of their bytes, as `load_file` gives them (the npz's entry order)."""
    from safetensors.numpy import load_file

    tensors = {k: v for k, v in _tensors(3).items() if v.size}
    order = ["m.conv.weight", "z.weight", "b.norm.weight", "a.bias"]
    blobs = {k: tensors[k].astype(np.float16 if k == "z.weight" else np.float32).tobytes()
             for k in order}
    starts = np.cumsum([0] + [len(blobs[k]) for k in order])
    header = {k: {"dtype": "F16" if k == "z.weight" else "F32", "shape": list(tensors[k].shape),
                  "data_offsets": [int(starts[i]), int(starts[i + 1])]}
              for i, k in reversed(list(enumerate(order)))}  # listed against their byte order
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)
    path = tmp_path / "w.safetensors"
    path.write_bytes(len(text).to_bytes(8, "little") + text + b"".join(blobs[k] for k in order))
    got, want = sd.load_torch_state_dict(path), load_file(str(path))
    assert list(got) == list(want) == order
    for k in order:
        np.testing.assert_array_equal(got[k], want[k].astype(np.float32))


def test_the_safetensors_reader_widens_bf16_as_torch(tmp_path):
    from safetensors.torch import load_file, save_file

    path = tmp_path / "w.safetensors"
    save_file({k: torch.from_numpy(v).bfloat16() for k, v in _tensors(1).items()}, str(path))
    got, want = sd.load_torch_state_dict(path), load_file(str(path))
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], w.float().numpy())


def test_the_safetensors_reader_refuses_what_it_cannot_read(tmp_path):
    """Integer, bool and F64 entries are read as `load_file` reads them (the
    integer ones in their own dtype, F64 as float32, as a `.bin`'s floating
    tensors; psd_tpu's reader is `load_file`); a dtype numpy cannot hold and
    a header that promises more bytes than follow raise."""
    from safetensors.numpy import load_file, save_file

    path = tmp_path / "w.safetensors"
    rng = np.random.default_rng(4)
    tensors = {"vision_model.embeddings.class_embedding": rng.random(8, np.float32),
               "vision_model.embeddings.position_ids": np.arange(5, dtype=np.int64)[None],
               "w.weight": rng.random((2, 3), np.float32), "d.weight": rng.random(3),
               "mask": np.array([True, False]), "u8": np.arange(4, dtype=np.uint8),
               "i8": np.arange(-2, 2, dtype=np.int8), "i16": np.arange(3, dtype=np.int16),
               "u16": np.arange(3, dtype=np.uint16), "i32": np.arange(3, dtype=np.int32),
               "u32": np.arange(3, dtype=np.uint32), "u64": np.arange(3, dtype=np.uint64)}
    save_file(tensors, str(path))
    got, want = sd.load_torch_state_dict(path), load_file(str(path))
    assert list(got) == list(want)
    for k, w in want.items():
        expect = w.astype(np.float32) if w.dtype.kind == "f" else w
        assert got[k].dtype == expect.dtype, k
        np.testing.assert_array_equal(got[k], expect)
    assert got["vision_model.embeddings.position_ids"].dtype == np.int64

    header = json.dumps({"w.weight": {"dtype": "F8_E4M3", "shape": [2],
                                      "data_offsets": [0, 2]}}).encode()
    made_up = tmp_path / "f8.safetensors"
    made_up.write_bytes(len(header).to_bytes(8, "little") + header + bytes(2))
    with pytest.raises(ValueError, match="'w.weight' is F8_E4M3"):
        sd.load_torch_state_dict(made_up)
    save_file({"w.weight": np.zeros((2, 2), np.float32)}, str(path))
    blob = path.read_bytes()
    n = int.from_bytes(blob[:8], "little")
    cut = tmp_path / "cut.safetensors"
    cut.write_bytes(blob[:8 + n + 4])  # the header promises more bytes than follow
    with pytest.raises(ValueError, match="has bytes"):
        sd.load_torch_state_dict(cut)


def test_a_bin_round_trips(tmp_path):
    tensors = {k: torch.from_numpy(v) for k, v in _tensors(2).items()}
    tensors["h.weight"] = tensors.pop("m.conv.weight").half()
    tensors["b.weight"] = torch.randn(3, generator=torch.Generator().manual_seed(0)).bfloat16()
    tensors["bn.num_batches_tracked"] = torch.tensor(7)
    torch.save(tensors, tmp_path / "w.bin")
    got = sd.load_torch_state_dict(tmp_path / "w.bin")
    assert list(got) == list(tensors)
    for k, t in tensors.items():
        want = t.float().numpy() if t.is_floating_point() else t.numpy()
        assert got[k].dtype == want.dtype
        np.testing.assert_array_equal(got[k], want)
