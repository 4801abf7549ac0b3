"""Published checkpoints → psd_tpu's npz parameter files, without JAX.

The port's counterpart of `scripts/port_weights.py`, with its kinds, flags
and output: it reads a diffusers / transformers / torchvision checkpoint
(.safetensors or torch .bin) from a local path, converts it with the port's
copy of psd_tpu's name map (`psd_tpu_torch/convert/`), checks the tree
against the port's module of the published configuration built on the meta
device (unet, unet_split3, vae, clip; `convert/gate.py`), and writes the npz
that psd_tpu's script writes, byte for byte. The port's weight flags read
it: `train --vae-params/--clip-params`, `infer --checkpoint DIR`
(`DIR/frozen/{vae,clip}.npz`), `evaluate --inception-params/--vgg-params`,
`classify --backbone-params`.

  python scripts/torch_port_weights.py --kind unet --src .../unet/diffusion_pytorch_model.safetensors --out weights/unet.npz
  python scripts/torch_port_weights.py --kind vae  --src .../vae/diffusion_pytorch_model.safetensors --out weights/vae.npz
  python scripts/torch_port_weights.py --kind clip --src .../pytorch_model.bin --out weights/clip.npz
  python scripts/torch_port_weights.py --kind resnet18|vgg16|inception --src ... --out ...

`--verify` is psd_tpu's deep gate: the checkpoint's key and shape surface
against the published manifest (`convert/manifest.py`), then an fp32
forward of the converted weights in the port's module against the
diffusers-named torch mirror (`tests/torch_ref`, unet and vae) or
transformers' CLIPVisionModelWithProjection (clip; it needs `transformers`)
at rtol 1e-3, atol 1e-4. The port's kernels take bf16 only
(`ops/kernels.py::require_cuda_bf16`), so that fp32 parity runs the plain
versions on the CPU, by request (`VERIFY_DEVICE`), as psd_tpu runs its
gate on the CPU; it is no fallback. The mirrors are imported only here.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from psd_tpu_torch.convert.backbones import (  # noqa: E402
    convert_inception_v3, convert_resnet, convert_vgg16)
from psd_tpu_torch.convert.clip import convert_clip_vision  # noqa: E402
from psd_tpu_torch.convert.gate import GATED_KINDS, check_converted  # noqa: E402
from psd_tpu_torch.convert.npz import save_params_npz  # noqa: E402
from psd_tpu_torch.convert.sd import (  # noqa: E402
    convert_sd_unet, convert_sd_vae, load_torch_state_dict)

KINDS = ["unet", "unet_split3", "vae", "clip", "resnet18", "resnet34", "resnet50",
         "resnet101", "vgg16", "inception"]

VERIFY_DEVICE = torch.device("cpu")
# the published configurations --verify holds a checkpoint to: the
# manifests', the mirrors' and transformers' names for them
SD_UNET = dict(block_out_channels=(320, 640, 1280, 1280), layers_per_block=2, heads=8,
               cross_attention_dim=768)
SD_VAE = dict(block_out_channels=(128, 256, 512, 512), layers_per_block=2)
CLIP_L14 = dict(hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
                intermediate_size=4096, patch_size=14, image_size=224, projection_dim=768)


def convert(kind: str, sd) -> dict:
    """The state dict → psd_tpu's tree for `kind`."""
    if kind in ("unet", "unet_split3"):
        return convert_sd_unet(sd, warm_start_kv_dis=kind == "unet_split3")
    if kind == "vae":
        return convert_sd_vae(sd)
    if kind == "clip":
        n_layers = 1 + max(int(k.split(".")[3]) for k in sd
                           if k.startswith("vision_model.encoder.layers."))
        return convert_clip_vision(sd, num_layers=n_layers)
    if kind.startswith("resnet"):
        return convert_resnet(sd, keep_fc=False)
    if kind == "vgg16":
        return convert_vgg16(sd)
    return convert_inception_v3(sd)


def _on_meta(ctor, *args, **kwargs):
    with torch.device("meta"):
        return ctor(*args, **kwargs)


def _tensors(sd) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def _deep_verify(kind: str, sd, converted) -> None:
    """--verify: the one-command parity gate for real checkpoints.

    1. The checkpoint's key+shape surface must match the published manifest
       (psd_tpu_torch/convert/manifest.py) exactly.
    2. The converted params must run numerically: the port's module with
       them against the torch mirror (tests/torch_ref), or installed
       transformers for CLIP, with the same weights, fp32 forward outputs on
       a fixed input, on VERIFY_DEVICE.
    """
    from psd_tpu_torch.convert import manifest as M
    from psd_tpu_torch.convert.from_jax import load_flax_

    surface = {k: tuple(np.shape(v)) for k, v in sd.items()
               if k.endswith((".weight", ".bias")) or k.endswith("class_embedding")}
    rng = np.random.default_rng(0)
    dev = VERIFY_DEVICE

    def port(module, tree):
        return load_flax_(module, tree, assign=True).to(dev).eval()

    if kind in ("unet", "unet_split3"):
        c = SD_UNET
        M.assert_matches(surface, M.sd_unet_manifest(
            c["block_out_channels"], c["layers_per_block"],
            cross_attention_dim=c["cross_attention_dim"]), "checkpoint (unet)")
        from psd_tpu_torch.models.unet import UNet2DCondition, sd14_unet_config
        from tests.torch_ref.unet import TorchUNet2DConditionModel

        mirror = _on_meta(TorchUNet2DConditionModel, **c)
        mirror.load_state_dict(_tensors(sd), assign=True)
        x = rng.standard_normal((1, 4, 32, 32), np.float32)
        ctx = rng.standard_normal((1, 48, c["cross_attention_dim"]), np.float32)
        t = np.array([500], np.int64)
        with torch.no_grad():
            ref = mirror.to(dev).eval()(*(torch.tensor(a, device=dev) for a in (x, t, ctx)))
        model = port(_on_meta(UNet2DCondition, sd14_unet_config(
            block_out_channels=c["block_out_channels"], layers_per_block=c["layers_per_block"],
            num_heads=c["heads"], cross_attention_dim=c["cross_attention_dim"],
            attn_mode="plain", dtype=torch.float32)), convert_sd_unet(sd, warm_start_kv_dis=False))
        with torch.no_grad():
            ours = model(torch.tensor(x.transpose(0, 2, 3, 1), device=dev),
                         torch.tensor(t, device=dev), torch.tensor(ctx, device=dev), 0.0)
        np.testing.assert_allclose(ours.permute(0, 3, 1, 2).cpu().numpy(), ref.cpu().numpy(),
                                   rtol=1e-3, atol=1e-4)
        print("verify: unet fp32 forward parity OK (rtol 1e-3)")
    elif kind == "vae":
        c = SD_VAE
        M.assert_matches(surface, M.sd_vae_manifest(**c), "checkpoint (vae)")
        from psd_tpu_torch.models.vae import AutoencoderKL, sd_vae_config
        from tests.torch_ref.vae import TorchAutoencoderKL

        mirror = _on_meta(TorchAutoencoderKL, **c)
        mirror.load_state_dict(_tensors(sd), assign=True)
        z = rng.standard_normal((1, 4, 32, 32), np.float32)
        with torch.no_grad():
            ref = mirror.to(dev).eval().decode(torch.tensor(z, device=dev))
        vae = port(_on_meta(AutoencoderKL, sd_vae_config(dtype=torch.float32, **c)),
                   convert_sd_vae(sd))
        with torch.no_grad():
            ours = vae(torch.tensor(z.transpose(0, 2, 3, 1), device=dev))
        np.testing.assert_allclose(ours.permute(0, 3, 1, 2).cpu().numpy(), ref.cpu().numpy(),
                                   rtol=1e-3, atol=1e-4)
        print("verify: vae fp32 decode parity OK (rtol 1e-3)")
    elif kind == "clip":
        c = CLIP_L14
        M.assert_matches(surface, M.clip_vision_manifest(
            hidden=c["hidden_size"], layers=c["num_hidden_layers"],
            heads=c["num_attention_heads"], mlp=c["intermediate_size"], patch=c["patch_size"],
            image_size=c["image_size"], projection_dim=c["projection_dim"]), "checkpoint (clip)")
        try:
            from transformers import CLIPVisionConfig, CLIPVisionModelWithProjection
        except ImportError as e:
            raise ImportError("--verify --kind clip compares against transformers' "
                              "CLIPVisionModelWithProjection: it needs the transformers "
                              "package, which this Python does not have") from e
        from psd_tpu_torch.models.clip import CLIPVisionTower, clip_vit_l14_config

        hf = CLIPVisionModelWithProjection(CLIPVisionConfig(**c))
        hf.load_state_dict(_tensors(sd))
        x = rng.standard_normal((1, 3, c["image_size"], c["image_size"]), np.float32)
        with torch.no_grad():
            ref = hf.to(dev).eval()(torch.tensor(x, device=dev)).image_embeds
        tower = port(_on_meta(CLIPVisionTower, clip_vit_l14_config(
            image_size=c["image_size"], patch_size=c["patch_size"], hidden_size=c["hidden_size"],
            num_layers=c["num_hidden_layers"], num_heads=c["num_attention_heads"],
            mlp_dim=c["intermediate_size"], projection_dim=c["projection_dim"],
            dtype=torch.float32)), converted)
        with torch.no_grad():
            ours = tower.image_embeds(torch.tensor(x.transpose(0, 2, 3, 1), device=dev))
        np.testing.assert_allclose(ours.cpu().numpy(), ref.cpu().numpy(), rtol=1e-3, atol=1e-4)
        print("verify: clip fp32 image_embeds parity OK (rtol 1e-3)")
    else:
        print(f"--verify: no manifest/parity gate for kind={kind} "
              "(shape verification only)")


def main(argv=None) -> dict:
    """Run the CLI; → the converted tree."""
    p = argparse.ArgumentParser()
    p.add_argument("--kind", required=True, choices=KINDS)
    p.add_argument("--src", required=True, help="torch checkpoint file")
    p.add_argument("--out", default=None, help="output .npz")
    p.add_argument("--no-verify", action="store_true")
    p.add_argument("--verify", action="store_true",
                   help="deep gate: official key+shape manifest check plus "
                        "fp32 forward parity against the torch mirror "
                        "(tests/torch_ref) / installed transformers, on the CPU; "
                        "run this the day real checkpoints are available")
    args = p.parse_args(argv)
    if not args.out and not args.verify:
        p.error("--out is required unless --verify")

    sd = load_torch_state_dict(args.src)
    print(f"loaded {len(sd)} tensors from {args.src}")
    converted = convert(args.kind, sd)
    if not args.no_verify and args.kind in GATED_KINDS:
        check_converted(args.kind, converted)
    if args.verify:
        _deep_verify(args.kind, sd, converted)
    if args.out:
        save_params_npz(converted, args.out)
        print(f"saved → {args.out}")
    return converted


if __name__ == "__main__":
    main()
