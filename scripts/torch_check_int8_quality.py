"""SD-scale int8-vs-bf16 comparison without JAX, on the port.

The port's counterpart of `scripts/check_int8_quality.py`, with its flags
(plus `--device`) and its printed JSON line. Two modes:

  * sampling (the default): the same seed and conditioning through the
    SD-scale model with the UNet at quant="none" and quant="int8"
    (`UNetConfig.quant`, the W8A8 UNet), PSNR and max |diff| between the
    decoded images. The weights are psd_tpu's random-init regime:
    `psd_tpu_torch.utils.fast_init` (psd_tpu's `fast_init`, the same
    leaves for the same seed) for the core and the whole AutoencoderKL,
    the core's rounded to bf16 (psd_tpu casts its tree to bf16), so the
    int8 UNet's codes come from the values psd_tpu quantizes at apply
    time. With random weights the eps field is near zero and the numbers
    are an upper bound on quality.
  * `--vae`: the int8-vs-bf16 decode of the same latents through the W8A8
    decoder (`VAEConfig.quant`), on a flax-style initialised decoder (psd_tpu's
    `vae.init(PRNGKey(1), ...)` in distribution) rounded to bf16: a
    deterministic function of its input, so the number measures the quant
    path's error through the real channel ladder.

Draws: the initial latents from a torch.Generator seeded 7 (one latent an
image), the conditioning 0, `--vae`'s latents 3, the decoder's weights 1,
as psd_tpu seeds its keys (the numbers differ: torch.Generator is not
jax.random). On the card generate replays its captured program.

    python scripts/torch_check_int8_quality.py [--steps 10] [--size 256] \\
        [--batch 4] [--vae] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_check_stride_quality import (  # noqa: E402
    Config, VAEConfig, as_numpy, bf16_state, bf16_tree, core_config_from, fast_init_core,
    fast_init_vae, initial_noise, load_weights, normal, real_init_vae, serving_model)

from psd_tpu_torch.convert.from_jax import state_dict_from_flax, vae_decode_tree  # noqa: E402
from psd_tpu_torch.models.layers import quantize_int8_weights_, store_weights_in_  # noqa: E402
from psd_tpu_torch.models.vae import VAEDecode  # noqa: E402
from psd_tpu_torch.pipelines.common import add_device_arg, cli_device  # noqa: E402


def psnr_row(a: np.ndarray, b: np.ndarray) -> dict:
    """PSNR (images in [0, 1]) and max |a − b|, rounded as psd_tpu prints them."""
    mse = float(np.mean((a - b) ** 2))
    return {"value": round(10.0 * np.log10(1.0 / max(mse, 1e-12)), 2),
            "max_abs_diff": round(float(np.max(np.abs(a - b))), 4)}


def decoder(vae_cfg, vae_tree: dict, device) -> VAEDecode:
    """A serving decoder (`VAEDecode`) with the decode half of `vae_tree`
    (a whole AutoencoderKL tree of fp32 leaves); an int8 decoder's codes
    come from those values, as `DADD.load_flax` sets them."""
    with torch.device(device):
        vae = VAEDecode(vae_cfg).eval().requires_grad_(False)
    sd = state_dict_from_flax(vae_decode_tree(vae_tree), vae)
    quantize_int8_weights_(vae, sd)
    vae.load_state_dict(sd, strict=True)
    store_weights_in_(vae.decoder, vae_cfg.dtype)
    return vae


def main_vae(args, device, models=None) -> dict:
    """int8-vs-bf16 decode of the same latents (module docstring)."""
    lat = args.size // 8
    z = normal(3, (args.batch, lat, lat, 4), device)
    vae_tree = bf16_tree(real_init_vae(VAEConfig(dtype=torch.bfloat16), device))
    imgs = {}
    for quant in ("none", "int8"):
        vae = decoder(VAEConfig(dtype=torch.bfloat16, quant=quant), vae_tree, device)
        if models is not None:
            models.append(vae)
        with torch.inference_mode():
            out = torch.clamp(vae(z).float() / 2.0 + 0.5, 0.0, 1.0)
        imgs[quant] = as_numpy(out)
        assert np.isfinite(imgs[quant]).all()
        del vae
    row = {"metric": "int8_vs_bf16_vae_decode_psnr_db",
           **psnr_row(imgs["none"], imgs["int8"]),
           "size": args.size, "batch": args.batch,
           "weights": "real flax init (bf16 cast)"}
    print(json.dumps(row), flush=True)
    return row


def main(argv=None, models=None) -> dict:
    """Run the gate; → its JSON row. `models`, a list, receives each model
    (or `--vae`'s decoder) the run built."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--vae", action="store_true",
                    help="compare int8-vs-bf16 VAE DECODE of the same "
                         "latents instead of full sampling")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = cli_device(args.device)
    if args.vae:
        return main_vae(args, device, models)

    cfg = Config()
    core_sd = bf16_state(fast_init_core(core_config_from(cfg, remat=False)))
    # psd_tpu hands its decoder the fp32 fill (no bf16 cast in this mode)
    vae_tree = fast_init_vae(VAEConfig(dtype=torch.bfloat16))
    imgs = {}
    cond = None
    for quant in ("none", "int8"):
        model = load_weights(serving_model(cfg, device, quant=quant), core_sd, vae_tree)
        if models is not None:
            models.append(model)
        if cond is None:
            n_tok = 3 * model.core_cfg.num_aoe_tokens
            cond = normal(0, (args.batch, n_tok, 768), device)
        out = model.generate(cond, initial_noise(model, args.batch, args.size, 7),
                             sampling_steps=args.steps, steer_scale=1.0)
        imgs[quant] = as_numpy(out)
        assert np.isfinite(imgs[quant]).all()
        model.drop_programs()
        del model
    row = {"metric": "int8_vs_bf16_sampling_psnr_db",
           **psnr_row(imgs["none"], imgs["int8"]),
           "steps": args.steps, "size": args.size}
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
