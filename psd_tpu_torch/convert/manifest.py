"""Official SD v1.4 / CLIP ViT-L/14 state-dict key+shape manifests.

The port's copy of `psd_tpu/convert/manifest.py` (pure data; the tests hold
the two equal). From the published model configurations alone, it
enumerates the exact state-dict surface of

  * `CompVis/stable-diffusion-v1-4` subfolder `unet`
    (diffusers `UNet2DConditionModel`: block_out_channels (320,640,1280,
    1280), layers_per_block 2, 8 heads, cross_attention_dim 768),
  * subfolder `vae` (diffusers `AutoencoderKL`: (128,256,512,512) ×2,
    mid attention), and
  * `openai/clip-vit-large-patch14` vision tower + visual projection
    (hidden 1024, 24 layers, patch 14, image 224)

in modern diffusers/transformers key naming (weights-only keys; no buffers).
`scripts/torch_port_weights.py --verify` holds a checkpoint file to them;
the tests check that the port's converters consume every key and that
their trees fit the port's modules.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

Shape = Tuple[int, ...]
Manifest = Dict[str, Shape]


def _linear(m: Manifest, base: str, out_f: int, in_f: int, bias: bool = True):
    m[f"{base}.weight"] = (out_f, in_f)
    if bias:
        m[f"{base}.bias"] = (out_f,)


def _conv(m: Manifest, base: str, out_c: int, in_c: int, k: int):
    m[f"{base}.weight"] = (out_c, in_c, k, k)
    m[f"{base}.bias"] = (out_c,)


def _norm(m: Manifest, base: str, c: int):
    m[f"{base}.weight"] = (c,)
    m[f"{base}.bias"] = (c,)


def _resnet(m: Manifest, base: str, in_c: int, out_c: int, temb: int = 0):
    _norm(m, f"{base}.norm1", in_c)
    _conv(m, f"{base}.conv1", out_c, in_c, 3)
    if temb:
        _linear(m, f"{base}.time_emb_proj", out_c, temb)
    _norm(m, f"{base}.norm2", out_c)
    _conv(m, f"{base}.conv2", out_c, out_c, 3)
    if in_c != out_c:
        _conv(m, f"{base}.conv_shortcut", out_c, in_c, 1)


def _transformer_block(m: Manifest, base: str, c: int, ctx: int):
    _norm(m, f"{base}.norm1", c)
    _linear(m, f"{base}.attn1.to_q", c, c, bias=False)
    _linear(m, f"{base}.attn1.to_k", c, c, bias=False)
    _linear(m, f"{base}.attn1.to_v", c, c, bias=False)
    _linear(m, f"{base}.attn1.to_out.0", c, c)
    _norm(m, f"{base}.norm2", c)
    _linear(m, f"{base}.attn2.to_q", c, c, bias=False)
    _linear(m, f"{base}.attn2.to_k", c, ctx, bias=False)
    _linear(m, f"{base}.attn2.to_v", c, ctx, bias=False)
    _linear(m, f"{base}.attn2.to_out.0", c, c)
    _norm(m, f"{base}.norm3", c)
    _linear(m, f"{base}.ff.net.0.proj", 8 * c, c)
    _linear(m, f"{base}.ff.net.2", c, 4 * c)


def _attention2d(m: Manifest, base: str, c: int, ctx: int, depth: int = 1):
    """diffusers Transformer2DModel (SD1.x: 1×1-conv projections)."""
    _norm(m, f"{base}.norm", c)
    _conv(m, f"{base}.proj_in", c, c, 1)
    for d in range(depth):
        _transformer_block(m, f"{base}.transformer_blocks.{d}", c, ctx)
    _conv(m, f"{base}.proj_out", c, c, 1)


def sd_unet_manifest(
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280),
    layers_per_block: int = 2,
    in_channels: int = 4,
    out_channels: int = 4,
    cross_attention_dim: int = 768,
) -> Manifest:
    """UNet2DConditionModel state-dict surface (SD v1.x config)."""
    m: Manifest = {}
    chans = block_out_channels
    n = len(chans)
    temb = chans[0] * 4

    _conv(m, "conv_in", chans[0], in_channels, 3)
    _linear(m, "time_embedding.linear_1", temb, chans[0])
    _linear(m, "time_embedding.linear_2", temb, temb)

    # ---- down path; record per-stage skip channels for the up path ----
    skips: List[int] = [chans[0]]  # conv_in output
    ch = chans[0]
    for i, out_c in enumerate(chans):
        has_attn = i < n - 1
        for j in range(layers_per_block):
            _resnet(m, f"down_blocks.{i}.resnets.{j}", ch, out_c, temb)
            if has_attn:
                _attention2d(
                    m, f"down_blocks.{i}.attentions.{j}", out_c,
                    cross_attention_dim,
                )
            ch = out_c
            skips.append(ch)
        if i < n - 1:
            _conv(m, f"down_blocks.{i}.downsamplers.0.conv", out_c, out_c, 3)
            skips.append(out_c)

    # ---- mid ----
    mid_c = chans[-1]
    _resnet(m, "mid_block.resnets.0", mid_c, mid_c, temb)
    _attention2d(m, "mid_block.attentions.0", mid_c, cross_attention_dim)
    _resnet(m, "mid_block.resnets.1", mid_c, mid_c, temb)

    # ---- up path ----
    rev = tuple(reversed(chans))
    ch = mid_c
    for i, out_c in enumerate(rev):
        has_attn = i > 0  # reversed order: first up block is attention-free
        for j in range(layers_per_block + 1):
            skip = skips.pop()
            _resnet(m, f"up_blocks.{i}.resnets.{j}", ch + skip, out_c, temb)
            if has_attn:
                _attention2d(
                    m, f"up_blocks.{i}.attentions.{j}", out_c,
                    cross_attention_dim,
                )
            ch = out_c
        if i < n - 1:
            _conv(m, f"up_blocks.{i}.upsamplers.0.conv", out_c, out_c, 3)

    _norm(m, "conv_norm_out", chans[0])
    _conv(m, "conv_out", out_channels, chans[0], 3)
    return m


def sd_vae_manifest(
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512),
    layers_per_block: int = 2,
    in_channels: int = 3,
    out_channels: int = 3,
    latent_channels: int = 4,
) -> Manifest:
    """AutoencoderKL state-dict surface (SD v1.x config), modern attention
    naming (to_q/to_k/to_v/to_out.0 linears with bias; legacy checkpoints
    ship query/key/value/proj_attn — convert_sd_vae accepts both)."""
    m: Manifest = {}
    chans = block_out_channels
    n = len(chans)

    def _mid(prefix: str, c: int):
        _resnet(m, f"{prefix}.resnets.0", c, c)
        _norm(m, f"{prefix}.attentions.0.group_norm", c)
        _linear(m, f"{prefix}.attentions.0.to_q", c, c)
        _linear(m, f"{prefix}.attentions.0.to_k", c, c)
        _linear(m, f"{prefix}.attentions.0.to_v", c, c)
        _linear(m, f"{prefix}.attentions.0.to_out.0", c, c)
        _resnet(m, f"{prefix}.resnets.1", c, c)

    # encoder
    _conv(m, "encoder.conv_in", chans[0], in_channels, 3)
    ch = chans[0]
    for i, out_c in enumerate(chans):
        for j in range(layers_per_block):
            _resnet(m, f"encoder.down_blocks.{i}.resnets.{j}", ch, out_c)
            ch = out_c
        if i < n - 1:
            _conv(m, f"encoder.down_blocks.{i}.downsamplers.0.conv",
                  out_c, out_c, 3)
    _mid("encoder.mid_block", chans[-1])
    _norm(m, "encoder.conv_norm_out", chans[-1])
    _conv(m, "encoder.conv_out", 2 * latent_channels, chans[-1], 3)

    # decoder
    rev = tuple(reversed(chans))
    _conv(m, "decoder.conv_in", rev[0], latent_channels, 3)
    _mid("decoder.mid_block", rev[0])
    ch = rev[0]
    for i, out_c in enumerate(rev):
        for j in range(layers_per_block + 1):
            _resnet(m, f"decoder.up_blocks.{i}.resnets.{j}", ch, out_c)
            ch = out_c
        if i < n - 1:
            _conv(m, f"decoder.up_blocks.{i}.upsamplers.0.conv",
                  out_c, out_c, 3)
    _norm(m, "decoder.conv_norm_out", rev[-1])
    _conv(m, "decoder.conv_out", out_channels, rev[-1], 3)

    _conv(m, "quant_conv", 2 * latent_channels, 2 * latent_channels, 1)
    _conv(m, "post_quant_conv", latent_channels, latent_channels, 1)
    return m


def clip_vision_manifest(
    hidden: int = 1024,
    layers: int = 24,
    heads: int = 16,
    mlp: int = 4096,
    patch: int = 14,
    image_size: int = 224,
    projection_dim: int = 768,
    prefix: str = "vision_model.",
) -> Manifest:
    """CLIPVisionModelWithProjection state-dict surface (ViT-L/14).

    transformers naming: vision_model.embeddings / pre_layrnorm (sic — the
    upstream typo is part of the public surface) / encoder.layers.N /
    post_layernorm, plus the top-level visual_projection."""
    m: Manifest = {}
    n_pos = (image_size // patch) ** 2 + 1
    m[f"{prefix}embeddings.class_embedding"] = (hidden,)
    m[f"{prefix}embeddings.patch_embedding.weight"] = (hidden, 3, patch, patch)
    m[f"{prefix}embeddings.position_embedding.weight"] = (n_pos, hidden)
    _norm(m, f"{prefix}pre_layrnorm", hidden)
    for i in range(layers):
        base = f"{prefix}encoder.layers.{i}"
        _norm(m, f"{base}.layer_norm1", hidden)
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(m, f"{base}.self_attn.{p}", hidden, hidden)
        _norm(m, f"{base}.layer_norm2", hidden)
        _linear(m, f"{base}.mlp.fc1", mlp, hidden)
        _linear(m, f"{base}.mlp.fc2", hidden, mlp)
    _norm(m, f"{prefix}post_layernorm", hidden)
    m["visual_projection.weight"] = (projection_dim, hidden)
    return m


def diff_manifest(actual: Dict[str, Shape], expected: Manifest):
    """Return (missing, extra, mismatched) key lists vs a manifest."""
    missing = sorted(set(expected) - set(actual))
    extra = sorted(set(actual) - set(expected))
    mismatched = sorted(
        k for k in set(actual) & set(expected)
        if tuple(actual[k]) != tuple(expected[k])
    )
    return missing, extra, mismatched


def assert_matches(actual: Dict[str, Shape], expected: Manifest, what: str):
    missing, extra, mismatched = diff_manifest(actual, expected)
    if missing or extra or mismatched:
        parts = []
        if missing:
            parts.append(f"missing ({len(missing)}): {missing[:6]}")
        if extra:
            parts.append(f"extra ({len(extra)}): {extra[:6]}")
        if mismatched:
            parts.append(f"shape mismatch ({len(mismatched)}): "
                         + str([(k, tuple(actual[k]), tuple(expected[k]))
                                for k in mismatched[:4]]))
        raise AssertionError(f"{what} does not match manifest: "
                             + "; ".join(parts))
