"""HF CLIPVisionModelWithProjection state_dict → psd_tpu's CLIPVisionTower params.

The port's copy of `psd_tpu/convert/clip.py` (the tests hold the two
bit-equal): it turns the openai/clip-vit-large-patch14 checkpoint into the
tree that `convert/from_jax.py` bridges into `models/clip.py`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _t(w) -> np.ndarray:
    return np.asarray(w, dtype=np.float32)


def convert_clip_vision(state_dict: Dict[str, "np.ndarray"], num_layers: int):
    """Map an HF torch state_dict (tensors or arrays) to flax params."""
    sd = {k: _t(v) for k, v in state_dict.items()}
    p: Dict = {}

    emb = "vision_model.embeddings."
    p["class_embedding"] = sd[emb + "class_embedding"].reshape(-1)
    # torch conv (out,in,kh,kw) → flax (kh,kw,in,out)
    p["patch_embedding"] = {
        "kernel": sd[emb + "patch_embedding.weight"].transpose(2, 3, 1, 0)
    }
    p["position_embedding"] = sd[emb + "position_embedding.weight"]
    p["pre_layrnorm"] = {
        "scale": sd["vision_model.pre_layrnorm.weight"],
        "bias": sd["vision_model.pre_layrnorm.bias"],
    }
    for i in range(num_layers):
        src = f"vision_model.encoder.layers.{i}."
        layer: Dict = {}
        for ours, theirs in [
            ("q_proj", "self_attn.q_proj"),
            ("k_proj", "self_attn.k_proj"),
            ("v_proj", "self_attn.v_proj"),
            ("out_proj", "self_attn.out_proj"),
            ("fc1", "mlp.fc1"),
            ("fc2", "mlp.fc2"),
        ]:
            layer[ours] = {
                "kernel": sd[src + theirs + ".weight"].T,
                "bias": sd[src + theirs + ".bias"],
            }
        for ln in ["layer_norm1", "layer_norm2"]:
            layer[ln] = {
                "scale": sd[src + ln + ".weight"],
                "bias": sd[src + ln + ".bias"],
            }
        p[f"layers_{i}"] = layer
    p["post_layernorm"] = {
        "scale": sd["vision_model.post_layernorm.weight"],
        "bias": sd["vision_model.post_layernorm.bias"],
    }
    p["visual_projection"] = {"kernel": sd["visual_projection.weight"].T}
    return {"params": p}
