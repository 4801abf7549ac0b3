"""DADD model assembly: conditioning, the DDIM loop over the UNet, VAE
decode, and the training loss.

Counterpart of `psd_tpu/diffusion/dadd.py`:
  * `DADDCore` — one module over the UNet, the ordinal embedder, the image
    projection and the purifier (the JAX package's single trainable tree).
  * `DADD` — owns the core, the VAE decoder, the CLIP vision tower and the
    schedule; `encode_image_clip`, `prepare_inference_cond` and `generate`
    are the serving path, `train_loss` the training objective
    (`DADD(..., for_training=True)`).

Conditioning layouts:
  routing gates ON : [source AOE (N) | purified image (N) | delta (N)]
  routing gates OFF: [target AOE (N) | image (N)]

In PyTorch's idiom the weights live in the modules, so the methods take no
parameter trees: `DADD(...)` initialises them from a seed (flax-style) and
`load_flax(core_tree, vae_tree, clip_tree)` replaces them with bridged JAX
parameters.
For serving, the UNet's and decoder's matmul/conv weights are stored in the
compute dtype (`models.layers.store_weights_in_`); everything else stays
fp32, the CLIP tower's too (psd_tpu's frozen tree is fp32; it runs once a
request). The CLIP tower is built at its first use (`DADD.clip`), so a
model that is handed CLIP features never holds one. For training every
core parameter stays an fp32 master weight, cast to the compute dtype at
use (flax's dtype=bf16, param_dtype=fp32); the frozen VAE (encoder and
decoder, `AutoencoderKL`) and the CLIP tower are built at their first use,
so a train step handed encoded batches holds neither. `encode_latents`
turns images into the scaled latents `train_loss` takes.
`train_loss` runs in whichever kernel mode its caller is in: the train
step enters `core.mode.training_mode()`, a validation loss runs outside
it on the serving kernels, as psd_tpu's jitted val loss does.
The entry points run on the card (`device="cuda"`) unless the caller asks
for the CPU; without a card they raise. On the card `generate`, `sample`
and `decode_latents` each replay a CUDA graph captured at the first call
of its static knobs (`graphs.py`, psd_tpu's jitted programs); on the CPU,
and under `core.mode.eager()`, they run op by op. The turbo levers are here: the
DPM-Solver++(2M) sampler, encoder propagation and DeepCache through the
UNet's phases (`DADDCore.eps_encode/eps_decode/eps_deep/eps_shallow`), and
the int8 VAE decoder, whose int8 weights are computed once from the fp32
values (at init and in `load_flax`). Baseline mode is here too: the BOE, the
plain ImageProjection from CLIP's pooled embedding, split2 routing, LEACE
erasure of the projected image tokens and eta-stochastic DDIM, whose
per-step noise is drawn outside the graph like the initial latents. ToMe
waits for a later slice.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from ..conditioning import (AdditiveOrdinalEmbedder, BasicOrdinalEmbedder, FeaturePurifier,
                            ImageProjection, ImageProjectionPlus, apply_leace)
from ..convert.from_jax import load_flax_, state_dict_from_flax, vae_decode_tree
from ..core.config import Config
from ..core.mode import is_eager
from ..models.clip import CLIPVisionConfig, CLIPVisionTower, clip_vit_l14_config
from ..models.init import flax_init_
from ..models.layers import quantize_int8_weights_, store_weights_in_
from ..models.unet import UNet2DCondition, UNetConfig
from ..models.vae import AutoencoderKL, VAEConfig, VAEDecode, sample_gaussian
from .graphs import CapturedProgram, program_key
from .sampler import SamplerConfig, cfg_eps_fn, ddim_sample, dpm_sample
from .schedule import NoiseSchedule


SAMPLERS = {"ddim": ddim_sample, "dpm": dpm_sample}


@dataclass(frozen=True)
class DADDCoreConfig:
    unet: UNetConfig
    embedding_dim: int = 768
    conditioning_dim: int = 768
    num_classes: int = 4
    num_aoe_tokens: int = 16
    num_image_tokens: int = 16
    aoe_delta_scale: float = 0.05
    embedder_type: str = "aoe"  # "aoe" | "boe"
    use_image_projection_plus: bool = True
    use_feature_purifier: bool = True
    use_routing_gates: bool = True
    purifier_num_heads: int = 8
    purifier_ff_mult: int = 2
    clip_hidden_dim: int = 1024
    clip_projection_dim: int = 768
    use_image_conditioning: bool = True


class DADDCore(nn.Module):
    def __init__(self, cfg: DADDCoreConfig):
        super().__init__()
        if cfg.embedder_type not in ("aoe", "boe"):
            raise ValueError(f"embedder_type must be 'aoe' or 'boe', got {cfg.embedder_type!r}")
        self.cfg = cfg
        self.unet = UNet2DCondition(cfg.unet)
        if cfg.embedder_type == "aoe":
            self.ordinal_embedder = AdditiveOrdinalEmbedder(
                cfg.num_classes, cfg.embedding_dim, delta_scale=cfg.aoe_delta_scale,
                num_tokens=cfg.num_aoe_tokens)
        else:
            self.ordinal_embedder = BasicOrdinalEmbedder(cfg.num_classes, cfg.embedding_dim)
        if cfg.use_image_conditioning:
            if cfg.use_image_projection_plus:
                self.image_projection = ImageProjectionPlus(
                    cfg.clip_hidden_dim, cfg.conditioning_dim, cfg.num_image_tokens)
            else:
                self.image_projection = ImageProjection(
                    cfg.clip_projection_dim, cfg.conditioning_dim, cfg.num_image_tokens)
            if cfg.use_feature_purifier:
                self.feature_purifier = FeaturePurifier(
                    cfg.conditioning_dim, cfg.purifier_num_heads, cfg.purifier_ff_mult)

    def embed_ordinal(self, labels, noise=None):
        """(B,) labels → (B, T, D) tokens (the BOE's one (B, D) row as T = 1)."""
        out = self.ordinal_embedder(labels, noise)
        return out[:, None, :] if out.ndim == 2 else out

    def _aoe(self, what: str) -> AdditiveOrdinalEmbedder:
        """The AOE, for what only it has (psd_tpu's BOE lacks the method, so
        psd_tpu fails at the same call)."""
        if not isinstance(self.ordinal_embedder, AdditiveOrdinalEmbedder):
            raise ValueError(f"{what} needs the AOE: the BOE (embedder_type 'boe') has no "
                             f"negative embedding and no ordinal delta")
        return self.ordinal_embedder

    def prepare_conditioning(self, labels, clip_feats, source_labels=None,
                             zero_aoe: bool = False, image_scale: float = 1.0,
                             drop_image_mask: Optional[torch.Tensor] = None,
                             aoe_noise: Optional[torch.Tensor] = None,
                             leace: Optional[Dict[str, torch.Tensor]] = None):
        """`aoe_noise` (2, B, D) N(0, 1): training's embedder noise for the
        target and the source embedding, in the order psd_tpu draws them.
        `leace` ({"P_null", "mu"}) erases the disease directions from the
        projected image tokens, before the purifier."""
        c = self.cfg
        src = labels if source_labels is None else source_labels
        n_tgt, n_src = (None, None) if aoe_noise is None else aoe_noise
        if zero_aoe:
            target_aoe = self._aoe("zero_aoe (the CFG pass's negative embedding)").negative(
                labels, n_tgt)
        else:
            target_aoe = self.embed_ordinal(labels, n_tgt)
        if not c.use_image_conditioning or clip_feats is None:
            return target_aoe
        source_aoe = self.embed_ordinal(src, n_src)
        image_embeds = self.image_projection(clip_feats)
        if leace is not None:
            image_embeds = apply_leace(image_embeds, leace)
        if c.use_feature_purifier:
            image_embeds = self.feature_purifier(image_embeds, source_aoe)
        image_embeds = image_embeds * image_scale
        if drop_image_mask is not None:
            image_embeds = torch.where(drop_image_mask[:, None, None],
                                       torch.zeros_like(image_embeds), image_embeds)
        if c.use_routing_gates:
            delta = self._aoe("routing gates (the delta tokens)").ordinal_delta(src, labels)
            return torch.cat([source_aoe, image_embeds, delta], dim=1)
        return torch.cat([target_aoe, image_embeds], dim=1)

    def eps(self, latents, t, cond, delta_scale: float = 0.0):
        return self.unet(latents, t, cond, delta_scale)

    def eps_encode(self, latents, t, cond, delta_scale: float = 0.0):
        """UNet down + mid only → (h_mid, skips) (encoder propagation)."""
        return self.unet(latents, t, cond, delta_scale, phase="encode")

    def eps_decode(self, t, cond, cached, delta_scale: float = 0.0):
        """UNet up + out from cached encoder features, fresh t embedding."""
        return self.unet(None, t, cond, delta_scale, phase="decode", cached=cached)

    def eps_deep(self, latents, t, cond, delta_scale: float = 0.0):
        """Full forward that also returns the DeepCache branch feature →
        (eps, deep)."""
        return self.unet(latents, t, cond, delta_scale, phase="deep")

    def eps_shallow(self, latents, t, cond, cached, delta_scale: float = 0.0):
        """Shallow path (conv_in → down block 0 → last up block ← cached) → eps."""
        return self.unet(latents, t, cond, delta_scale, phase="shallow", cached=cached)


def core_config_from(cfg: Config, dtype=torch.bfloat16) -> DADDCoreConfig:
    """DADDCoreConfig from a reference-format Config (routing gates → split3,
    else split2; gradient checkpointing from
    `training.gradient_checkpointing`)."""
    m = cfg.model
    unet = UNetConfig(
        in_channels=m.latent_channels,
        out_channels=m.latent_channels,
        block_out_channels=tuple(m.block_out_channels),
        layers_per_block=2,
        num_heads=m.attention_heads,
        cross_attention_dim=m.conditioning_dim,
        attn_mode="split3" if m.use_routing_gates else "split2",
        num_aoe_tokens=m.num_aoe_tokens,
        num_image_tokens=m.num_image_tokens,
        num_delta_tokens=m.num_aoe_tokens,
        use_frequency_strategy=m.use_frequency_strategy,
        gate_init_anatomy=m.gate_init_anatomy,
        gate_init_disease=m.gate_init_disease,
        remat=cfg.training.gradient_checkpointing,
        dtype=dtype,
    )
    return DADDCoreConfig(
        unet=unet,
        embedding_dim=m.embedding_dim,
        conditioning_dim=m.conditioning_dim,
        num_classes=m.ordinal_embedder.num_classes,
        num_aoe_tokens=m.num_aoe_tokens,
        num_image_tokens=m.num_image_tokens,
        aoe_delta_scale=m.ordinal_embedder.delta_scale,
        embedder_type=m.ordinal_embedder.type,
        use_image_projection_plus=m.use_image_projection_plus,
        use_feature_purifier=m.use_feature_purifier,
        use_routing_gates=m.use_routing_gates,
        purifier_num_heads=m.purifier_num_heads,
        purifier_ff_mult=m.purifier_ff_mult,
    )


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; "cuda" without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for, but torch.cuda.is_available() is "
                           "false; pass device='cpu' to run on the CPU")
    return dev


class DADD:
    """Orchestrator: core + VAE + schedule on one device.

    `for_training=True` keeps fp32 master weights and builds the frozen VAE
    (encoder and decoder) and the CLIP tower at their first use."""

    def __init__(self, cfg: Config, core_cfg: Optional[DADDCoreConfig] = None,
                 vae_cfg: Optional[VAEConfig] = None, clip_cfg: Optional[CLIPVisionConfig] = None,
                 dtype=torch.bfloat16, device="cuda", seed: Optional[int] = 0,
                 for_training: bool = False):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.seed = seed
        self.for_training = for_training
        self.core_cfg = core_cfg or core_config_from(cfg, dtype=dtype)
        self.vae_cfg = vae_cfg or VAEConfig(dtype=dtype)
        self.clip_cfg = clip_cfg or clip_vit_l14_config(dtype=dtype)
        with self.device:
            self.core = DADDCore(self.core_cfg).train(for_training)
            self._vae = None if for_training else VAEDecode(self.vae_cfg).eval()
        self._clip: Optional[CLIPVisionTower] = None
        self._frozen_lock = threading.Lock()
        if seed is not None and self.device.type != "meta":
            gen = torch.Generator(device=self.device).manual_seed(seed)
            flax_init_(self.core, gen)
            if self._vae is not None:
                flax_init_(self._vae, gen)
        if not for_training:
            # the int8 decoder weights come from the fp32 values, before the cast
            quantize_int8_weights_(self.vae)
            store_weights_in_(self.core.unet, self.core_cfg.unet.dtype)
            store_weights_in_(self.vae.decoder, self.vae_cfg.dtype)
        self.schedule = NoiseSchedule(
            num_train_timesteps=cfg.diffusion.num_train_timesteps,
            beta_start=cfg.diffusion.beta_start,
            beta_end=cfg.diffusion.beta_end,
            kind=cfg.diffusion.noise_schedule,
        )
        self.latent_scale = cfg.diffusion.latent_scale
        self.spatial_factor = 2 ** (len(self.vae_cfg.block_out_channels) - 1)
        # captured programs by key (graphs.program_key), on the card only.
        # Unbounded: each new key (a steer or guidance value, a batch size)
        # adds a program whose graph pool holds its activations, and a first
        # call that warms up and captures; clear it to free the pools.
        self.programs: Dict[tuple, CapturedProgram] = {}
        # why each key whose capture failed did (a string, so no traceback
        # keeps the failed capture's tensors alive): a later call with that
        # key raises again and does not capture again (torch keeps a failed
        # capture's pool); clear it to let such a key capture again
        self.failed_captures: Dict[tuple, str] = {}
        self._programs_lock = threading.Lock()

    def load_flax(self, core_tree=None, vae_tree=None, clip_tree=None) -> "DADD":
        """Replace the weights with `psd_tpu` parameter trees (numpy leaves);
        a part whose tree is None keeps the weights it has. A serving model
        takes the decode half of `vae_tree`, a training model all of it."""
        if core_tree is not None:
            load_flax_(self.core, core_tree)
        if vae_tree is not None:
            if self.for_training:
                load_flax_(self._frozen_vae(init=False), vae_tree)
            else:
                sd = state_dict_from_flax(vae_decode_tree(vae_tree), self._vae)
                quantize_int8_weights_(self._vae, sd)  # from the fp32 arrays, as psd_tpu
                self._vae.load_state_dict(sd, strict=True)
        if clip_tree is not None:
            load_flax_(self._clip_tower(init=False), clip_tree)
        return self

    @property
    def vae(self) -> VAEDecode:
        """A serving model's decoder (built with the model), or a training
        model's frozen `AutoencoderKL`, built at its first use (its weights
        from a generator of its own seeded `seed + 1`, as psd_tpu's
        pipelines seed the VAE's init, or from `load_flax`). Calling it
        decodes."""
        return self._vae if self._vae is not None else self._frozen_vae(init=True)

    def _frozen_vae(self, init: bool) -> AutoencoderKL:
        with self._frozen_lock:
            if self._vae is None:
                with self.device:
                    vae = AutoencoderKL(self.vae_cfg).eval().requires_grad_(False)
                if init and self.seed is not None and self.device.type != "meta":
                    flax_init_(vae, torch.Generator(device=self.device).manual_seed(self.seed + 1))
                store_weights_in_(vae.encoder, self.vae_cfg.dtype)
                store_weights_in_(vae.decoder, self.vae_cfg.dtype)
                self._vae = vae
        return self._vae

    @property
    def clip(self) -> CLIPVisionTower:
        """The frozen CLIP vision tower, built at its first use; its weights
        come from a generator of its own, seeded `seed + 3` (psd_tpu's
        pipelines seed CLIP's init so), or from `load_flax`."""
        return self._clip_tower(init=True)

    def _clip_tower(self, init: bool) -> CLIPVisionTower:
        with self._frozen_lock:
            if self._clip is None:
                with self.device:
                    tower = CLIPVisionTower(self.clip_cfg).eval().requires_grad_(False)
                if init and self.seed is not None and self.device.type != "meta":
                    gen = torch.Generator(device=self.device).manual_seed(self.seed + 3)
                    flax_init_(tower, gen)
                self._clip = tower
        return self._clip

    def _t(self, a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype).to(self.device)

    # ---- training loss -----------------------------------------------------
    def sample_draws(self, latent_shape, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """The random draws of one `train_loss`, from `generator` (on the
        model's device): noise, t, the image-CFG drop mask, the embedder's
        (target, source) noise, and the noise-offset and input-perturbation
        draws when the config turns them on."""
        tcfg, g, dev = self.cfg.training, generator, self.device
        B = latent_shape[0]
        draws = {
            "noise": torch.randn(latent_shape, generator=g, device=dev),
            "t": torch.randint(0, self.cfg.diffusion.num_train_timesteps, (B,), generator=g,
                               device=dev),
            "drop_mask": torch.rand((B,), generator=g, device=dev) < self.cfg.model.cfg_drop_prob,
            "aoe_noise": torch.randn((2, B, self.core_cfg.embedding_dim), generator=g,
                                     device=dev),
        }
        if tcfg.noise_offset > 0:
            draws["offset_noise"] = torch.randn((B, 1, 1, latent_shape[-1]), generator=g,
                                                device=dev)
        if tcfg.input_perturbation > 0:
            draws["perturb_noise"] = torch.randn(latent_shape, generator=g, device=dev)
        return draws

    def train_loss(self, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Dict[str, torch.Tensor]] = None):
        """Min-SNR-weighted eps-MSE with per-sample image-CFG dropout
        (psd_tpu/diffusion/dadd.py:346-419) → (loss, metrics).

        `batch`: pre-encoded scaled latents (B, h, w, 4), labels (B,) and
        optionally clip_feats. The random numbers come from `draws` when
        given (tests hand it JAX's), else from `generator`. The kernels are
        those of the caller's mode: the train step enters training mode
        (core/mode.py), where every kernel it reaches has a backward; a
        validation loss under no_grad outside it takes the serving kernels,
        as psd_tpu's does. With gradients wanted outside the mode, the
        forward-only kernels raise on the card (`kernels.require_no_grad`)."""
        if not self.for_training:
            raise ValueError("train_loss needs fp32 master weights: build the model with "
                             "DADD(..., for_training=True)")
        tcfg, dcfg = self.cfg.training, self.cfg.diffusion
        latents = self._t(batch["latents"])
        labels = self._t(batch["labels"])
        clip_feats = batch.get("clip_feats")
        clip_feats = None if clip_feats is None else self._t(clip_feats)
        if draws is None:
            if generator is None:
                raise ValueError("train_loss needs draws or a torch.Generator")
            draws = self.sample_draws(tuple(latents.shape), generator)
        noise = draws["noise"]
        if tcfg.noise_offset > 0:
            noise = noise + tcfg.noise_offset * draws["offset_noise"]
        t = draws["t"]
        q_noise = noise
        if tcfg.input_perturbation > 0:
            q_noise = noise + tcfg.input_perturbation * draws["perturb_noise"]
        noisy = self.schedule.q_sample(latents, t, q_noise)
        drop_mask = None if clip_feats is None else draws["drop_mask"]

        cond = self.core.prepare_conditioning(labels, clip_feats, drop_image_mask=drop_mask,
                                              aoe_noise=draws["aoe_noise"])
        eps_pred = self.core.eps(noisy, t, cond, 0.0)
        per_sample = ((eps_pred.float() - noise) ** 2).mean(dim=(1, 2, 3))
        if tcfg.use_min_snr_weighting:
            w = self.schedule.min_snr_weight(t, dcfg.min_snr_gamma)
        else:
            w = torch.ones_like(per_sample)
        loss = (w * per_sample).mean()
        metrics = {
            "loss": loss.detach(),
            "loss_base": per_sample.detach().mean(),
            "min_snr_weight_mean": w.mean(),
        }
        if drop_mask is not None:
            metrics["cfg_drop_rate"] = drop_mask.float().mean()
        return loss, metrics

    @torch.no_grad()
    def encode_latents(self, images, generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Images (B, H, W, 3) in [−1, 1] → a draw of the VAE's posterior ×
        `latent_scale`, (B, H/8, W/8, 4) fp32 (psd_tpu/diffusion/dadd.py:
        326-334). The N(0, 1) draw is `noise` when given (tests hand it
        JAX's), else drawn from `generator`. Outside training mode, so the
        encoder's mid-block attention takes the serving kernel route."""
        if not hasattr(self.vae, "encoder"):
            raise ValueError("encode_latents needs the VAE encoder, which a serving model does "
                             "not hold: build the model with DADD(..., for_training=True)")
        mean, logvar = self.vae.encode(self._t(images))
        if noise is None:
            if generator is None:
                raise ValueError("encode_latents needs noise or a torch.Generator")
            noise = torch.randn(mean.shape, generator=generator, device=self.device)
        return sample_gaussian(mean, logvar, self._t(noise)) * self.latent_scale

    @torch.inference_mode()
    def encode_image_clip(self, clip_images) -> torch.Tensor:
        """CLIP-preprocessed (B, 224, 224, 3) pixels → the image projection's
        input, fp32: `last_hidden_state` for IP-Plus, else `image_embeds`
        (psd_tpu/diffusion/dadd.py:313-324)."""
        x = self._t(clip_images)
        if self.core_cfg.use_image_projection_plus:
            return self.clip.last_hidden_state(x).float()
        return self.clip.image_embeds(x).float()

    @torch.inference_mode()
    def prepare_inference_cond(self, target_labels, source_labels, clip_feats,
                               image_scale: float = 1.0, zero_aoe: bool = False,
                               zero_image: bool = False,
                               leace: Optional[Dict] = None) -> torch.Tensor:
        """(B,) target and source labels, CLIP features → (B, 3N, D) fp32
        ((B, 2N, D) without routing gates). `leace`, a `load_leace` dict,
        erases the disease directions after the projection and before the
        purifier (psd_tpu/diffusion/dadd.py:144-147)."""
        tgt = self._t(target_labels)
        mask = torch.ones(tgt.shape[0], dtype=torch.bool, device=self.device) if zero_image else None
        if leace is not None:
            leace = {"P_null": self._t(leace["P_null"]), "mu": self._t(leace["mu"])}
        return self.core.prepare_conditioning(
            tgt, self._t(clip_feats), self._t(source_labels), zero_aoe=zero_aoe,
            image_scale=image_scale, drop_image_mask=mask, leace=leace)

    def initial_noise(self, batch: int, image_size: int, generator: torch.Generator,
                      shared_noise: bool = True) -> torch.Tensor:
        lat = image_size // self.spatial_factor
        C = self.core_cfg.unet.in_channels
        shape = (1 if shared_noise else batch, lat, lat, C)
        x0 = torch.randn(shape, generator=generator, dtype=torch.float32,
                         device=self.device)
        return x0.expand(batch, -1, -1, -1).contiguous() if shared_noise else x0

    def _replay_or_run(self, kind: str, body, inputs, **knobs) -> torch.Tensor:
        """`body(*inputs)` op by op on the CPU and under `core.mode.eager()`;
        on the card, a replay of its captured program (`graphs.py`), captured
        at the first call of its key (`program_key(kind, inputs, **knobs)`).
        A key whose capture failed raises again, without capturing again."""
        if self.device.type != "cuda" or is_eager():
            return body(*inputs)
        key = program_key(kind, inputs, **knobs)
        with self._programs_lock:
            prog = self.programs.get(key)
            if prog is None:
                failed = self.failed_captures.get(key)
                if failed is not None:
                    raise RuntimeError(f"the {kind} program of this key failed to capture "
                                       f"before: {failed}")
                try:
                    prog = self.programs[key] = CapturedProgram(body, inputs)
                except Exception as e:
                    self.failed_captures[key] = f"{type(e).__name__}: {e}"
                    raise
        return prog(*inputs)

    def static_knobs(self, sampling_steps, steer_scale, guidance_scale, encoder_stride,
                     cache_mode, sampler, eta: float = 0.0) -> dict:
        """The sampler's static knobs, as `_sample` takes them and graph keys
        hold them. steer and guidance are among them: split3's kernel takes δ
        as a launch argument and the CFG mix a Python float. eta is DDIM's;
        DPM-Solver++ ignores it, as in psd_tpu, so it reads 0 there."""
        if sampler not in SAMPLERS:
            raise ValueError(f"sampler must be one of {tuple(SAMPLERS)}, got {sampler!r}")
        return dict(steps=int(sampling_steps or self.cfg.diffusion.sampling_steps),
                    steer=float(steer_scale), guidance=float(guidance_scale),
                    encoder_stride=int(encoder_stride), cache_mode=cache_mode,
                    sampler=sampler, eta=float(eta) if sampler == "ddim" else 0.0)

    def _sample_program(self, cond, x0, cond_uncond, eta_noise, knobs):
        """A program's inputs, (cond, x0[, cond_uncond][, eta_noise]), each
        optional one there when given (eta_noise when eta > 0), and `_sample`
        on inputs of that layout."""
        if knobs["eta"] > 0 and eta_noise is None:
            raise ValueError("eta > 0 needs eta_noise (steps, B, h, w, C)")
        named = dict(cond=cond, x0=x0.to(self.device), cond_uncond=cond_uncond,
                     eta_noise=eta_noise.to(self.device) if knobs["eta"] > 0 else None)
        names = tuple(k for k, v in named.items() if v is not None)

        def run(*inputs):
            return self._sample(**dict(zip(names, inputs)), **knobs)

        return tuple(named[k] for k in names), run

    def _sample(self, cond, x0, cond_uncond=None, eta_noise=None, *, steps, steer, guidance,
                eta, encoder_stride, cache_mode, sampler) -> torch.Tensor:
        core = self.core

        def raw_eps(x, t, i, embeds):
            return core.eps(x, t, embeds, steer)

        eps_fn = cfg_eps_fn(raw_eps, cond, cond_uncond, guidance)
        encode_fn = decode_fn = None
        if encoder_stride > 1:
            if cond_uncond is not None:
                raise ValueError("feature propagation is not supported with dual-pass CFG")
            if cache_mode == "deep":
                def encode_fn(x, t, i):
                    return core.eps_deep(x, t, cond, steer)

                def decode_fn(x, t, i, cache):
                    return core.eps_shallow(x, t, cond, cache, steer)
            else:
                def encode_fn(x, t, i):
                    return core.eps_encode(x, t, cond, steer)

                def decode_fn(t, i, cache):
                    return core.eps_decode(t, cond, cache, steer)
        scfg = SamplerConfig(sampling_steps=steps, eta=eta, encoder_stride=encoder_stride,
                             cache_mode=cache_mode)
        kw = dict(eta_noise=eta_noise) if sampler == "ddim" else {}
        return SAMPLERS[sampler](eps_fn, x0, self.schedule, scfg, encode_fn=encode_fn,
                                 decode_fn=decode_fn, **kw)

    def _decode(self, latents) -> torch.Tensor:
        imgs = self.vae(latents / self.latent_scale)
        return torch.clamp(imgs.float() / 2.0 + 0.5, 0.0, 1.0)

    @torch.inference_mode()
    def sample(self, cond, x0: torch.Tensor, sampling_steps: Optional[int] = None,
               steer_scale: float = 0.0, guidance_scale: float = 1.0,
               cond_uncond: Optional[torch.Tensor] = None, encoder_stride: int = 1,
               cache_mode: str = "encoder", sampler: str = "ddim", eta: float = 0.0,
               eta_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """DDIM or DPM-Solver++(2M) (`sampler` "ddim" | "dpm") from the
        initial latents x0 (B, h, w, 4) → scaled latents, fp32.
        `encoder_stride > 1` propagates cached UNet features across non-key
        steps (`cache_mode` "encoder" | "deep"); not with CFG. DDIM with
        `eta > 0` adds `eta_noise` (steps, B, h, w, 4) a step. On the card,
        one replay of the loop's captured program."""
        knobs = self.static_knobs(sampling_steps, steer_scale, guidance_scale,
                                  encoder_stride, cache_mode, sampler, eta)
        inputs, run = self._sample_program(cond, x0, cond_uncond, eta_noise, knobs)
        return self._replay_or_run("sample", run, inputs, **knobs)

    @torch.inference_mode()
    def decode_latents(self, latents) -> torch.Tensor:
        """Scaled latents → images in [0, 1], fp32. On the card, one replay
        of the decoder's captured program."""
        return self._replay_or_run("decode", self._decode, (latents,))

    @torch.inference_mode()
    def generate(self, cond, x0: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None, image_size: int = 256,
                 sampling_steps: Optional[int] = None, steer_scale: float = 0.0, guidance_scale: float = 1.0,
                 cond_uncond: Optional[torch.Tensor] = None,
                 shared_noise: bool = True, encoder_stride: int = 1,
                 cache_mode: str = "encoder", sampler: str = "ddim", eta: float = 0.0,
                 eta_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Sample + VAE decode → (B, H, W, 3) images in [0, 1]; on the card,
        one replay of one captured program (psd_tpu's one jitted program,
        `_get_jitted_generate`), whose key holds the batch, image size,
        steps, sampler, encoder stride, cache mode, CFG, steer, guidance,
        eta and the mode flags.

        The initial latents are `x0` when given (tests pass the noise JAX
        drew), else drawn from `generator` (one latent shared across the
        batch when `shared_noise`), outside the graph either way; so is
        DDIM's eta noise, `eta_noise` (steps, B, h, w, 4) when given, else
        drawn from `generator` after x0. `sampler`, `encoder_stride` and
        `cache_mode` as in `sample`; the turbo serving point is
        sampler="dpm", 25 steps, stride 5, "deep", with an int8 VAE
        (`VAEConfig(quant="int8")`)."""
        knobs = self.static_knobs(sampling_steps, steer_scale, guidance_scale,
                                  encoder_stride, cache_mode, sampler, eta)
        if x0 is None or (knobs["eta"] > 0 and eta_noise is None):
            if generator is None:
                raise ValueError("generate needs x0 (and eta_noise when eta > 0) or a "
                                 "torch.Generator")
            if x0 is None:
                x0 = self.initial_noise(cond.shape[0], image_size, generator, shared_noise)
            if knobs["eta"] > 0 and eta_noise is None:
                eta_noise = torch.randn((knobs["steps"],) + tuple(x0.shape), generator=generator,
                                        dtype=torch.float32, device=self.device)

        inputs, run = self._sample_program(cond, x0, cond_uncond, eta_noise, knobs)
        return self._replay_or_run("generate", lambda *a: self._decode(run(*a)), inputs, **knobs)
