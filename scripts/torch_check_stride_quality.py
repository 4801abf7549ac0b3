"""Turbo-path quality gate without JAX: feature propagation × ToMe × DPM vs
the exact path, on the port.

The port's counterpart of `scripts/check_stride_quality.py`, with its flags
(plus `--device`) and its JSON, key for key, so
`scripts/check_gate_stability.py` reads either script's tables. It samples
one seed and conditioning through every requested turbo variant and reports,
per variant, the final latents' relative error and the decoded images' PSNR
against the exact trajectory, and the best of 3 timed runs (each ending in a
synchronize on the card; a variant's first call, which warms up and captures
its program, is not among them).

Variants (comma list, --variants):
  encN        encoder propagation stride N (Faster Diffusion, 2312.09608)
  deepN       DeepCache branch caching interval N (2310.01407)
  tomeR       ToMe token merging ratio R at the 64² sites (2303.17098); at
              256² no site is 64² and a tome variant is the exact path
  tomebR      block-resident ToMe (one merge per transformer block)
  dpmN        DPM-Solver++(2M) at N steps (2211.01095), against the same
              exact baseline (--steps DDIM) and against DPM at --steps
  int8        the W8A8 VAE decoder (the distribution gate decodes with it)
  tomeR+deepN / tomeR+encN / tomebR+deepN / dpmN+tomebR+deepK  compositions

Weights. `--train-steps 0` (the default) gates psd_tpu's random-init
regime: the core and the whole AutoencoderKL filled by
`psd_tpu_torch.utils.fast_init` (psd_tpu's `fast_init`, the same leaves for
the same seed) and random conditioning. `--train-steps N` first trains the
SD-scale model N steps on a class-structured synthetic task (`synth_train`:
low-frequency latents whose contrast and bias follow the MES class,
per-class CLIP-feature anchors; one replay of `compile_train_step`'s
program a step on the card), then gates those weights with in-distribution
conditioning and a flax-style initialised decoder. Every model gets the
weights rounded to bf16 and held in fp32 (psd_tpu casts its trees to bf16
before any model sees them): the int8 UNet and decoder compute their codes
from those values, as psd_tpu's quantize the bf16 trees at apply time.

Each (tome ratio, tome mode) has its own serving model at the configured
width; each variant's captured programs are freed once its rows are done
(`DADD.drop_programs`). Draws: the initial latents from a torch.Generator
seeded 7 (`DADD.initial_noise`, one latent an image), the random
conditioning 0, the anchors 11, synth-train's batches 5, its init 0, as
psd_tpu seeds its keys, and synth-train's step draws from
`training.seed` (the numbers differ: torch.Generator is not jax.random).

    python scripts/torch_check_stride_quality.py [--steps 50] [--size 512] \\
        [--batch 8] [--variants enc2,deep5,tome0.5+deep5,dpm25] \\
        [--train-steps 500] [--out table.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from psd_tpu_torch.convert.from_jax import state_dict_from_flax, to_flax_tree  # noqa: E402
from psd_tpu_torch.core.config import Config  # noqa: E402
from psd_tpu_torch.diffusion.dadd import DADD, DADDCore, core_config_from  # noqa: E402
from psd_tpu_torch.models.init import flax_init_  # noqa: E402
from psd_tpu_torch.models.vae import AutoencoderKL, VAEConfig  # noqa: E402
from psd_tpu_torch.ops import kernels  # noqa: E402
from psd_tpu_torch.pipelines.common import add_device_arg, cli_device  # noqa: E402
from psd_tpu_torch.train import build_optimizer, compile_train_step, create_train_state  # noqa: E402
from psd_tpu_torch.utils.fast_init import fast_init, flax_shapes  # noqa: E402

DEFAULT_VARIANTS = ("enc2,enc3,deep3,deep5,tome0.5,tomeb0.5,tome0.5+deep5,tomeb0.5+deep5,"
                    "tomeb0.5+deep6,dpm25,dpm20,dpm25+tomeb0.5+deep5")
EXACT = {"name": "exact", "tome": 0.0, "tome_mode": "branch", "stride": 1,
         "cache_mode": "encoder", "sampler": "ddim", "steps": None, "vae_quant": "none"}


def parse_variant(tok: str) -> dict:
    v = {"tome": 0.0, "tome_mode": "branch", "stride": 1,
         "cache_mode": "encoder", "sampler": "ddim", "steps": None,
         "vae_quant": "none", "name": tok}
    for part in tok.split("+"):
        if part == "int8":
            v["vae_quant"] = "int8"
        elif part.startswith("dpm"):
            v["sampler"] = "dpm"
            v["steps"] = int(part[3:])
        elif part.startswith("tomeb"):
            v["tome"] = float(part[5:])
            v["tome_mode"] = "block"
        elif part.startswith("tome"):
            v["tome"] = float(part[4:])
        elif part.startswith("enc"):
            v["stride"] = int(part[3:])
            v["cache_mode"] = "encoder"
        elif part.startswith("deep"):
            v["stride"] = int(part[4:])
            v["cache_mode"] = "deep"
        else:
            raise SystemExit(f"unknown variant token: {part!r}")
    return v


# ---- draws and weights -------------------------------------------------------------
def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def normal(seed: int, shape, device) -> torch.Tensor:
    """N(0, 1) fp32 of `shape` from a generator seeded `seed` on `device`."""
    return torch.randn(tuple(shape), generator=_generator(seed, device), device=device)


def uniform(seed: int, shape, device) -> torch.Tensor:
    """U[0, 1) fp32 of `shape` from a generator seeded `seed` on `device`."""
    return torch.rand(tuple(shape), generator=_generator(seed, device), device=device)


def initial_noise(model: DADD, batch: int, image_size: int, seed: int) -> torch.Tensor:
    """One initial latent an image, as psd_tpu's `sample(key,
    shared_noise=False)` draws them from its key."""
    return model.initial_noise(batch, image_size, _generator(seed, model.device),
                               shared_noise=False)


def bf16_state(sd: dict) -> dict:
    """Each fp32 tensor rounded to bf16 and held in fp32 again."""
    return {k: v.to(torch.bfloat16).float() if v.dtype == torch.float32 else v
            for k, v in sd.items()}


def bf16_tree(tree):
    """`bf16_state` of a flax tree of numpy leaves."""
    if isinstance(tree, dict):
        return {k: bf16_tree(v) for k, v in tree.items()}
    if tree.dtype != np.float32:
        return tree
    return torch.from_numpy(np.array(tree)).to(torch.bfloat16).float().numpy()


def real_init_core(core_cfg, device, seed: int = 0) -> dict:
    """The core's flax-style initialisation (`models.init.flax_init_`, psd_tpu's
    `init_core` in distribution) from a generator seeded `seed`: its fp32
    state_dict on `device`."""
    with torch.device(device):
        core = DADDCore(core_cfg)
    flax_init_(core, _generator(seed, device))
    return core.state_dict()


def real_init_vae(vae_cfg, device, seed: int = 1) -> dict:
    """The whole AutoencoderKL initialised flax-style from a generator seeded
    `seed` (psd_tpu's `vae.init(PRNGKey(1), ...)` in distribution), as a
    flax tree of numpy leaves."""
    with torch.device(device):
        vae = AutoencoderKL(vae_cfg)
    flax_init_(vae, _generator(seed, device))
    return {"params": to_flax_tree(vae.state_dict(), flax_shapes(vae))}


def fast_init_core(core_cfg) -> dict:
    """psd_tpu's `fast_init(model.core, ...)` as the port's fp32 state_dict (CPU)."""
    with torch.device("meta"):
        core = DADDCore(core_cfg)
    return state_dict_from_flax(fast_init(core), core)


def fast_init_vae(vae_cfg) -> dict:
    """psd_tpu's `fast_init(model.vae, ...)`: the whole AutoencoderKL's tree."""
    with torch.device("meta"):
        vae = AutoencoderKL(vae_cfg)
    return fast_init(vae)


def serving_model(cfg, device, tome: float = 0.0, tome_mode: str = "branch",
                  vae_quant: str = "none", quant: str = "none") -> DADD:
    """A bf16 serving model at the config's width with the UNet's and the
    decoder's levers, seeded 0 (its CLIP tower, built at first use, from a
    generator seeded 3, as psd_tpu's gates seed CLIP's init); the core's
    and the decoder's weights are the caller's to load (`load_weights`)."""
    core_cfg = core_config_from(cfg, remat=False, dtype=torch.bfloat16, quant=quant,
                                tome_ratio=tome, tome_mode=tome_mode)
    return DADD(cfg, core_cfg=core_cfg,
                vae_cfg=VAEConfig(dtype=torch.bfloat16, quant=vae_quant), device=device)


def load_weights(model: DADD, core_sd: dict, vae_tree: dict) -> DADD:
    """The (bf16-rounded fp32) core state_dict and VAE tree into `model`;
    its int8 weights, where it has any, come from those values."""
    model.load_core_state_dict({k: v.to(model.device) for k, v in core_sd.items()})
    return model.load_flax(vae_tree=vae_tree)


# ---- synthetic training --------------------------------------------------------------
def synth_batch(labels, base, anchors, noise, lat: int, n_cls: int) -> dict:
    """The class-structured batch: `base` (B, lat/4, lat/4, 4) resized
    linearly to lat, times 0.5 + 0.35·label, plus 0.3·(label − (n_cls −
    1)/2); CLIP features `anchors[label] + 0.1·noise`."""
    field = F.interpolate(base.permute(0, 3, 1, 2), size=(lat, lat), mode="bilinear",
                          align_corners=False).permute(0, 2, 3, 1)
    y = labels.float()
    amp = (0.5 + 0.35 * y)[:, None, None, None]
    bias = 0.3 * (y - (n_cls - 1) / 2)
    return {"latents": amp * field + bias[:, None, None, None], "labels": y,
            "clip_feats": anchors[labels] + 0.1 * noise}


def synth_optimizer(cfg, steps: int):
    """AdamW with warmup + cosine spread over `steps`: the schedule is
    epoch-wise, so `steps_per_epoch` partitions the run into max_epochs."""
    return build_optimizer(cfg, steps_per_epoch=max(steps // cfg.training.max_epochs, 1))


def synth_train(cfg, steps: int, *, image_size: int = 256, batch: int = 8, device="cuda",
                log=None):
    """`steps` AdamW steps of the SD-scale model on the class-structured
    synthetic task, one replay of `compile_train_step`'s program a step on
    the card. → (the core's fp32 state_dict, the per-class CLIP-feature
    anchors (n_cls, n_pos, c_dim)); `log`, a list, receives (step, loss,
    seconds) at each printed step. The train state (moments, EMA, its
    programs and their pool) is freed before it returns."""
    core_cfg = core_config_from(cfg, remat=True, dtype=torch.bfloat16)
    model = DADD(cfg, core_cfg=core_cfg, device=device, seed=0, for_training=True)
    dev = model.device
    lat = image_size // 8
    n_pos = model.clip_cfg.num_positions
    c_dim = core_cfg.clip_hidden_dim
    n_cls = cfg.dataset.num_classes
    tx = synth_optimizer(cfg, steps)
    # the step's draws from training.seed: a generator apart from the
    # batches' (two generators of one seed on one device draw one stream)
    state, tx = create_train_state(model, tx)
    step_fn = compile_train_step(model, tx)
    anchors = normal(11, (n_cls, n_pos, c_dim), dev)
    gen = _generator(5, dev)

    def make_batch():
        labels = torch.randint(0, n_cls, (batch,), generator=gen, device=dev)
        base = torch.randn((batch, lat // 4, lat // 4, 4), generator=gen, device=dev)
        noise = torch.randn((batch, n_pos, c_dim), generator=gen, device=dev)
        return synth_batch(labels, base, anchors, noise, lat, n_cls)

    t0 = time.perf_counter()
    for i in range(steps):
        state, metrics = step_fn(state, make_batch())
        if i % 100 == 0 or i == steps - 1:
            loss, sec = float(metrics["loss"]), time.perf_counter() - t0
            if log is not None:
                log.append((i, loss, sec))
            print(f"synth-train step {i}: loss={loss:.4f} ({sec:.0f}s)", flush=True)
    trained = {k: v.detach().clone() for k, v in model.core.state_dict().items()}
    state.drop_programs()
    del state, step_fn, metrics, model, tx
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return trained, anchors


# ---- the gate ------------------------------------------------------------------------------
def counted(trace) -> dict:
    """With `trace`: the kernel launch counts so far (`kernels.launch_counts`),
    then the counts set to 0, so that the next call's launches are read
    from 0; a record keeps what they held (`earlier`) and a caller sums a
    run's launches from its records. Without: nothing is touched."""
    if trace is None:
        return {}
    earlier = dict(kernels.launch_counts)
    kernels.reset_launch_counts()
    return earlier


def first_call(model: DADD, fn, trace, v: dict, steps: int):
    """`fn()`, a variant's first call (on the card its warm-up and
    capture), → its output; with `trace`, a record of the variant (`v`,
    `steps` its sampler's steps), the call's seconds, the kernel launches it
    made (counted from 0, `counted`), the call itself (`rerun`) and its
    output."""
    earlier = counted(trace)
    t0 = time.perf_counter()
    out = fn()
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    if trace is not None:
        trace.append({"name": v.get("name", "exact"), "variant": dict(v, steps=steps),
                      "model": model, "first_s": time.perf_counter() - t0,
                      "earlier": earlier, "launches": dict(kernels.launch_counts),
                      "rerun": fn, "output": out.clone()})
    return out


def programs_of(*models: DADD) -> list:
    """(kind, warm-up s, capture s, instantiation s) of each program the
    models hold (each model once)."""
    return [(key[0], p.warmup_s, p.capture_s, p.instantiate_s)
            for m in {id(m): m for m in models}.values() for key, p in m.programs.items()]


def timed_best(fn, reps: int = 3) -> float:
    """The best of `reps` runs of `fn` in seconds, each ending in a
    synchronize (a finite checksum read on the host)."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        s = float(fn().float().sum())
        assert np.isfinite(s)
        best = min(best, time.perf_counter() - t0)
    return best


def drop_programs(*models: DADD) -> None:
    """Free the models' captured programs (each model once)."""
    for m in {id(m): m for m in models}.values():
        m.drop_programs()


def as_numpy(x) -> np.ndarray:
    return x.detach().double().cpu().numpy()


def report(t0: float, device) -> None:
    """The run's wall seconds and, on the card, its peak allocated memory,
    on stderr (stdout keeps psd_tpu's lines)."""
    peak = (f", peak allocated {torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB"
            if device.type == "cuda" else "")
    print(f"wall {time.perf_counter() - t0:.1f} s{peak}", file=sys.stderr, flush=True)


def main(argv=None, trace=None, train_log=None) -> dict:
    """Run the gate; → its table. `trace`, a list, receives one record a
    sampled variant (`first_call`); `train_log`, a list, synth-train's
    printed (step, loss, seconds)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--train-steps", type=int, default=0,
                    help="first train the SD-scale model this many steps on "
                         "a class-structured synthetic task, then gate on "
                         "those weights (see docstring)")
    ap.add_argument("--variants", type=str, default=DEFAULT_VARIANTS)
    ap.add_argument("--out", type=str, default=None,
                    help="also write the table to this JSON file")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    variants = [parse_variant(t) for t in args.variants.split(",")]
    device = cli_device(args.device)
    cfg = Config()
    t0 = time.perf_counter()

    if args.train_steps > 0:
        trained, anchors = synth_train(cfg, args.train_steps, batch=args.batch, device=device,
                                       log=train_log)
        core_sd = bf16_state(trained)
        del trained
        weights_note = (f"synthetic-trained {args.train_steps} steps "
                        "(class-structured latents + per-class CLIP "
                        "anchors; in-distribution conditioning)")
        vae_tree = bf16_tree(real_init_vae(VAEConfig(dtype=torch.bfloat16), device))
    else:
        core_sd = bf16_state(fast_init_core(core_config_from(cfg, remat=False)))
        weights_note = "random-init (upper bound; see --train-steps)"
        vae_tree = bf16_tree(fast_init_vae(VAEConfig(dtype=torch.bfloat16)))
    core_sd = {k: v.to(device) for k, v in core_sd.items()}

    models = {}

    def get_model(tome: float, tome_mode: str = "branch") -> DADD:
        key = (tome, tome_mode)
        if key not in models:
            models[key] = load_weights(serving_model(cfg, device, tome, tome_mode), core_sd,
                                       vae_tree)
        return models[key]

    base_model = get_model(0.0)
    n_tok = 3 * base_model.core_cfg.num_aoe_tokens
    if args.train_steps > 0:
        # in-distribution conditioning: training pairs class y's CLIP
        # features with label y and source == target (delta tokens 0)
        n_cls = cfg.dataset.num_classes
        tgt = torch.arange(n_cls, dtype=torch.float32).repeat(
            (args.batch + n_cls - 1) // n_cls)[:args.batch].to(device)
        cond = base_model.prepare_inference_cond(tgt, tgt, anchors[tgt.long()])
    else:
        cond = normal(0, (args.batch, n_tok, 768), device)

    def run(v):
        """(final latents, decoded images, best s/batch over 3 timed reps)."""
        model = get_model(v["tome"], v.get("tome_mode", "branch"))

        def lat_fn():
            return model.sample(
                cond, initial_noise(model, args.batch, args.size, 7),
                sampling_steps=v.get("steps") or args.steps, steer_scale=1.0,
                encoder_stride=v["stride"], cache_mode=v["cache_mode"],
                sampler=v.get("sampler", "ddim"))

        latents = first_call(model, lat_fn, trace, v, v.get("steps") or args.steps)
        imgs = as_numpy(base_model.decode_latents(latents.float()))
        if trace is not None:
            trace[-1]["programs"] = programs_of(model, base_model)
        best = timed_best(lat_fn)
        drop_programs(model, base_model)
        return as_numpy(latents), imgs, best

    lat1, img1, t1 = run(EXACT)
    # converged-DPM baseline (only if a dpm variant is requested): DPM-N
    # against DPM at --steps separates step-count loss from solver identity
    lat_dpm50 = img_dpm50 = None
    if any(v.get("sampler") == "dpm" for v in variants):
        lat_dpm50, img_dpm50, _ = run(dict(EXACT, name="dpm_converged", sampler="dpm",
                                           steps=args.steps))
    rows = []

    def table() -> dict:
        return {
            "metric": "turbo_quality_vs_exact",
            "exact_s_per_batch": round(t1, 4),
            "exact_img_per_s_ex_vae": round(args.batch / t1, 4),
            "steps": args.steps,
            "size": args.size,
            "batch": args.batch,
            "weights": weights_note,
            "rows": rows,
        }

    for v in variants:
        lat_s, img_s, t_s = run(v)
        rel = float(np.linalg.norm(lat_s - lat1) / max(np.linalg.norm(lat1), 1e-12))
        mse = float(np.mean((img_s - img1) ** 2))
        psnr = 10.0 * np.log10(1.0 / max(mse, 1e-12))
        row = {
            "variant": v["name"],
            "latent_rel_error": round(rel, 6),
            "psnr_vs_exact_db": round(psnr, 2),
            "s_per_batch": round(t_s, 4),
            "img_per_s_ex_vae": round(args.batch / t_s, 4),
            "speedup_vs_exact": round(t1 / t_s, 4),
        }
        if v.get("sampler") == "dpm" and lat_dpm50 is not None:
            rel50 = float(np.linalg.norm(lat_s - lat_dpm50)
                          / max(np.linalg.norm(lat_dpm50), 1e-12))
            mse50 = float(np.mean((img_s - img_dpm50) ** 2))
            row["latent_rel_error_vs_dpm_converged"] = round(rel50, 6)
            row["psnr_vs_dpm_converged_db"] = round(
                10.0 * np.log10(1.0 / max(mse50, 1e-12)), 2)
        rows.append(row)
        print(json.dumps(rows[-1]), flush=True)
        if args.out:  # incremental: a timeout loses one variant, not the run
            Path(args.out).write_text(json.dumps(table(), indent=1))

    print(json.dumps(table()), flush=True)
    report(t0, device)
    return table()


if __name__ == "__main__":
    main()
