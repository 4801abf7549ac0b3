"""Distribution-level turbo gate without JAX: FID + CMMD, exact against each
serving point, on the port.

The port's counterpart of `scripts/check_turbo_distribution.py`, with its
flags (plus `--device`) and its JSON, key for key, so
`scripts/check_gate_stability.py` reads either script's tables:

  1. optionally synth-train the SD-scale model (`torch_check_stride_quality.
     synth_train`) so the eps field has class and t structure;
  2. generate matched image sets (the same noise seeds and conditioning)
     with the exact path (DDIM --steps) and with every variant, each
     decoded through the variant's own VAE path (`int8`: the W8A8 decoder);
  3. FID (`metrics/fid.py::fid_from_features` on Inception pool features,
     every set divided by one shared scale, the exact set's feature RMS)
     and CMMD (`metrics/cmmd.py::compute_cmmd` on CLIP embeddings) between
     the exact set and each variant's (`pipelines/evaluate.py::FeatureBank`);
  4. a noise floor: every pairwise distance among --repeats + 1 exact sets
     of fresh seeds, and a signal check against uniform noise images;
  5. DPM variants scored against exact DDIM and against converged DPM
     (dpm50, computed up front whenever a dpm variant is asked for);
  6. every matched comparison over --repeats seed bases, mean ± std.

Weights: the core flax-style initialised (`models.init.flax_init_`,
psd_tpu's `init_core` in distribution) or synth-trained; the whole
AutoencoderKL flax-style from a generator seeded 1; both rounded to bf16
(psd_tpu casts its trees to bf16), so the int8 decoder's codes come from
the values psd_tpu quantizes. The backbones are random (no pretrained
weights): CLIP the serving model's own tower (seeded 3), Inception
FeatureBank's seeded one; random-feature FID compares runs only with the
same backbone seeds. Draws: a set's batch i from a torch.Generator seeded
seed_base + i, seed bases 100 + 1000 r, the floor's extra set 100 + 1000 R
+ 433, the uniform noise 999, the anchors 11. Each variant's captured
programs are freed once its sets are drawn (`DADD.drop_programs`).

    python scripts/torch_check_turbo_distribution.py --train-steps 500 \\
        [--steps 50] [--size 512] [--images 64] [--repeats 3] \\
        [--variants dpm50,dpm25,deep5,int8] [--out table.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_check_stride_quality import (  # noqa: E402
    Config, VAEConfig, bf16_state, bf16_tree, core_config_from, counted, initial_noise,
    load_weights, normal, parse_variant, programs_of, real_init_core, real_init_vae, report,
    serving_model, synth_train, uniform)

from psd_tpu_torch.metrics.cmmd import compute_cmmd  # noqa: E402
from psd_tpu_torch.metrics.fid import fid_from_features  # noqa: E402
from psd_tpu_torch.ops import kernels  # noqa: E402
from psd_tpu_torch.pipelines.common import add_device_arg, cli_device  # noqa: E402
from psd_tpu_torch.pipelines.evaluate import FeatureBank  # noqa: E402

DEFAULT_VARIANTS = ("dpm50,dpm25,tome0.5,deep3,deep5,enc2,enc3,int8,tome0.5+deep5,"
                    "dpm25+tome0.5+deep5,dpm25+tome0.5+deep5+int8")
EXACT = {"name": "exact", "tome": 0.0, "tome_mode": "branch", "stride": 1,
         "cache_mode": "encoder", "sampler": "ddim", "steps": None, "vae_quant": "none"}


def main(argv=None, trace=None, train_log=None) -> dict:
    """Run the gate; → its table. `trace`, a list, receives one record a
    variant (its host launches over all its sets, its programs' seconds);
    `train_log` as in the stride gate."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=50, help="exact-baseline DDIM steps")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--images", type=int, default=64,
                    help="images per set (rounded down to a batch multiple)")
    ap.add_argument("--train-steps", type=int, default=500)
    ap.add_argument("--repeats", type=int, default=3,
                    help="matched generation repeats per variant (fresh seed base each): "
                         "rows report mean±std so every distance carries an error bar")
    ap.add_argument("--variants", type=str, default=DEFAULT_VARIANTS)
    ap.add_argument("--out", type=str, default=None)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    variants = [parse_variant(t) for t in args.variants.split(",")]
    n_batches = max(args.images // args.batch, 1)
    device = cli_device(args.device)
    cfg = Config()
    t_start = time.perf_counter()

    base_model = serving_model(cfg, device)
    models = {(0.0, "branch", "none"): base_model}
    n_cls = cfg.dataset.num_classes
    if args.train_steps > 0:
        trained, anchors = synth_train(cfg, args.train_steps, batch=args.batch, device=device,
                                       log=train_log)
        core_sd = bf16_state(trained)
        del trained
        weights_note = (f"synthetic-trained {args.train_steps} steps "
                        "(real flax init; warmup+cosine spread over the "
                        "run; in-distribution conditioning)")
    else:
        # random real-init weights (upper-bound regime; see --train-steps)
        core_sd = bf16_state(real_init_core(core_config_from(cfg, remat=False), device))
        anchors = normal(11, (n_cls, base_model.clip_cfg.num_positions,
                              base_model.core_cfg.clip_hidden_dim), device)
        weights_note = "random real-flax-init (upper bound; see --train-steps)"
    print("init VAE/CLIP/Inception (real flax init)...", flush=True)
    vae_tree = bf16_tree(real_init_vae(VAEConfig(dtype=torch.bfloat16), device))
    load_weights(base_model, core_sd, vae_tree)
    bank = FeatureBank(base_model, allow_random_backbones=True)

    def get_model(tome: float, tome_mode: str = "branch", vae_quant: str = "none"):
        key = (tome, tome_mode, vae_quant)
        if key not in models:
            models[key] = load_weights(serving_model(cfg, device, tome, tome_mode, vae_quant),
                                       core_sd, vae_tree)
        return models[key]

    # in-distribution conditioning, as the stride gate builds it
    tgt = torch.arange(n_cls, dtype=torch.float32).repeat(
        (args.batch + n_cls - 1) // n_cls)[:args.batch].to(device)
    cond = base_model.prepare_inference_cond(tgt, tgt, anchors[tgt.long()])

    def gen_set(v: dict, seed_base: int, first: dict = None) -> np.ndarray:
        """n_batches batches → (N, H, W, 3) images in [0, 1]; batch i's
        initial latents from seed_base + i, so sets of one seed_base are
        matched across variants; decoded through the variant's VAE path.
        `first`, an empty dict, receives batch 0's latents and images."""
        model = get_model(v["tome"], v.get("tome_mode", "branch"), v.get("vae_quant", "none"))
        out = []
        for i in range(n_batches):
            lat = model.sample(
                cond, initial_noise(model, args.batch, args.size, seed_base + i),
                sampling_steps=v.get("steps") or args.steps, steer_scale=1.0,
                encoder_stride=v["stride"], cache_mode=v["cache_mode"],
                sampler=v.get("sampler", "ddim"))
            out.append(model.decode_latents(lat.float()).float().cpu().numpy())
            if first is not None and not first:
                first.update(latents=lat.float().cpu().numpy(), images=out[0])
        return np.concatenate(out, axis=0)

    def gen_sets(v: dict, seed_bases) -> list:
        """The variant's sets, one a seed base; with `trace`, a record of
        the host launches they made (counted from 0, `counted`), their
        programs and the first set's batch 0 (`first`); then its programs
        are freed."""
        model = get_model(v["tome"], v.get("tome_mode", "branch"), v.get("vae_quant", "none"))
        earlier = counted(trace)
        t0 = time.perf_counter()
        first = {} if trace is not None else None
        sets = [gen_set(v, sb, first) for sb in seed_bases]
        if trace is not None:
            trace.append({"name": v["name"], "variant": dict(v, steps=v.get("steps")
                                                             or args.steps),
                          "model": model, "sets": len(sets), "seconds": time.perf_counter() - t0,
                          "earlier": earlier, "launches": dict(kernels.launch_counts),
                          "programs": programs_of(model), "first": first})
        model.drop_programs()
        return sets

    # Random-init Inception attenuates activations by orders of magnitude,
    # so raw-feature FID rounds to an unreadable 0.0. FID is homogeneous of
    # degree 2 in the feature scale: dividing every set by one shared
    # constant (the exact set's feature RMS) is a unit change.
    incep_scale = {"v": None}

    def feats_of(images: np.ndarray) -> dict:
        f = bank.inception(images).double().cpu().numpy()
        if incep_scale["v"] is None:
            incep_scale["v"] = float(np.sqrt(np.mean(f ** 2))) or 1.0
        return {"incep": f / incep_scale["v"], "clip": bank.clip(images)}

    def dist(fa: dict, fb: dict) -> dict:
        return {"fid": round(float(fid_from_features(fa["incep"], fb["incep"])), 6),
                "cmmd": round(float(compute_cmmd(fa["clip"], fb["clip"])), 6)}

    R = max(args.repeats, 1)
    seed_bases = [100 + 1000 * r for r in range(R)]

    # R matched exact sets (one a repeat) + 1 extra for the noise floor
    t0 = time.perf_counter()
    exact_sets = gen_sets(EXACT, seed_bases + [100 + 1000 * R + 433])
    f_exact = [feats_of(s) for s in exact_sets[:R]]
    for r in range(R):
        print(f"exact set {r + 1}/{R} done ({time.perf_counter() - t0:.0f}s)", flush=True)
    f_floor_extra = feats_of(exact_sets[R])
    del exact_sets
    # noise floor: every pairwise distance among the R + 1 exact sets (pairs
    # share sets, so the std is a spread, not an independent-sample std)
    all_exact = f_exact + [f_floor_extra]
    floor_samples = [dist(all_exact[i], all_exact[j])
                     for i in range(len(all_exact)) for j in range(i + 1, len(all_exact))]

    def stats(samples) -> dict:
        out = {}
        for k in ("fid", "cmmd"):
            vals = np.asarray([s[k] for s in samples], np.float64)
            out[k] = round(float(vals.mean()), 6)
            out[k + "_std"] = round(float(vals.std()), 6)
        out["n"] = len(samples)
        return out

    floor = stats(floor_samples)
    print(f"noise floor (pairwise among {len(all_exact)} exact sets): {floor}", flush=True)
    # signal check: a known-different distribution (uniform noise images)
    # at the same sample count; if it is not well above the floor, the
    # backbone/metric pair cannot discriminate here
    noise_imgs = uniform(999, (n_batches * args.batch, args.size, args.size, 3),
                         device).cpu().numpy()
    signal = dist(f_exact[0], feats_of(noise_imgs))
    print(f"signal check (exact vs uniform noise): {signal}", flush=True)

    rows = []
    # the converged-DPM baseline, up front whenever a dpm variant is asked for
    f_dpm50 = None
    if any(v.get("sampler") == "dpm" for v in variants):
        dpm50_v = next((v for v in variants if v["name"] == "dpm50"), None)
        dpm50_v = dpm50_v or parse_variant("dpm50")
        print("generating converged-DPM (dpm50) baseline sets...", flush=True)
        f_dpm50 = [feats_of(s) for s in gen_sets(dpm50_v, seed_bases)]

    def table() -> dict:
        return {
            "metric": "turbo_distribution_vs_exact",
            "exact_steps": args.steps,
            "size": args.size,
            "images_per_set": n_batches * args.batch,
            "repeats": R,
            "weights": weights_note,
            "backbones": "real-flax-init random (no pretrained weights in "
                         "env; see module docstring)",
            "noise_floor_fresh_seeds": floor,
            "signal_check_vs_uniform_noise": signal,
            "inception_feature_rms": incep_scale["v"],
            "rows": rows,
        }

    for v in variants:
        tv = time.perf_counter()
        # dpm50's features were already computed for the baseline sets above
        f_vs = f_dpm50 if (v["name"] == "dpm50" and f_dpm50 is not None) \
            else [feats_of(s) for s in gen_sets(v, seed_bases)]
        row = {"variant": v["name"], **stats([dist(f_exact[r], f_vs[r]) for r in range(R)])}
        if v["name"] != "dpm50" and v.get("sampler") == "dpm" and f_dpm50 is not None:
            # solver against degradation: the distance to converged DPM
            d50 = stats([dist(f_dpm50[r], f_vs[r]) for r in range(R)])
            row["fid_vs_dpm50"] = d50["fid"]
            row["fid_vs_dpm50_std"] = d50["fid_std"]
            row["cmmd_vs_dpm50"] = d50["cmmd"]
            row["cmmd_vs_dpm50_std"] = d50["cmmd_std"]
        row["gen_s"] = round(time.perf_counter() - tv, 1)
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            Path(args.out).write_text(json.dumps(table(), indent=1))

    print(json.dumps(table()), flush=True)
    report(t_start, device)
    return table()


if __name__ == "__main__":
    main()
