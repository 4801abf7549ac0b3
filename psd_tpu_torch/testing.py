"""Helpers shared by the tests and chip_smoke.py: the tiny full-stack
factory (the same shapes as `psd_tpu.testing.tiny_dadd()`: split3 routing,
AOE, IP-Plus, purifier; fp32, seeded flax-style init), the kernel launches
the routes give a generate call (`route_launches`), and the judges that
hold a kernel's output to its plain version by relative L2 error
(attention forward and backward, the int8 attention, the LayerNorm-fused
GEMMs, gn_proj, split3)."""

from __future__ import annotations

import functools
from collections import Counter
from typing import Dict

import torch

from .core.config import Config
from .diffusion.dadd import DADD, DADDCoreConfig
from .models.layers import gn_proj_ok, ln_fused_ok, split3_kernel_ok
from .models.clip import tiny_clip_config
from .models.unet import tiny_unet_config
from .models.vae import VAEConfig, tiny_vae_config
from .ops.attention import kernel_route
from .ops.quant import quant_worthwhile


def tiny_dadd(device="cpu", seed=0, for_training=False, routing=True, purifier=True, plus=True,
              embedder="aoe", **unet_overrides) -> DADD:
    """The tiny DADD of `psd_tpu.testing.tiny_dadd(routing, purifier, plus)`:
    split3 routing with routing gates, else split2; the purifier; IP-Plus,
    else the plain ImageProjection; `embedder` "aoe" or "boe"."""
    cfg = Config()
    cfg.dataset.image_size = 32
    cfg.diffusion.sampling_steps = 4
    cfg.model.use_routing_gates = routing
    core_cfg = DADDCoreConfig(
        unet=tiny_unet_config(
            attn_mode="split3" if routing else "split2",
            num_aoe_tokens=4,
            num_image_tokens=4,
            num_delta_tokens=4,
            **unet_overrides,
        ),
        embedding_dim=32,
        conditioning_dim=32,
        num_classes=4,
        num_aoe_tokens=4,
        num_image_tokens=4,
        embedder_type=embedder,
        use_image_projection_plus=plus,
        use_feature_purifier=purifier,
        use_routing_gates=routing,
        purifier_num_heads=2,
        clip_hidden_dim=32,
        clip_projection_dim=16,
    )
    return DADD(cfg, core_cfg=core_cfg, vae_cfg=tiny_vae_config(), clip_cfg=tiny_clip_config(),
                dtype=torch.float32, device=device, seed=seed, for_training=for_training)


def route_launches(core_cfg: DADDCoreConfig, vae_cfg: VAEConfig, batch: int, image_size: int,
                   full_steps: int, shallow_steps: int = 0, cfg_pass: bool = False,
                   decode: bool = True, tp: int = 1) -> Dict[str, int]:
    """The hand-written kernels one generate call launches, from the routes'
    own gates (`ln_fused_ok`, `gn_proj_ok`, `split3_kernel_ok`,
    `kernel_route`) at its shapes: `full_steps` full UNet evaluations and
    `shallow_steps` DeepCache shallow ones at `batch` (twice that with
    `cfg_pass`, CFG's one call over [cond | uncond]), then, with `decode`,
    the VAE decode at `batch`. Inference mode, every kernel on. One
    evaluation without the decode is a validation loss's forward. The UNet's
    levers move the routes: under ToMe each merged branch runs at its merged
    length (`ToMeSpec.merged_tokens`); the int8 UNet takes gn_proj nowhere
    and the LayerNorm kernels only below MIN_QUANT_K channels. On a rank of
    a tp mesh (`tp` > 1; `batch` is then the rank's rows) each site whose
    heads tp divides runs H/tp heads, ln_proj C/tp columns and ln_geglu
    4C/tp a half (`parallel/mesh.py::cut_tp_`); the int8 UNet's gates read
    the whole C there, so its LayerNorm kernels run where one process's do,
    at the rank's columns."""
    u = core_cfg.unet
    lat = image_size // 2 ** (len(vae_cfg.block_out_channels) - 1)
    B = batch * (2 if cfg_pass else 1)
    n_ctx = core_cfg.num_aoe_tokens + core_cfg.num_image_tokens + (
        u.num_delta_tokens if u.attn_mode == "split3" else 0)
    meta = functools.partial(torch.empty, device="meta")
    tome = u.tome_spec if u.tome_ratio > 0.0 else None

    def per_eval(shallow: bool) -> Counter:
        c = Counter()
        for _, level, C, mode in u.transformer_sites(shallow):
            S = (lat >> level) ** 2
            H, D = u.num_heads, C // u.num_heads
            # the rank's heads and columns where tp cuts the site
            H, N = (H // tp, C // tp) if H % tp == 0 else (H, C)
            N_ff = 4 * C // tp if 4 * C % tp == 0 else 4 * C
            # the lengths attn1, attn2 and the FF run at
            S1 = S2 = S3 = S
            if tome is not None and tome.active(S):
                block = tome.mode == "block"
                S1 = tome.merged_tokens(S)
                S2 = S1 if block or tome.merge_cross else S
                S3 = S1 if block or tome.merge_mlp else S
            ln = not (u.quant == "int8" and quant_worthwhile(C))
            c["gn_proj"] += u.quant != "int8" and gn_proj_ok(S, C)
            c["ln_proj"] += ln * (ln_fused_ok(meta((B, S1, C)), N)
                                  + ln_fused_ok(meta((B, S2, C)), N))
            c["ln_geglu"] += ln and ln_fused_ok(meta((B, S3, C)), N_ff)
            q1, q2 = meta((B, S1, H, D)), meta((B, S2, H, D))
            c["attention"] += kernel_route(q1, q1) is not None
            if mode.kind == "split3":
                lens = [mode.num_image_tokens, mode.num_aoe_tokens, mode.num_delta_tokens]
                c["split3"] += split3_kernel_ok(B, S2, H, D, lens)
            else:
                c["attention"] += kernel_route(q2, meta((B, n_ctx, H, D))) is not None
        return c

    total = Counter()
    for shallow, times in ((False, full_steps), (True, shallow_steps)):
        for k, v in per_eval(shallow).items():
            total[k] += v * times
    if decode:
        C = vae_cfg.block_out_channels[-1]  # the decoder's single-head mid-block attention
        vae_q = meta((batch, lat * lat, 1, C))
        total["attention"] += kernel_route(vae_q, vae_q) is not None
    return {k: total[k] for k in ("attention", "split3", "ln_proj", "ln_geglu", "gn_proj")}


# The attention forward (attention_narrow.cu at D <= 160, the UNet's 40 and
# 80; attention_wide.cu above, the VAE mid block's 512) against
# attention_reference, bf16. The two round p to bf16 at other points (the
# kernel before the division by l, the plain version after it) and round
# their outputs to bf16: on an H100 the sound kernels read relative L2
# 3.1e-3 over the output and, on their worst query row, 6.4e-3 at
# (8, 4096, 8, 40), 5.2e-3 at (8, 1024, 8, 80) and 4.0e-3 at
# (8, 4096, 1, 512). The old bf16 band 1e-2 + 1e-2·max|ref| is about half
# the output's RMS there. Planted faults read, over the output / on the
# worst row: at narrow heads (a dropped key tile, one warpgroup's O not
# rescaled on the last tile, the padding columns filled from the neighbour
# head) ≥ 4.6e-2 / ≥ 0.91 wherever they change the output; at D = 512 (a
# dropped key tile, a warpgroup's half not rescaled, a V box from the wrong
# columns) 4.0e-2–0.50 / 0.68–2.2 (PERF.md §6, PRs 5 and 6). Both bands sit
# between the sound readings and the faults'.
ATTN_REL_L2_BAND, ATTN_ROW_BAND = 1e-2, 2e-2
# the kernels' per-row log-sum-exp (log2 units) against lse_reference: max
# abs error; the sound kernels read 3.5e-4 at (8, 4096, 8, 40) and 2.5e-4 at
# (8, 4096, 1, 512) on an H100
ATTN_LSE_BAND = 2e-3


def rel_l2_judge(out: torch.Tensor, ref: torch.Tensor, rel_band: float, row_band: float):
    """(ok, text, readings): the relative L2 error of the whole output and
    the largest over its rows (the last axis: one query row's D outputs),
    against `rel_band` and `row_band`."""
    out, ref = out.float(), ref.float()
    diff = out - ref
    rel = (diff.norm() / ref.norm()).item()
    row = (diff.norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)).max().item()
    text = f"rel L2 {rel:.3e} (band {rel_band:g}), worst row {row:.3e} (band {row_band:.3g})"
    return rel <= rel_band and row <= row_band, text, {"rel_l2": rel, "worst_row_rel": row}


def attention_judge(out: torch.Tensor, ref: torch.Tensor):
    """rel_l2_judge at the attention bands."""
    return rel_l2_judge(out, ref, ATTN_REL_L2_BAND, ATTN_ROW_BAND)


# attention_q8 (csrc/attention_q8.cu, "qk8" and "int8") against
# attention_q8_reference on the same quantized operands, bf16 out. Both
# compute the same fp32 values up to the summation order of l and of P·V,
# then round to bf16: an output that lands on the other side of a rounding
# boundary moves one bf16 ulp (2^-9..2^-7 relative). In "int8" the order of l
# also moves pn/ps across a half now and then, which flips one quantized
# probability by one level and moves its row by ps·|v_j|, about 2e-3..3e-3 of
# the row's norm at chip_smoke.py's Q8_SHAPES. Bands: the relative L2 error
# of the whole (B, S, H, D) output, and of each query row (its D outputs)
# against one bf16 ulp. Faults planted in the kernel read above them wherever
# they change the output (PERF.md §6; emulated on the CPU by
# tests/test_torch_kernels.py::test_attention_q8_judge_sees_planted_faults).
Q8_REL_L2_BAND, Q8_ROW_BAND = 2e-3, 2.0 ** -7


def attention_q8_judge(out: torch.Tensor, ref: torch.Tensor):
    """rel_l2_judge at attention_q8's bands, and finite outputs."""
    ok, text, readings = rel_l2_judge(out, ref, Q8_REL_L2_BAND, Q8_ROW_BAND)
    return ok and bool(torch.isfinite(out).all()), text, readings


# The attention backward (attention_bwd.cu, D <= 160) against
# attention_bwd_reference (autograd through attention_reference), bf16:
# each of dQ, dK and dV over the whole gradient and on its worst row (a
# query row of dQ, a key row of dK and dV: the last axis). The two round at
# other points (the kernel P and dS before its products, the plain version
# dP and its outputs). On an H100 the sound kernel reads ≤ 3.4e-3 over each
# gradient and ≤ 8.0e-3 on its worst row at the training shapes and the edge
# shapes. Faults planted in it read, where they change a gradient: lse +
# 0.02 (P off by 1.4%) 1.41e-2–1.42e-2 over each and ≥ 1.77e-2 on the worst
# row; a pass's last tile dropped ≥ 0.12 / ≥ 0.82 (one tile of 64 at
# S = 4096); the neighbour head's padding columns at D = 40 ≥ 0.52 / ≥ 3.8
# (PERF.md §6 PR 7; emulated on the CPU by
# tests/test_torch_kernels.py::test_attention_bwd_judge_sees_planted_faults).
# Both bands sit between the sound readings and the faults'.
ATTN_BWD_REL_L2_BAND, ATTN_BWD_ROW_BAND = 8e-3, 2e-2


def attention_bwd_judge(grads, refs):
    """rel_l2_judge of each of (dq, dk, dv) against its plain version at the
    backward's bands; readings keyed "dq_rel_l2", "dq_worst_row_rel", …"""
    ok, texts, readings = True, [], {}
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        good, text, red = rel_l2_judge(g, r, ATTN_BWD_REL_L2_BAND, ATTN_BWD_ROW_BAND)
        ok = ok and good and bool(torch.isfinite(g).all())
        texts.append(f"{name} {text}")
        readings.update({f"{name}_{k}": v for k, v in red.items()})
    return ok, "; ".join(texts), readings


# The LayerNorm-fused GEMMs (ln_gemm_sm90.cuh: ln_proj_fwd's 1 or 3 outputs,
# ln_geglu_fwd's one) against ln_proj_reference / ln_geglu_reference, bf16:
# each output over the whole output and on its worst row (one row's N
# columns). Both round x̂ and the outputs to bf16 and sum in other orders;
# the plain GEGLU also rounds h and g to bf16 before the gate, where the
# kernel keeps them in fp32. On an H100 the sound kernels read ≤ 4.4e-4 /
# ≤ 3.0e-3 (ln_proj) and ≤ 3.47e-3 / ≤ 7.2e-3 (ln_geglu) at chip_smoke.py's
# LN_SHAPES and edge inputs (rows of large mean included). Faults planted in
# them (scripts/torch_ln_gemm_variants.py: the last K chunk dropped, row r
# taking row r+1's statistics, the neighbour K chunk's LN affine, GEGLU's
# gate from column j+8) read ≥ 4.7e-2 / ≥ 0.128 wherever they change an
# output (PERF.md §6, the LayerNorm GEMMs' entry; emulated on the CPU by
# tests/test_torch_kernels.py::test_ln_gemm_judge_sees_planted_faults). Both
# bands sit between the sound readings and the faults'.
LN_REL_L2_BAND, LN_ROW_BAND = 1e-2, 2e-2


def ln_gemm_judge(outs, refs):
    """rel_l2_judge of each output of an LN-fused GEMM (a tensor or a tuple
    of them) against its plain version at the LN bands; readings are the
    largest over the outputs."""
    outs = outs if isinstance(outs, tuple) else (outs,)
    refs = refs if isinstance(refs, tuple) else (refs,)
    ok, texts, worst = True, [], {"rel_l2": 0.0, "worst_row_rel": 0.0}
    for i, (o, r) in enumerate(zip(outs, refs)):
        good, text, red = rel_l2_judge(o, r, LN_REL_L2_BAND, LN_ROW_BAND)
        ok = ok and good and bool(torch.isfinite(o).all())
        texts.append(text if len(outs) == 1 else f"out {i}: {text}")
        worst = {k: max(worst[k], v) for k, v in red.items()}
    return ok, "; ".join(texts), worst


# gn_proj (ln_gemm_sm90.cuh, Kind::kGn) against gn_proj_reference, bf16:
# over the whole (B, S, N) output and on its worst row (one row's N
# columns). Both round x̂ = x·w + b to bf16 the same way; the plain version
# rounds the product to bf16 before adding the fp32 bias and rounds again,
# the kernel adds the bias to its fp32 sums and rounds once. On an H100 the
# sound kernel reads ≤ 2.90e-3 / ≤ 3.96e-3 at chip_smoke.py's GN_SHAPES and
# edge inputs (half-full last row tiles, N = 200, channel means of std 8
# folded into the affine); faults planted in it (scripts/
# torch_ln_gemm_variants.py: the other batch slot's affine, the last K chunk
# dropped, the bias dropped, a half-full last tile's stores not issued) read
# ≥ 1.96e-2 / ≥ 2.10e-2 wherever they change the output, the dropped bias
# (std 2% of the output's) the least (PERF.md §6 PR 9; emulated on the CPU
# by tests/test_torch_kernels.py::test_gn_proj_judge_sees_planted_faults).
# Both bands sit between.
GN_REL_L2_BAND, GN_ROW_BAND = 1e-2, 1e-2


def gn_proj_judge(out: torch.Tensor, ref: torch.Tensor):
    """rel_l2_judge at gn_proj's bands, and finite outputs."""
    ok, text, readings = rel_l2_judge(out, ref, GN_REL_L2_BAND, GN_ROW_BAND)
    return ok and bool(torch.isfinite(out).all()), text, readings


# split3 (csrc/split3.cu) against split3_reference, bf16: over the whole
# (B, S, H, D) output and on its worst row (one query row's D outputs of one
# head). The kernel scales each bank's probabilities by its gate before
# rounding them to bf16 and sums the three products in fp32 (fp32 gates
# and δ); the plain version rounds the gates and δ to bf16, as psd_tpu's
# does, then each attention's output, each gated term and their sums. On an
# H100 the sound kernel reads ≤ 4.10e-3 / ≤ 9.87e-3 at chip_smoke.py's
# SPLIT3_SHAPES and edge inputs (≤ 4.10e-3 / ≤ 9.19e-3 against fp32 gates
# in the plain version); faults planted in it
# (scripts/torch_split3_variants.py: a bank's last valid key masked, one
# padded key let in, δ on the anatomy bank, the neighbour head's q, a
# 16-row unit skipped) read ≥ 8.59e-2 / ≥ 0.246 wherever they change the
# output (PERF.md §6 PR 9; emulated on the CPU by
# tests/test_torch_kernels.py::test_split3_judge_sees_planted_faults). Both
# bands sit between.
SPLIT3_REL_L2_BAND, SPLIT3_ROW_BAND = 1e-2, 3e-2


def split3_judge(out: torch.Tensor, ref: torch.Tensor):
    """rel_l2_judge at split3's bands, and finite outputs."""
    ok, text, readings = rel_l2_judge(out, ref, SPLIT3_REL_L2_BAND, SPLIT3_ROW_BAND)
    return ok and bool(torch.isfinite(out).all()), text, readings
