#!/usr/bin/env python3
"""Variants of the attention backward (`psd_tpu_torch/csrc/attention_bwd.cu`)
on one NVIDIA GPU (H100): where its time goes, and whether
`attention_bwd_judge` sees planted faults.

    python3 scripts/torch_attention_bwd_variants.py                  # every variant
    python3 scripts/torch_attention_bwd_variants.py d_no_exp fault_lse_offset
    python3 scripts/torch_attention_bwd_variants.py --tree PARENT     # also another checkout
    python3 scripts/torch_attention_bwd_variants.py --trees-only --rounds 3 --tree A --tree B

Each variant is one edit of the kernel source (VARIANTS below): another
design choice, a diagnostic that drops one piece of work ("d_*", wrong
gradients on purpose) or a planted fault ("fault_*", as chip_smoke.py's
bands were set against). Each is built in a copy of `psd_tpu_torch/` under
`build/psd_tpu_torch/bwd_variants/<name>/` (git-ignored), four builds at
once, with the helpers of scripts/torch_attention_variants.py. Then each
variant, the checkout as it is ("as_built", first and last, to show the
drift within the call) and each `--tree` run one after another, each in its
own process (with `--rounds N`, N rounds, every other one in reverse
order, as_built first and last in each), at chip_smoke.py's
ATTN_BWD_SHAPES, seeded N(0,1) bf16 inputs: the backward's time given the
forward's output and lse (CUDA events, median of 20 after 3 warm-up calls),
and dQ, dK, dV against attention_bwd_reference by relative L2 over each
gradient and on its worst row, held to `attention_bwd_judge`'s bands.
Prints ptxas's registers and spills of the dQ and dK/dV kernels at Dp = 48
and 80, nvcc's warnings on attention_bwd.cu, and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
from torch_attention_variants import _in, _rep, compile_tree, make_tree  # noqa: E402

SRC = "psd_tpu_torch/csrc/attention_bwd.cu"
OUT = ROOT / "build" / "psd_tpu_torch" / "bwd_variants"
SHAPES = [(64, 1024, 8, 40), (8, 4096, 8, 40), (8, 1024, 8, 80)]

_DQ_S = "        fence_regs(dp);\n"
_DKV_S = "        fence_regs(dpt);\n"
_DQ_AFTER = _DQ_S + "\n        // dS = P∘(dP − Δ)"
_DKV_AFTER = _DKV_S + "\n        // Pᵀ and dSᵀ"
# each item's last tile dropped once its S and dP are in: the stage is
# released and its dV/dK or dQ products never issued
_DROP = ("        if (t == n_tiles - 1) {\n          __syncwarp();\n"
         "          if (lane == 0) mbar_arrive(&bars.empty[s]);\n          continue;\n        }\n")
_EX2 = '  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));'
_DQ_PRODUCER = "          mbar_arrive_expect_tx(&bars.full[s], 2 * T::kTileBytes);\n"
_DKV_PRODUCER = "          mbar_arrive_expect_tx(&bars.full[s], T::kStageBytes);\n"
_NO_REFILL = "          if (seq >= ST) { mbar_arrive(&bars.full[s]); continue; }\n"
_DKV_LAUNCH = "  if (!bf16_rows_map(&tq, q, B * Sq, H, D, KV::kBQ) ||"
# the consumer WGs out of phase, as in attention_narrow.cu: WG c issues its
# first products once the other WG's have completed (named barrier 1 + c,
# which the other arrives on; WG 0 first, WG 1 hands on no turn after its
# last tile, so the barriers' generations balance)
_HANDOVER = "        if (c == 0 || !last_item || t + 1 < n_tiles) named_arrive(2 - c, 256);\n"
_PINGPONG = [_rep("    int seq = 0, it = 0;\n    for (int w = blockIdx.x;",
                  "    if (c == 1) named_arrive(1, 256);\n    int seq = 0, it = 0;\n"
                  "    for (int w = blockIdx.x;", 2),
             _rep("H);\n      const int rb = it % RB;\n", "H);\n      const int rb = it % RB;\n"
                  "      const bool last_item = w + static_cast<int>(gridDim.x) >= n_items;\n", 2),
             _rep("        mbar_wait(&bars.full[s], (seq / ST) & 1);\n",
                  "        mbar_wait(&bars.full[s], (seq / ST) & 1);\n"
                  "        named_sync(1 + c, 256);\n", 2),
             _rep(_DQ_S, _DQ_S + _HANDOVER), _rep(_DKV_S, _DKV_S + _HANDOVER)]
_NO_OVER_D = [_rep("        product_over_d<", "        if (t == 0) product_over_d<", 4)]
_NO_OVER_ROWS = [_rep("        product_over_rows<", "        if (t < 0) product_over_rows<", 3)]
_NO_DS = [_rep("pack_bf16x2(p0 * (dp[4 * j] - d0), p1 * (dp[4 * j + 1] - d0))",
               "pack_bf16x2(p0 + dp[4 * j], p1 + dp[4 * j + 1])"),
          _rep("pack_bf16x2(p2 * (dp[4 * j + 2] - d1), p3 * (dp[4 * j + 3] - d1))",
               "pack_bf16x2(p2 + dp[4 * j + 2], p3 + dp[4 * j + 3])"),
          _rep("pack_bf16x2(p0 * (dpt[4 * j] - d.x), p1 * (dpt[4 * j + 1] - d.y))",
               "pack_bf16x2(p0 + dpt[4 * j], p1 + dpt[4 * j + 1])"),
          _rep("pack_bf16x2(p2 * (dpt[4 * j + 2] - d.x), p3 * (dpt[4 * j + 3] - d.y))",
               "pack_bf16x2(p2 + dpt[4 * j + 2], p3 + dpt[4 * j + 3])")]


def _maps_2d(s: str) -> str:
    """2-D (rows, H·D) tensor maps: a box's columns past D come from head h + 1."""
    s, n = re.subn(r"bf16_rows_map\((&\w+), (\w+), (B \* S[qk]), H, D, ",
                   r"bf16_rows_map(\1, \2, \3, 1, H * D, ", s)
    s, m = re.subn(r", c \* 64, m\.h,", ", m.h * D + c * 64, 0,", s)
    if (n, m) != (8, 8):
        raise SystemExit(f"variant edit does not apply: {n} maps, {m} loads")
    return s


# name → (what it tests, edits of the kernel source)
VARIANTS = {
    "pingpong": ("step (c): the two consumer WGs of each pass out of phase", _PINGPONG),
    "dq_bk64": ("the dQ pass with 64-key tiles at every Dp",
                [_rep("static constexpr int kBK = DP <= 80 ? 128 : 64;",
                      "static constexpr int kBK = 64;")]),
    "dkv_bq32": ("the dK/dV pass with 32-query tiles at every Dp",
                 [_rep("static constexpr int kBQ = DP <= 96 ? 64 : 32;",
                       "static constexpr int kBQ = 32;")]),
    "one_resident_buffer": ("the resident tiles in one buffer at every Dp (deeper rings)",
                            [_rep("  return ring_depth(2 * resident, stage) >= 3 ? 2 : 1;",
                                  "  return 1;")]),
    "not_persistent": ("a block for each work item (the grid of items), not one an SM",
                       [_rep("std::min(dq_items, sm_count())", "dq_items"),
                        _rep("std::min(dkv_items, sm_count())", "dkv_items")]),
    "stages2": ("both rings 2 stages deep",
                [_rep("  return (kSmemMax - 1024 - 128 - fixed) / stage >= 4\n             ? 4",
                      "  return (kSmemMax - 1024 - 128 - fixed) / stage >= 2\n             ? 2")]),
    # diagnostics: each removes one piece of work; the gradients are wrong on purpose
    "d_no_launch": ("diagnostic: the wrapper alone (no tensor map encoded, no launch)",
                    [_rep("  const float sl2 = scale * kLog2e;\n", "  if (true) return "
                          "cudaSuccess;\n  const float sl2 = scale * kLog2e;\n")]),
    "d_dq_only": ("diagnostic: the dQ pass alone (the dK/dV pass not launched)",
                  [_rep(_DKV_LAUNCH, "  if (true) return cudaGetLastError();\n" + _DKV_LAUNCH)]),
    "d_dkv_only": ("diagnostic: the dK/dV pass alone (the dQ pass, and so Δ, not launched)",
                   [_rep("  dq_kernel<DP><<<", "  if (false) dq_kernel<DP><<<")]),
    "d_no_delta": ("diagnostic: the dQ pass's prologue takes no Δ (read as 0)",
                   [_rep("      for (int c8 = tig; c8 < D / 8; c8 += 4) {",
                         "      for (int c8 = tig; c8 < 0; c8 += 4) {")]),
    "d_no_exp": ("diagnostic: ex2 replaced by the identity", [_rep(_EX2, "  y = x;")]),
    "d_no_ds": ("diagnostic: dS = P + dP, no Δ subtraction or product", _NO_DS),
    "d_no_refill": ("diagnostic: both rings loaded once, never refilled",
                    [_rep(_DQ_PRODUCER, _NO_REFILL + _DQ_PRODUCER),
                     _rep(_DKV_PRODUCER, _NO_REFILL + _DKV_PRODUCER)]),
    "d_no_over_d": ("diagnostic: S and dP (Sᵀ and dPᵀ) on the first tile only", _NO_OVER_D),
    "d_no_over_rows": ("diagnostic: no dQ, dV or dK products", _NO_OVER_ROWS),
    "d_no_products": ("diagnostic: neither kind of product", _NO_OVER_D + _NO_OVER_ROWS),
    "d_skeleton": ("diagnostic: no products, no exp2, no dS: the rings, barriers and packing",
                   _NO_OVER_D + _NO_OVER_ROWS + _NO_DS + [_rep(_EX2, "  y = x;")]),
    "d_skeleton_no_refill": ("diagnostic: d_skeleton without the refills either",
                             _NO_OVER_D + _NO_OVER_ROWS + _NO_DS
                             + [_rep(_EX2, "  y = x;"),
                                _rep(_DQ_PRODUCER, _NO_REFILL + _DQ_PRODUCER),
                                _rep(_DKV_PRODUCER, _NO_REFILL + _DKV_PRODUCER)]),
    # planted faults
    "fault_dkv_drop_last_tile": ("fault: the dK/dV pass drops its last query tile",
                                 [_rep(_DKV_AFTER, _DKV_S + _DROP + "\n        // Pᵀ and dSᵀ")]),
    "fault_dq_drop_last_tile": ("fault: the dQ pass drops its last key tile",
                                [_rep(_DQ_AFTER, _DQ_S + _DROP + "\n        // dS = P∘(dP − Δ)")]),
    "fault_lse_offset": ("fault: lse + 0.02 (log2 units) in both passes",
                         [_rep("const float l0 = lse[vr], l1 = lse[vr + 8]",
                               "const float l0 = lse[vr] + 0.02f, l1 = lse[vr + 8] + 0.02f"),
                          _rep("          const float2 l = *reinterpret_cast<const float2*>"
                               "(lv + 8 * j + 2 * tig);\n",
                               "          float2 l = *reinterpret_cast<const float2*>(lv + 8 * j "
                               "+ 2 * tig);\n          l.x += 0.02f;\n          l.y += 0.02f;\n")]),
    "fault_neighbour_pad": ("fault: 2-D (rows, H·D) maps, box columns past D from head h + 1",
                            [_maps_2d]),
}


def ptxas(text: str) -> str:
    """Registers and spill bytes of dq<48|80> and dkv<48|80> from a build.log."""
    found, name, spill = [], None, "?"
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '\w*?(dq|dkv)_kernelILi(\d+)E", line)
        if m:
            name, spill = f"{m.group(1)}<{m.group(2)}>", "?"
            continue
        if name is None or not name.endswith(("<48>", "<80>")):
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found.append(f"{name} {m.group(1)} regs, {spill} B spilled")
            name = None
    return "; ".join(found)


def build(root: Path) -> str:
    ok, text = compile_tree(root)
    if not ok:
        return text
    warnings = [l for l in text.splitlines() if "attention_bwd" in l and "warning" in l.lower()]
    return ptxas(text) + f"; {len(warnings)} warnings in attention_bwd.cu" + "".join(
        f"\n  {w.strip()[:300]}" for w in warnings[:4])


_TIME_ONE = '''
import json, statistics, torch
from psd_tpu_torch.ops import attention
shapes = {shapes!r}
g = torch.Generator(device="cuda").manual_seed(2)
res = []
for shape in shapes:
    q, k, v, dout = (torch.randn(shape, generator=g, device="cuda").bfloat16() for _ in range(4))
    out, lse = attention.attention_fwd(q, k, v, return_lse=True)
    got = attention.attention_bwd(q, k, v, out, lse, dout)
    want = attention.attention_bwd_reference(q, k, v, dout)
    row = {{"shape": list(shape)}}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        d = a.float() - b.float()
        row[name] = [(d.norm() / b.float().norm()).item(),
                     (d.norm(dim=-1) / b.float().norm(dim=-1).clamp_min(1e-30)).max().item(),
                     bool(torch.isfinite(a).all())]
    del got, want
    for _ in range(3):
        attention.attention_bwd(q, k, v, out, lse, dout)
    ts = []
    for _ in range(20):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(); attention.attention_bwd(q, k, v, out, lse, dout); b.record()
        b.synchronize(); ts.append(a.elapsed_time(b))
    row["ms"] = statistics.median(ts)
    res.append(row)
    del q, k, v, dout, out, lse
    torch.cuda.empty_cache()
print(json.dumps(res))
'''


def time_tree(root: Path):
    """The timing rows of one tree, or the tail of its error output."""
    try:
        res = _in(root, _TIME_ONE.format(shapes=SHAPES), 300)
    except subprocess.TimeoutExpired:
        return "timed out after 300 s"
    if res.returncode != 0:
        return (res.stdout + res.stderr)[-1500:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", help=f"variants to time (default: all of {list(VARIANTS)})")
    ap.add_argument("--tree", action="append", default=[],
                    help="another checkout whose attention backward is timed too (repeatable)")
    ap.add_argument("--trees-only", action="store_true",
                    help="time as_built and the --tree checkouts, no variant")
    ap.add_argument("--rounds", type=int, default=1,
                    help="time every tree this many times, alternating the order")
    args = ap.parse_args()
    import torch

    sys.path.insert(0, str(ROOT))
    from psd_tpu_torch.testing import ATTN_BWD_REL_L2_BAND, ATTN_BWD_ROW_BAND

    if not torch.cuda.is_available():
        raise SystemExit("torch_attention_bwd_variants.py: needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    names = [] if args.trees_only else (args.names or list(VARIANTS))
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}")
    trees = {"as_built": ROOT, **{n: make_tree(n, VARIANTS, SRC, OUT) for n in names},
             **{f"tree:{t}": Path(t).resolve() for t in args.tree}}
    with ThreadPoolExecutor(max_workers=4) as pool:
        regs = dict(zip(trees, pool.map(build, trees.values())))
    failed = 0
    order = []
    for r in range(args.rounds):
        middle = [n for n in trees if n != "as_built"]
        order += ["as_built"] + (middle if r % 2 == 0 else middle[::-1]) + ["as_built"]
    for name in order:
        rows = time_tree(trees[name])
        what = VARIANTS[name][0] if name in VARIANTS else ""
        if isinstance(rows, str):
            failed += 1
            print(f"[bwd variant] {name:24s} FAILED | {what}\n{rows}", flush=True)
            continue

        def judged(r):
            parts, ok = [], True
            for g in ("dq", "dk", "dv"):
                rel, row, finite = r[g]
                ok = ok and finite and rel <= ATTN_BWD_REL_L2_BAND and row <= ATTN_BWD_ROW_BAND
                parts.append(f"{g} {rel:.3e}/{row:.3e}")
            return (f"{tuple(r['shape'])} {r['ms']:.4f} ms ({', '.join(parts)} "
                    f"{'pass' if ok else 'FAIL'})")

        print(f"[bwd variant] {name:24s} " + " | ".join(judged(r) for r in rows)
              + f" | {regs[name]} | {what}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
