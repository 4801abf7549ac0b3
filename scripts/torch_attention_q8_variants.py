#!/usr/bin/env python3
"""Variants of the int8 attention kernel (`psd_tpu_torch/csrc/
attention_q8.cu`) on one NVIDIA GPU (H100): its design choices, where its
time goes, and whether `attention_q8_judge` and the tie probe see planted
faults.

    python3 scripts/torch_attention_q8_variants.py                    # every variant
    python3 scripts/torch_attention_q8_variants.py d_no_exp fault_half_away
    python3 scripts/torch_attention_q8_variants.py --tree PARENT       # also another checkout
    python3 scripts/torch_attention_q8_variants.py --trees-only --rounds 3 --tree A

Each variant is a set of edits of the kernel's source (VARIANTS below):
another design choice (blocks an SM, ring depth, each per-logit rewrite
undone), a
diagnostic that drops one piece of work ("d_*", wrong outputs on purpose)
or a planted fault ("fault_*", as chip_smoke.py's bands were set against).
Each is built in a copy of `psd_tpu_torch/` under
`build/psd_tpu_torch/q8_variants/<name>/` (git-ignored), four builds at
once, with the helpers of scripts/torch_attention_variants.py. Then each
variant, the checkout as it is ("as_built", first and last, to show the
drift within the call) and each `--tree` run one after another, each in its
own process (with `--rounds N`, N rounds, every other one in reverse
order), at chip_smoke.py's Q8_SHAPES in both modes, seeded N(0,1) bf16
inputs quantized by the tree's own pre-pass: timed on the device (10 calls
captured in one CUDA graph, replayed; CUDA events, median of 10 replays),
eagerly (one call between CUDA events, median of 20, the wrapper's host
time included) and on the host clock (the wrapper alone, after a
synchronize, median of 20), and held to attention_q8_reference by relative
L2 over the output and on its worst query row against
`attention_q8_judge`'s bands; then chip_smoke.py's tie probe (int8 mode;
trees whose pre-pass places no keys skip it). `d_div_check` counts, on the
card, the logits whose Markstein quotient differs from IEEE division
(__fdiv_rn) at every Q8_SHAPES entry and the tie probe. Prints ptxas's
registers, stack and spills of the q8 kernels, and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
from torch_attention_variants import _in, _rep, compile_tree  # noqa: E402

SRC = "psd_tpu_torch/csrc/attention_q8.cu"
OUT = ROOT / "build" / "psd_tpu_torch" / "q8_variants"
SHAPES = [(8, 4096, 8, 40), (8, 1024, 8, 80), (8, 256, 8, 160)]

_EX2 = '  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));'
_CVT = "  return __fmul_rn(__fmul_rn(static_cast<float>(acc), rq), s);"
_DIV = "  return __fmaf_rn(__fmaf_rn(-q0, d, x), r, q0);"
_QUANT = "  return __float_as_uint(__fadd_rn(div_rn(div_rn(p, l, rl), ps, rps), kMagic));"
_RS8 = "            wgmma_rs_s8<DP>(o, pa[ch], wgmma_desc(vst + (2 * hh + ch) * 32, 16, 1024), 1);"
_RSTB = "            wgmma_rs_tb<DP>(o, pa[kk],"
_BLOCKS = "static constexpr int kBlocksPerSM = DP <= 64 ? 2 : 1;"
_S8 = "        wgmma_ss_s8<64>(acc, wgmma_desc(qs"
# the per-logit work and P·V skipped: each half ends after its product
# and dequant (S > 0 is true at run time and unknown to the compiler, which
# so keeps the code it guards)
_NO_WORK = [_rep("        dequant_s(s, hh, acc[hh], x);\n",
                 "        dequant_s(s, hh, acc[hh], x);\n        if (S > 0) continue;\n"),
            _rep("        dequant_s(s, hh, acc, x);\n",
                 "        dequant_s(s, hh, acc, x);\n        if (S > 0) continue;\n")]
_RSTB_FULL = ("            wgmma_rs_tb<DP>(o, pa[kk],\n"
              "                            wgmma_desc(vst + (hh * 64 + kk * 16) * 128, kQ8BK * 128, 1024), 1);")
_PA_USED = 'asm volatile("" ::"r"(pa[{i}][0]), "r"(pa[{i}][1]), "r"(pa[{i}][2]), "r"(pa[{i}][3]));'

_STAGES = ("static constexpr int kStages = kFixed + 4 * kPerStage <= kLimit   ? 4\n"
           "                                 : kFixed + 3 * kPerStage <= kLimit ? 3\n"
           "                                                                    : 2;")
_SK = "bulk_load(sks + s * kQ8BK, sk + static_cast<size_t>(bh) * S + k0,"
_PACK0 = "            pa[ch][0] = low_bytes(w[0][0], w[0][1], w[1][0], w[1][1]);\n"
# d_div_check: count the logits whose Markstein quotient is not __fdiv_rn's
_DIV_CHECK = '''__device__ unsigned long long g_q8_div_mismatch;
__device__ __forceinline__ float div_rn(float x, float d, float r) {
  const float q0 = __fmul_rn(x, r);
  const float q = __fmaf_rn(__fmaf_rn(-q0, d, x), r, q0);
  if (__float_as_uint(q) != __float_as_uint(__fdiv_rn(x, d))) atomicAdd(&g_q8_div_mismatch, 1ull);
  return q;
}
'''
_DIV_DUMP = '''
extern "C" int psd_q8_div_mismatches(void* dst) {
  const int e = static_cast<int>(cudaMemcpyFromSymbol(dst, psd::g_q8_div_mismatch, 8));
  const unsigned long long zero = 0;
  return e ? e : static_cast<int>(cudaMemcpyToSymbol(psd::g_q8_div_mismatch, &zero, 8));
}
'''


def _div_check(s: str) -> str:
    i = s.index("__device__ __forceinline__ float div_rn(")
    j = s.index("}\n", i) + 2
    s = s[:i] + _DIV_CHECK + s[j:]
    s = s.replace("namespace psd {\nnamespace {", "namespace psd {\n__device__ unsigned long long "
                  "g_q8_div_mismatch;\nnamespace {", 1)
    s = s.replace("__device__ unsigned long long g_q8_div_mismatch;\n__device__ __forceinline__",
                  "__device__ __forceinline__", 1)
    return s + _DIV_DUMP


# name → (what it tests, edits of the kernel source)
VARIANTS = {
    # design choices
    "one_block": ("one block an SM at every Dp (two of 112 registers as built at Dp <= 64)",
                  [_rep(_BLOCKS, "static constexpr int kBlocksPerSM = 1;")]),
    "stages2": ("rings of 2 stages (as many as fit, up to 4, as built)",
                [_rep(_STAGES, "static constexpr int kStages = 2;")]),
    "exp2f": ("exp2 as exp2f, torch.exp2's own (subnormal results scaled around the "
              "MUFU.EX2; ex2.approx.ftz alone as built)",
              [_rep(_EX2, "  y = exp2f(x);")]),
    "add_cvt": ("int32 → fp32 as __int_as_float(acc + 0x4B400000) − 1.5·2²³ (two full-rate "
                "instructions) in place of I2F",
                [_rep(_CVT, "  return __fmul_rn(__fmul_rn(__int_as_float(acc + 0x4B400000) - "
                            "kMagic, rq), s);")]),
    "ieee_div": ("the two divisions by IEEE `/` in place of Markstein's correction",
                 [_rep(_DIV, "  return x / d;")]),
    "f2i_round": ("rint by __float2int_rn (F2I, quarter rate) in place of the add trick",
                  [_rep(_QUANT, "  return static_cast<uint32_t>(__float2int_rn(div_rn(div_rn(p, l, "
                                "rl), ps, rps)));")]),
    # diagnostics: each removes one piece of work; the outputs are wrong on purpose
    "d_no_exp": ("diagnostic: exp2 replaced by the identity",
                 [_rep(_EX2, "  y = x;")]),
    "d_no_cvt": ("diagnostic: the accumulator reinterpreted as fp32, no conversion",
                 [_rep(_CVT, "  return __fmul_rn(__fmul_rn(__int_as_float(acc), rq), s);")]),
    "d_no_div": ('diagnostic: "int8"\'s two divisions as one multiply each',
                 [_rep(_DIV, "  return __fmul_rn(x, r);")]),
    "d_no_pv": ("diagnostic: no P·V products (p still formed and packed, held live by an empty asm)",
                [_rep(_RS8, "            " + _PA_USED.format(i="ch")),
                 _rep(_RSTB_FULL, "            " + _PA_USED.format(i="kk"))]),
    "d_skeleton": ("diagnostic: the loads and barriers alone (no products, no per-logit work)",
                   [_rep(_S8, _S8.replace("wgmma_ss_s8", "if (S < 0) wgmma_ss_s8")), *_NO_WORK]),
    "d_products_only": ("diagnostic: the loads and QKᵀ products alone (no per-logit work, no P·V)",
                        _NO_WORK),
    "d_no_k_refill": ("diagnostic: the ring filled once, never refilled (every tile reads stale data)",
                      [_rep("        mbar_arrive_expect_tx(&full[s], T::kKBytes",
                            "        if (t >= ST) { mbar_arrive(&full[s]); continue; }\n"
                            "        mbar_arrive_expect_tx(&full[s], T::kKBytes")]),
    "d_pass1_only": ("diagnostic: the statistics pass alone (no P·V pass, nor its loads)",
                     [_rep("t < 2 * n_tiles; ++t) {  // two passes", "t < (S > 0 ? 1 : 2) * n_tiles; ++t) {  //"),
                      _rep("for (int t = n_tiles; t < 2 * n_tiles; ++t) {",
                           "for (int t = n_tiles; t < (S > 0 ? 1 : 2) * n_tiles; ++t) {")]),
    "d_no_launch": ("diagnostic: the wrapper alone (no tensor map encoded, no launch)",
                    [_rep("  CUtensorMap tq, tk, tv;\n", "  if (true) return cudaSuccess;\n"
                                                       "  CUtensorMap tq, tk, tv;\n")]),
    "d_div_check": ("diagnostic: counts the logits whose Markstein quotient differs from "
                    "__fdiv_rn (output unchanged)", [_div_check]),
    # planted faults
    "fault_p_unscaled": ('fault: "int8" quantizes p/l without the 1/ps scale (pq = rint(p/l))',
                         [_rep(_QUANT, "  return __float_as_uint(__fadd_rn(div_rn(p, l, rl), "
                                       "kMagic));")]),
    "fault_drop_last_chunk": ("fault: the last 32 keys of every 128-key tile left out of P·V",
                              [_rep(_RS8, _RS8.replace("wgmma_rs_s8",
                                                       "if (hh == 0 || ch == 0) wgmma_rs_s8")),
                               _rep(_RSTB, _RSTB.replace("wgmma_rs_tb",
                                                         "if (hh == 0 || kk < 2) wgmma_rs_tb"))]),
    "fault_neighbour_sk": ("fault: the key scales of the next b·h",
                           [_rep(_SK, "bulk_load(sks + s * kQ8BK, sk + static_cast<size_t>((bh + 1) "
                                      "% gridDim.y) * S + k0,")]),
    "fault_fragment_lane": ('fault: "int8"\'s A fragment takes the next lane\'s pq (the keys of '
                            "lane tig + 1 of its quad)",
                            [_rep(_PACK0, "#pragma unroll\n            for (int jj = 0; jj < 4; ++jj)\n"
                                          "#pragma unroll\n              for (int e = 0; e < 4; ++e)\n"
                                          "                w[jj][e] = __shfl_sync(0xffffffffu, w[jj][e], "
                                          "(lane & ~3) | ((lane + 1) & 3));\n" + _PACK0)]),
    "fault_half_away": ('fault: "int8" rounds pn/ps half away from zero',
                        [_rep(_QUANT, "  return __float_as_uint(__fadd_rz(__fadd_rn(div_rn(div_rn(p, "
                                      "l, rl), ps, rps), 0.5f), kMagic));")]),
}


def make_tree(name: str) -> Path:
    """A copy of psd_tpu_torch/ under OUT with the edits of VARIANTS[name]."""
    root = OUT / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(ROOT / "psd_tpu_torch", root / "psd_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = root / SRC
    text = path.read_text()
    for edit in VARIANTS[name][1]:
        text = edit(text)
    path.write_text(text)
    return root


def ptxas(text: str) -> str:
    """Registers, stack and spills of the q8 kernels at Dp 64, 96, 160."""
    found, name, extra = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '\w*?q8_kernelILi(\d+)ELb([01])E", line)
        if m:
            name = f"<{m.group(1)}, {'int8' if m.group(2) == '1' else 'qk8'}>"
            name = name if m.group(1) in ("64", "96", "160") else None
            extra = ""
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m:
            extra = f", stack {m.group(1)}, {m.group(2)} B spilled"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found.append(f"{name} {m.group(1)} regs{extra}")
            name = None
    return "q8_kernel " + "; ".join(found)


def build(root: Path) -> str:
    ok, text = compile_tree(root)
    return ptxas(text) if ok else text


_TIME_ONE = '''
import ctypes, json, statistics, sys, time, torch
sys.path.insert(1, {root!r})
from psd_tpu_torch.ops import attention, kernels
shapes = {shapes!r}
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(0)

def events(fn, n):
    ts = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(); fn(); b.record()
        b.synchronize(); ts.append(a.elapsed_time(b))
    return statistics.median(ts)

def host(fn):
    ts = []
    for _ in range(23):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(ts[3:])

def timed(fn):
    """(eager ms, device ms of one call in a replayed CUDA graph of 10, host ms)"""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    eager = events(fn, 20)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(10):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return [eager, events(graph.replay, 10) / 10, host(fn)]

lib = kernels.library()
div_check = hasattr(lib, "psd_q8_div_mismatches")
if div_check:
    lib.psd_q8_div_mismatches.argtypes = [ctypes.c_void_p]
    cnt = ctypes.c_ulonglong(0)
    assert lib.psd_q8_div_mismatches(ctypes.addressof(cnt)) == 0

def mismatches():
    torch.cuda.synchronize()
    assert lib.psd_q8_div_mismatches(ctypes.addressof(cnt)) == 0
    return int(cnt.value)

res = []
for shape in shapes:
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    for mode in ("qk8", "int8"):
        ops = attention.quantize_qkv(q, k, v, mode == "int8")
        fn = lambda: attention.attention_q8(*ops, shape[-1] ** -0.5, shape)
        out = fn().float()
        extra = {{"div_mismatches": mismatches()}} if div_check else {{}}
        ref = attention.attention_q8_reference(*ops, shape[-1] ** -0.5, shape,
                                               torch.bfloat16).float()
        d = out - ref
        rel = (d.norm() / ref.norm()).item()
        row = (d.norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)).max().item()
        res.append({{"shape": list(shape), "mode": mode,
                     "judge": [rel, row, bool(torch.isfinite(out).all())],
                     "ms": timed(fn), **extra}})
        del ops, out, ref
    del q, k, v
    torch.cuda.empty_cache()
probe = None
if hasattr(attention, "q8_key_position"):
    import chip_smoke
    ops, shape, scale, n_ties = chip_smoke.q8_tie_probe(dev)
    out = attention.attention_q8(*ops, scale, shape).float()
    probe_mis = mismatches() if div_check else None
    ref = attention.attention_q8_reference(*ops, scale, shape, torch.bfloat16).float()
    bad = (out - ref).abs() > 2.0 ** -7 * ref.abs()
    probe = {{"ties": n_ties, "rows_off": int(bad.any(dim=-1).sum()),
              "finite": bool(torch.isfinite(out).all()), "div_mismatches": probe_mis}}
print(json.dumps({{"rows": res, "probe": probe}}))
'''


def time_tree(root: Path):
    """The timing rows of one tree, or the tail of its error output."""
    try:
        res = _in(root, _TIME_ONE.format(shapes=SHAPES, root=str(ROOT)), 600)
    except subprocess.TimeoutExpired:
        return "timed out after 600 s"
    if res.returncode != 0:
        return (res.stdout + res.stderr)[-1500:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", help=f"variants to time (default: all of {list(VARIANTS)})")
    ap.add_argument("--tree", action="append", default=[],
                    help="another checkout whose q8 kernel is timed too (repeatable)")
    ap.add_argument("--trees-only", action="store_true",
                    help="time as_built and the --tree checkouts, no variant")
    ap.add_argument("--rounds", type=int, default=1,
                    help="time every tree this many times, alternating the order")
    args = ap.parse_args()
    import torch

    sys.path.insert(0, str(ROOT))
    from psd_tpu_torch.testing import Q8_REL_L2_BAND, Q8_ROW_BAND

    if not torch.cuda.is_available():
        raise SystemExit("torch_attention_q8_variants.py: needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    names = [] if args.trees_only else (args.names or list(VARIANTS))
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}")
    trees = {"as_built": ROOT, **{n: make_tree(n) for n in names},
             **{f"tree:{t}": Path(t).resolve() for t in args.tree}}
    with ThreadPoolExecutor(max_workers=4) as pool:
        regs = dict(zip(trees, pool.map(build, trees.values())))
    failed = 0
    order = []
    for r in range(args.rounds):
        middle = [n for n in trees if n != "as_built"]
        order += ["as_built"] + (middle if r % 2 == 0 else middle[::-1]) + ["as_built"]
    for name in order:
        got = time_tree(trees[name])
        what = VARIANTS[name][0] if name in VARIANTS else ""
        if isinstance(got, str):
            failed += 1
            print(f"[q8 variant] {name:22s} FAILED | {what}\n{got}", flush=True)
            continue

        def judged(r):
            rel, row, finite = r["judge"]
            ok = finite and rel <= Q8_REL_L2_BAND and row <= Q8_ROW_BAND
            eager, device, host = r["ms"]
            div = f", {r['div_mismatches']} div mismatches" if "div_mismatches" in r else ""
            return (f"{tuple(r['shape'])} {r['mode']} {device:.4f} ms device, {eager:.4f} eager, "
                    f"{host:.4f} host ({rel:.3e}/{row:.3e} {'pass' if ok else 'FAIL'}{div})")

        p = got["probe"]
        probe = ("tie probe skipped" if p is None else
                 f"tie probe {p['ties']} ties, {p['rows_off']} rows off "
                 f"{'pass' if p['finite'] and p['rows_off'] == 0 else 'FAIL'}"
                 + ("" if p["div_mismatches"] is None else
                    f", {p['div_mismatches']} div mismatches"))
        print(f"[q8 variant] {name:22s} " + " | ".join(judged(r) for r in got["rows"])
              + f" | {probe} | {regs[name]} | {what}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
