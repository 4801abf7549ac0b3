#!/usr/bin/env python3
"""Variants of the narrow attention forward (`psd_tpu_torch/csrc/
attention_narrow.cu`) on one NVIDIA GPU (H100): where its time goes, and
whether `attention_judge` sees planted faults.

    python3 scripts/torch_attention_variants.py                 # every variant
    python3 scripts/torch_attention_variants.py one_block d_no_pv  # some
    python3 scripts/torch_attention_variants.py --tree PARENT    # also another checkout

Each variant is one edit of the kernel source (VARIANTS below): another
design choice, a diagnostic that drops one piece of work ("d_*", wrong
output on purpose) or a planted fault ("fault_*", as chip_smoke.py's bands
were set against). Each is built in a copy of `psd_tpu_torch/` under
`build/psd_tpu_torch/variants/<name>/` (git-ignored), four builds at once.
Then each variant, the checkout as it is ("as_built", first and last, to
show the drift within the call) and each `--tree` run one after another,
each in its own process, at (8,4096,8,40), (8,1024,8,80) and, with the
log-sum-exp, (64,1024,8,40), seeded N(0,1) bf16 inputs: the forward's time
(CUDA events, median of 20 after 3 warm-up calls); its relative L2 error
against attention_reference over the output and on the worst query row,
held to `attention_judge`'s bands, and the max abs error of the
log-sum-exp against lse_reference. Prints ptxas's registers and spills for
narrow<48> and narrow<80>, and the card's name and power limit.
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
SRC = "psd_tpu_torch/csrc/attention_narrow.cu"
OUT = ROOT / "build" / "psd_tpu_torch" / "variants"
SHAPES = [((8, 4096, 8, 40), False), ((8, 1024, 8, 80), False), ((64, 1024, 8, 40), True)]


def _rep(old: str, new: str, count: int = 1):
    def edit(s: str) -> str:
        if s.count(old) != count:
            raise SystemExit(f"variant edit does not apply: {old[:70]!r}")
        return s.replace(old, new)
    return edit


_CONSUMER_LOOP_START = "    if (c == 1) named_arrive(1, 256);\n    mbar_wait(qbar, 0);\n"
_CONSUMER_LOOP_END = "      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s\n    }\n"
# FlashAttention-3's intra-warpgroup overlap: S of tile t and P·V of tile t-1
# issued together, the softmax of tile t under the P·V of tile t-1
_OVERLAP_LOOP = '''    if (c == 1) named_arrive(1, 256);
    mbar_wait(qbar, 0);
    const uint32_t kv0 = smem_addr(smem) + T::kOffKV;
    float sc[BK / 2];
    uint32_t pa[BK / 16][4];
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % ST;
      mbar_wait(&full[s], (t / ST) & 1);
      named_sync(1 + c, 256);
      const uint32_t kst = kv0 + s * 2 * T::kTileBytes;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
        const uint32_t box = ks >> 2, in_box = (ks & 3) * 32;
        wgmma_ss<BK>(sc, wgmma_desc(qs + box * (kBQ * 128) + in_box, 16, 1024),
                     wgmma_desc(kst + box * (BK * 128) + in_box, 16, 1024), ks > 0);
      }
      wgmma_commit();
      if (t > 0) {
        const uint32_t vprev = kv0 + ((t - 1) % ST) * 2 * T::kTileBytes + T::kTileBytes;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs_tb<DP>(o, pa[kk], wgmma_desc(vprev + kk * 16 * 128, BK * 128, 1024), 1);
        wgmma_commit();
      }
      if (c == 0 || t + 1 < n_tiles) named_arrive(2 - c, 256);
      if (t > 0) wgmma_wait<1>(); else wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) reg_fence(sc[i]);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int o_ = 1; o_ <= 2; o_ <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
      }
      const float mn0 = fmaxf(m0, mx0 * scale_log2), mn1 = fmaxf(m1, mx1 * scale_log2);
      const float c0 = ex2(m0 - mn0), c1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        sc[4 * j] = ex2(sc[4 * j] * scale_log2 - mn0);
        sc[4 * j + 1] = ex2(sc[4 * j + 1] * scale_log2 - mn0);
        sc[4 * j + 2] = ex2(sc[4 * j + 2] * scale_log2 - mn1);
        sc[4 * j + 3] = ex2(sc[4 * j + 3] * scale_log2 - mn1);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) reg_fence(o[i]);
      if (t > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(t - 1) % ST]);
      }
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        pa[j / 2][(j % 2) * 2] = pack_bf16x2_sum(sc[4 * j], sc[4 * j + 1], ls0);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16x2_sum(sc[4 * j + 2], sc[4 * j + 3], ls1);
      }
      l0 = l0 * c0 + ls0;
      l1 = l1 * c1 + ls1;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        o[4 * n] *= c0;
        o[4 * n + 1] *= c0;
        o[4 * n + 2] *= c1;
        o[4 * n + 3] *= c1;
      }
    }
    {
      const int sl = (n_tiles - 1) % ST;
      const uint32_t vl = kv0 + sl * 2 * T::kTileBytes + T::kTileBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs_tb<DP>(o, pa[kk], wgmma_desc(vl + kk * 16 * 128, BK * 128, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) reg_fence(o[i]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[sl]);
    }
'''


def _overlap(s: str) -> str:
    i = s.index(_CONSUMER_LOOP_START)
    j = s.index(_CONSUMER_LOOP_END) + len(_CONSUMER_LOOP_END)
    return s[:i] + _OVERLAP_LOOP + s[j:]


_INT_ROUND = '''
__device__ __forceinline__ uint32_t pack_rn_sum(float lo, float hi, float& sum) {
  uint32_t a = __float_as_uint(lo), b = __float_as_uint(hi);
  a += 0x7fffu + ((a >> 16) & 1u);
  b += 0x7fffu + ((b >> 16) & 1u);
  sum += __uint_as_float(a & 0xffff0000u) + __uint_as_float(b & 0xffff0000u);
  return __byte_perm(a, b, 0x7632);
}
constexpr int kBQ = 128;'''

# d_clock: SM clock stamps of one consumer thread (WG 0) and the producer
# thread, per key tile, in two blocks of the grid (the first, and one from
# the middle), read back through psd_narrow_clocks
_CLOCK_DECL = '''
__device__ unsigned long long g_narrow_clk[2][64][8];
#define NARROW_STAMP(i, who)                                                        \\
  if (rec >= 0 && threadIdx.x == (who) && t < 64) g_narrow_clk[rec][t][i] = clock64();
constexpr int kBQ = 128;'''
_CLOCK_DUMP = '''
extern "C" int psd_narrow_clocks(void* dst) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, psd::g_narrow_clk, sizeof(psd::g_narrow_clk)));
}
'''


def _clock(s: str) -> str:
    s = s.replace("namespace psd {\nnamespace {", "namespace psd {\n__device__ unsigned long long "
                  "g_narrow_clk[2][64][8];\nnamespace {", 1)
    edits = [
        ("constexpr int kBQ = 128;", _CLOCK_DECL.replace(
            "__device__ unsigned long long g_narrow_clk[2][64][8];\n", "")),
        ("  const int wg = threadIdx.x / 128;", "  const int rec = (blockIdx.x == 0 && blockIdx.y == 0) ? 0 "
         ": (blockIdx.x == 16 && blockIdx.y == 33) ? 1 : -1;\n  const int wg = threadIdx.x / 128;"),
        ("        if (t >= ST) mbar_wait(&empty[s], ((t / ST) - 1) & 1);\n",
         "        NARROW_STAMP(6, 256)\n        if (t >= ST) mbar_wait(&empty[s], ((t / ST) - 1) & 1);\n"),
        ("        mbar_arrive_expect_tx(&full[s], 2 * T::kTileBytes);\n",
         "        mbar_arrive_expect_tx(&full[s], 2 * T::kTileBytes);\n        NARROW_STAMP(7, 256)\n"),
        ("      mbar_wait(&full[s], (t / ST) & 1);\n      named_sync(1 + c, 256);\n",
         "      NARROW_STAMP(0, 0)\n      mbar_wait(&full[s], (t / ST) & 1);\n      NARROW_STAMP(1, 0)\n"
         "      named_sync(1 + c, 256);\n      NARROW_STAMP(2, 0)\n"),
        ("      for (int i = 0; i < BK / 2; ++i) reg_fence(sc[i]);\n      if (c == 0",
         "      for (int i = 0; i < BK / 2; ++i) reg_fence(sc[i]);\n      NARROW_STAMP(3, 0)\n      if (c == 0"),
        ("      // O += P · V_tile", "      NARROW_STAMP(4, 0)\n      // O += P · V_tile"),
        ("      for (int i = 0; i < DP / 2; ++i) reg_fence(o[i]);\n      __syncwarp();\n"
         "      if (lane == 0) mbar_arrive(&empty[s]);",
         "      for (int i = 0; i < DP / 2; ++i) reg_fence(o[i]);\n      NARROW_STAMP(5, 0)\n"
         "      __syncwarp();\n      if (lane == 0) mbar_arrive(&empty[s]);"),
    ]
    for old, new in edits:
        s = _rep(old, new)(s)
    return s + _CLOCK_DUMP


_BLOCKS = "static constexpr int kBlocksPerSM = DP <= 64 ? 2 : 1;"
_BK = "static constexpr int kBK = kBlocksPerSM == 2 ? 64 : (DP <= 128 ? 128 : 64);"
_STAGES = "static constexpr int kStages = kBlocksPerSM == 2 ? 4 : (DP <= 128 ? 2 : 3);"
_ARRIVE = "      if (c == 0 || t + 1 < n_tiles) named_arrive(2 - c, 256);  // the other WG's turn\n"

# name → (what it tests, edits of the kernel source)
VARIANTS = {
    "one_block": ("one block an SM at every Dp (128-key tiles, setmaxnreg)",
                  [_rep(_BLOCKS, "static constexpr int kBlocksPerSM = 1;")]),
    "two_blocks_80": ("two blocks an SM also at Dp = 80 (64-key tiles, 2 stages)",
                      [_rep(_BLOCKS, "static constexpr int kBlocksPerSM = DP <= 80 ? 2 : 1;"),
                       _rep(_STAGES, "static constexpr int kStages = kBlocksPerSM == 2 ? "
                                     "(DP <= 64 ? 4 : 2) : (DP <= 128 ? 2 : 3);")]),
    "three_blocks": ("three blocks an SM at Dp <= 64 (32-key tiles, 72 registers)",
                     [_rep(_BLOCKS, "static constexpr int kBlocksPerSM = DP <= 64 ? 3 : 1;"),
                      _rep("kThreads = kBlocksPerSM == 2 ?", "kThreads = kBlocksPerSM >= 2 ?"),
                      _rep(_BK, "static constexpr int kBK = kBlocksPerSM == 3 ? 32 : "
                                "(DP <= 128 ? 128 : 64);"),
                      _rep(_STAGES, "static constexpr int kStages = kBlocksPerSM >= 2 ? 4 : "
                                    "(DP <= 128 ? 2 : 3);")]),
    "stages3": ("3 ring stages at 80 < Dp <= 128 (one block an SM)",
                [_rep(_STAGES, "static constexpr int kStages = kBlocksPerSM == 2 ? 4 : 3;")]),
    "no_pingpong": ("the two consumer WGs not out of phase",
                    [_rep("    if (c == 1) named_arrive(1, 256);\n", ""),
                     _rep("      named_sync(1 + c, 256);\n", ""), _rep(_ARRIVE, "")]),
    "arrive_early": ("the other WG's turn handed on when S is issued, not when it completes",
                     [_rep("      wgmma_commit();\n      wgmma_wait<0>();\n#pragma unroll\n"
                           "      for (int i = 0; i < BK / 2; ++i) reg_fence(sc[i]);\n" + _ARRIVE,
                           "      wgmma_commit();\n" + _ARRIVE + "      wgmma_wait<0>();\n"
                           "#pragma unroll\n      for (int i = 0; i < BK / 2; ++i) "
                           "reg_fence(sc[i]);\n")]),
    "overlap": ("S of tile t issued with P·V of tile t-1, softmax under P·V (FlashAttention-3)",
                [_overlap]),
    "exp2f": ("exp2f (with its denormal scaling) in place of ex2.approx",
              [_rep("ex2(sc[", "exp2f(sc[", 4), _rep("ex2(m0 - mn0), c1 = ex2(m1 - mn1)",
                                                    "exp2f(m0 - mn0), c1 = exp2f(m1 - mn1)")]),
    "int_round": ("p rounded to bf16 by integer ops and packed by byte_perm, no cvt",
                  [_rep("constexpr int kBQ = 128;", _INT_ROUND),
                   _rep("= pack_bf16x2_sum(", "= pack_rn_sum(", 2)]),
    # diagnostics: each removes one piece of work; the output is wrong on purpose
    "d_no_exp": ("diagnostic: ex2 replaced by the identity",
                 [_rep('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "  y = x;")]),
    "d_no_sum": ("diagnostic: p packed without the sum of the rounded values",
                 [_rep("pack_bf16x2_sum(", "pack_bf16x2(", 2), _rep(", ls0);", ");"),
                  _rep(", ls1);", ");")]),
    "d_no_kv_loads": ("diagnostic: K/V loaded into the ring once, never refilled",
                      [_rep("        mbar_arrive_expect_tx(&full[s], 2 * T::kTileBytes);",
                            "        if (t >= ST) { mbar_arrive(&full[s]); continue; }\n"
                            "        mbar_arrive_expect_tx(&full[s], 2 * T::kTileBytes);")]),
    "d_no_pv": ("diagnostic: no P·V products",
                [_rep("        wgmma_rs_tb<DP>(o, pa[kk]", "        if (kk < 0) wgmma_rs_tb<DP>(o, pa[kk]")]),
    "d_no_s": ("diagnostic: S computed on the first tile only",
               [_rep("        wgmma_ss<BK>(sc, wgmma_desc(qs", "        if (t == 0) wgmma_ss<BK>(sc, wgmma_desc(qs")]),
    "d_no_products": ("diagnostic: S on the first tile only and no P·V",
                      [_rep("        wgmma_ss<BK>(sc, wgmma_desc(qs",
                            "        if (t == 0) wgmma_ss<BK>(sc, wgmma_desc(qs"),
                       _rep("        wgmma_rs_tb<DP>(o, pa[kk]", "        if (kk < 0) wgmma_rs_tb<DP>(o, pa[kk]")]),
    "d_skeleton": ("diagnostic: no products, no exp2, no sum: the ring, barriers and max",
                   [_rep("        wgmma_ss<BK>(sc, wgmma_desc(qs",
                         "        if (t == 0) wgmma_ss<BK>(sc, wgmma_desc(qs"),
                    _rep("        wgmma_rs_tb<DP>(o, pa[kk]", "        if (kk < 0) wgmma_rs_tb<DP>(o, pa[kk]"),
                    _rep('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "  y = x;"),
                    _rep("pack_bf16x2_sum(", "pack_bf16x2(", 2), _rep(", ls0);", ");"),
                    _rep(", ls1);", ");")]),
    "d_skeleton_no_loads": ("diagnostic: d_skeleton without the K/V refills either",
                            [_rep("        wgmma_ss<BK>(sc, wgmma_desc(qs",
                                  "        if (t == 0) wgmma_ss<BK>(sc, wgmma_desc(qs"),
                             _rep("        wgmma_rs_tb<DP>(o, pa[kk]",
                                  "        if (kk < 0) wgmma_rs_tb<DP>(o, pa[kk]"),
                             _rep('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "  y = x;"),
                             _rep("pack_bf16x2_sum(", "pack_bf16x2(", 2), _rep(", ls0);", ");"),
                             _rep(", ls1);", ");"),
                             _rep("        mbar_arrive_expect_tx(&full[s], 2 * T::kTileBytes);",
                                  "        if (t >= ST) { mbar_arrive(&full[s]); continue; }\n"
                                  "        mbar_arrive_expect_tx(&full[s], 2 * T::kTileBytes);")]),
    "d_clock": ("diagnostic: clock64 stamps per key tile (median cycles between them)",
                [_clock]),
    # planted faults
    "fault_drop_last_tile": ("fault: the last key tile's S computed, then dropped",
                             [_rep(_ARRIVE, _ARRIVE + "      if (t == n_tiles - 1) {\n"
                                   "        __syncwarp();\n        if (lane == 0) mbar_arrive("
                                   "&empty[s]);\n        continue;\n      }\n")]),
    "fault_skip_rescale": ("fault: WG 1's O not rescaled on the last tile",
                           [_rep("      for (int n = 0; n < DP / 8; ++n) {\n        o[4 * n] *= c0;",
                                 "      for (int n = 0; n < DP / 8; ++n) {\n"
                                 "        if (c == 1 && t == n_tiles - 1) break;\n"
                                 "        o[4 * n] *= c0;")]),
    "fault_neighbour_pad": ("fault: 2-D (rows, H·D) maps, box columns past D from head h + 1",
                            [_rep("bf16_rows_map(&tq, q, B * Sq, H, D, kBQ)",
                                  "bf16_rows_map(&tq, q, B * Sq, 1, H * D, kBQ)"),
                             _rep("bf16_rows_map(&tk, k, B * Sk, H, D, T::kBK)",
                                  "bf16_rows_map(&tk, k, B * Sk, 1, H * D, T::kBK)"),
                             _rep("bf16_rows_map(&tv, v, B * Sk, H, D, T::kBK)",
                                  "bf16_rows_map(&tv, v, B * Sk, 1, H * D, T::kBK)"),
                             _rep("&tq, qbar, c * 64, h, b * Sq + q0)",
                                  "&tq, qbar, h * D + c * 64, 0, b * Sq + q0)"),
                             _rep("&tk, &full[s], c * 64, h, row)", "&tk, &full[s], h * D + c * 64, 0, row)"),
                             _rep("&tv, &full[s], c * 64, h, row)", "&tv, &full[s], h * D + c * 64, 0, row)")]),
}


def make_tree(name: str, variants: dict = VARIANTS, src: str = SRC, out: Path = OUT) -> Path:
    """A copy of psd_tpu_torch/ under `out` with the edits of `variants[name]`
    applied to the source `src`."""
    root = out / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(ROOT / "psd_tpu_torch", root / "psd_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = root / src
    text = path.read_text()
    for edit in variants[name][1]:
        text = edit(text)
    path.write_text(text)
    return root


def _in(root: Path, code: str, timeout: int) -> subprocess.CompletedProcess:
    """Run `code` in a fresh interpreter that imports psd_tpu_torch from root."""
    return subprocess.run([sys.executable, "-c", f"import sys; sys.path.insert(0, {str(root)!r})\n"
                           + code], capture_output=True, text=True, timeout=timeout)


def compile_tree(root: Path):
    """Build the kernels of the tree at `root`: (True, its build.log) or
    (False, the tail of the error)."""
    res = _in(root, "from psd_tpu_torch.ops import kernels; kernels.build()", 600)
    if res.returncode != 0:
        return False, "build failed: " + (res.stdout + res.stderr)[-2000:]
    logs = sorted((root / "build" / "psd_tpu_torch").glob("*/build.log"),
                  key=lambda p: p.stat().st_mtime)
    return True, logs[-1].read_text() if logs else ""


def build(root: Path) -> str:
    ok, text = compile_tree(root)
    if not ok:
        return text
    found, name, spill = [], None, "?"
    for line in text.splitlines():  # ptxas -v: each entry function, then its stats
        m = re.search(r"Compiling entry function '\w*?narrow_attention_kernelILi(\d+)E", line)
        if m:
            name, spill = m.group(1), "?"
            continue
        if name not in ("48", "80"):
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found.append(f"narrow<{name}> {m.group(1)} regs, {spill} B spilled")
            name = None
    warnings = [l.strip() for l in text.splitlines() if "Performance Loss" in l or "warning" in l]
    return "; ".join(found + [f"{len(warnings)} ptxas warnings"])


_TIME_ONE = '''
import json, statistics, torch
from psd_tpu_torch.ops import attention
shapes = {shapes!r}
g = torch.Generator(device="cuda").manual_seed(0)
res = []
for shape, lse in shapes:
    q, k, v = (torch.randn(shape, generator=g, device="cuda").bfloat16() for _ in range(3))
    out, out_lse = attention.attention_fwd(q, k, v, return_lse=True)
    ref = attention.attention_reference(q, k, v).float()
    d = out.float() - ref
    rel = (d.norm() / ref.norm()).item()
    row = (d.norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)).max().item()
    dl = (out_lse - attention.lse_reference(q, k, shape[-1] ** -0.5)).abs().max().item()
    for _ in range(3):
        attention.attention_fwd(q, k, v, return_lse=lse)
    ts = []
    for _ in range(20):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(); attention.attention_fwd(q, k, v, return_lse=lse); b.record()
        b.synchronize(); ts.append(a.elapsed_time(b))
    res.append({{"shape": list(shape), "lse": lse, "ms": statistics.median(ts), "rel_l2": rel,
                "worst_row": row, "lse_abs": dl}})
print(json.dumps(res))
'''


_CLOCK_REPORT = '''
import ctypes, statistics, torch
from psd_tpu_torch.ops import attention, kernels
g = torch.Generator(device="cuda").manual_seed(0)
q, k, v = (torch.randn((8, 4096, 8, 40), generator=g, device="cuda").bfloat16() for _ in range(3))
for _ in range(3):
    attention.attention_fwd(q, k, v)
torch.cuda.synchronize()
buf = (ctypes.c_ulonglong * (2 * 64 * 8))()
lib = kernels.library()
lib.psd_narrow_clocks.argtypes = [ctypes.c_void_p]
assert lib.psd_narrow_clocks(ctypes.addressof(buf)) == 0
c = [[[buf[(r * 64 + t) * 8 + i] for i in range(8)] for t in range(64)] for r in range(2)]
names = ["wait full", "turn (named barrier)", "S issue to done", "softmax", "P.V issue to done",
         "release to next wait"]
for r, block in enumerate(("first block", "block (16, 33)")):
    d = [[c[r][t][i + 1] - c[r][t][i] for t in range(4, 60)] for i in range(5)]
    d.append([c[r][t + 1][0] - c[r][t][5] for t in range(4, 59)])
    tile = [c[r][t + 1][0] - c[r][t][0] for t in range(4, 59)]
    prod = [c[r][t][7] - c[r][t][6] for t in range(8, 60)]
    print(f"[clock] (8,4096,8,40) {block}, consumer WG 0 thread 0, median SM cycles over tiles 4-59: "
          + "; ".join(f"{n} {statistics.median(x):.0f}" for n, x in zip(names, d))
          + f"; whole tile {statistics.median(tile):.0f}; producer wait empty + issue "
          f"{statistics.median(prod):.0f}")
'''
EXTRA_REPORTS = {"d_clock": _CLOCK_REPORT}


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
                    help="another checkout whose attention forward is timed too (repeatable)")
    args = ap.parse_args()
    import torch

    sys.path.insert(0, str(ROOT))
    from psd_tpu_torch.testing import ATTN_LSE_BAND, ATTN_REL_L2_BAND, ATTN_ROW_BAND

    if not torch.cuda.is_available():
        raise SystemExit("torch_attention_variants.py: needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    names = args.names or list(VARIANTS)
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}")
    trees = {"as_built": ROOT, **{n: make_tree(n) for n in names},
             **{f"tree:{t}": Path(t).resolve() for t in args.tree}}
    with ThreadPoolExecutor(max_workers=4) as pool:
        regs = dict(zip(trees, pool.map(build, trees.values())))
    order = list(trees) + ["as_built"]
    failed = 0
    for name in order:
        rows = time_tree(trees[name])
        what = VARIANTS[name][0] if name in VARIANTS else ""
        if isinstance(rows, str):
            failed += 1
            print(f"[variant] {name:20s} FAILED | {what}\n{rows}", flush=True)
            continue
        def judged(r):
            ok = (r["rel_l2"] <= ATTN_REL_L2_BAND and r["worst_row"] <= ATTN_ROW_BAND
                  and r["lse_abs"] <= ATTN_LSE_BAND)
            return (f"{tuple(r['shape'])}{' lse' if r['lse'] else ''} {r['ms']:.4f} ms (rel L2 "
                    f"{r['rel_l2']:.3e}, row {r['worst_row']:.3e}, lse {r['lse_abs']:.3e} "
                    f"{'pass' if ok else 'FAIL'})")

        print(f"[variant] {name:20s} " + " | ".join(judged(r) for r in rows)
              + f" | {regs[name]} | {what}", flush=True)
        if name in EXTRA_REPORTS:
            res = _in(trees[name], EXTRA_REPORTS[name], 300)
            print(res.stdout.strip() or (res.stdout + res.stderr)[-1500:], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
