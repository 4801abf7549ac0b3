#!/usr/bin/env python3
"""Variants of the normalization-fused GEMMs (`psd_tpu_torch/csrc/ln_gemm_sm90.cuh`,
`ln_proj.cu`, `ln_geglu.cu`, `gn_proj.cu`) on one NVIDIA GPU (H100): where
their time goes, and whether `ln_gemm_judge` and `gn_proj_judge` see planted
faults.

    python3 scripts/torch_ln_gemm_variants.py                       # every variant
    python3 scripts/torch_ln_gemm_variants.py d_no_norm fault_gate_shift
    python3 scripts/torch_ln_gemm_variants.py --tree PARENT          # also another checkout
    python3 scripts/torch_ln_gemm_variants.py --trees-only --rounds 3 --tree A --tree B

Each variant is a set of edits of the kernel sources (VARIANTS below):
another design choice, a diagnostic that drops one piece of work ("d_*",
wrong outputs on purpose) or a planted fault ("fault_*", as chip_smoke.py's
bands were set against). Each is built in a copy of `psd_tpu_torch/` under
`build/psd_tpu_torch/ln_variants/<name>/` (git-ignored), four builds at
once, with the helpers of scripts/torch_attention_variants.py. Then each
variant, the checkout as it is ("as_built", first and last, to show the
drift within the call) and each `--tree` run one after another, each in its
own process (with `--rounds N`, N rounds, every other one in reverse
order), at chip_smoke.py's LN_SHAPES with seeded inputs drawn as
chip_smoke.py draws them: ln_proj with three and with one output and
ln_geglu; then gn_proj at chip_smoke.py's GN_SHAPES and at (3, 64, 1280),
where the last row tile is half full; each timed on the device (10 calls captured in one CUDA graph,
replayed; CUDA events, median of 10 replays) and eagerly (one call between
CUDA events, median of 20, the wrapper's host time included: the card
idles while the host prepares the launch) and on the host clock (the
wrapper's own time, after a synchronize, median of 20), and held to its plain version by
relative L2 over each output and on its worst row, against
`ln_gemm_judge`'s bands (gn_proj: `gn_proj_judge`'s). Prints ptxas's
registers, spills and "Performance Loss" notes of the GEMM kernels, and the
card's name and power limit.
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

HDR = "psd_tpu_torch/csrc/ln_gemm_sm90.cuh"
GEGLU = "psd_tpu_torch/csrc/ln_geglu.cu"
GN = "psd_tpu_torch/csrc/gn_proj.cu"
OUT = ROOT / "build" / "psd_tpu_torch" / "ln_variants"
SHAPES = [(32768, 320), (8192, 640), (2048, 1280), (512, 1280)]
GN_SHAPES = [(8, 4096, 320), (8, 1024, 640), (8, 256, 1280), (8, 64, 1280), (3, 64, 1280)]

_PRODUCT = "          wgmma_rs<BN>(acc, a[kk], wgmma_desc(bs + kk * 32, 16, 1024), 1);\n"
_PACK = ("  return pack_bf16x2(fmaf((lo - st.x) * st.y, w.x, b.x), "
         "fmaf((hi - st.x) * st.y, w.y, b.y));\n")
_STATS_READ = "        st0 = stats[row];\n        st1 = stats[row + 8];\n"
_EXPECT = "          mbar_arrive_expect_tx(&full[s], T::kStageBytes);\n"
_STATS_LAUNCH = "    ln_stats_kernel<<<(M + 7) / 8, 256, 0, st>>>(x, stats, M, C, eps);\n"
_GRID = "<<<std::min(n_tiles, sm_count()), kThreads, T::kSmemBytes, st>>>("
_EPILOGUE = "      if constexpr (T::kOutBoxes == 0) {\n"
_NO_EPILOGUE = "      if (n_k > 0) continue;\n      if constexpr (T::kOutBoxes == 0) {\n"
# the statistics in each tile's prologue instead of a pass of their own: the
# four lanes of a row pair sum every fourth 16-byte chunk of rows `row` and
# row + 8 from device memory (x reaches the kernel in the `stats` argument)
_STATS_IN_BLOCK = '''      {
        const bf16* xg = reinterpret_cast<const bf16*>(stats);
        float s[4] = {0.f, 0.f, 0.f, 0.f};
        for (int c8 = tig; c8 < C / 8; c8 += 4) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint4 u = *reinterpret_cast<const uint4*>(
                xg + static_cast<size_t>(row + 8 * h) * C + c8 * 8);
            const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float f = __bfloat162float(e[i]);
              s[2 * h] += f;
              s[2 * h + 1] += f * f;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i] += __shfl_xor_sync(0xffffffffu, s[i], 1);
          s[i] += __shfl_xor_sync(0xffffffffu, s[i], 2);
        }
        const float m0 = s[0] / C, m1 = s[2] / C;
        st0 = make_float2(m0, rsqrtf(fmaxf(s[1] / C - m0 * m0, 0.f) + 1e-5f));
        st1 = make_float2(m1, rsqrtf(fmaxf(s[3] / C - m1 * m1, 0.f) + 1e-5f));
      }
'''
PROJ = "psd_tpu_torch/csrc/ln_proj.cu"
# ln_geglu's and ln_proj's three-output epilogues from registers: each
# thread stores its bf16 pairs straight to device memory (4-byte stores,
# rows g and g + 8), no staging, no TMA store; the rings keep their depth
_GEGLU_STORE = """  bf16* out;

  __device__ __forceinline__ void store(const float (&acc)[128], int row, int ct, int tig) const {
#pragma unroll
    for (int jb = 0; jb < 16; ++jb) {
      uint32_t lo, hi;
      pack(acc, jb, ct, tig, lo, hi);
      const int col = ct * 128 + 8 * jb + 2 * tig;
      if (col < N) {
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row) * N + col) = lo;
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row + 8) * N + col) = hi;
      }
    }
  }

  __host__ __device__ static constexpr int out_map(int) { return 0; }"""
_PROJ3_STORE = """  static constexpr int kOutputs = 3;
  bf16* out[3];
  int N;

  __device__ __forceinline__ void store(const float (&acc)[96], int row, int ct, int tig) const {
#pragma unroll
    for (int jb = 0; jb < 24; ++jb) {
      uint32_t lo, hi;
      pack(acc, jb, ct, tig, lo, hi);
      const int col = ct * 64 + 8 * (jb % 8) + 2 * tig;
      if (col < N) {
        bf16* r0 = out[jb / 8] + static_cast<size_t>(row) * N + col;
        *reinterpret_cast<uint32_t*>(r0) = lo;
        *reinterpret_cast<uint32_t*>(r0 + 8 * static_cast<size_t>(N)) = hi;
      }
    }
  }"""
_DIRECT_STORE = [
    (HDR, _rep("kStages = 3, kOutBoxes = 2;", "kStages = 3, kOutBoxes = 0;")),
    (HDR, _rep("kSliceRows = 64, kStages = 4, kOutBoxes = 3;",
               "kSliceRows = 64, kStages = 4, kOutBoxes = 0;")),
    (GEGLU, _rep("  __host__ __device__ static constexpr int out_map(int) { return 0; }",
                 _GEGLU_STORE)),
    (GEGLU, _rep("GegluEpi epi{static_cast<const float*>(b), N};",
                 "GegluEpi epi{static_cast<const float*>(b), N, static_cast<bf16*>(out)};")),
    (PROJ, _rep("  static constexpr int kOutputs = 3;\n\n", _PROJ3_STORE + "\n\n")),
    (PROJ, _rep("Proj3Epi{}", "Proj3Epi{{o[0], o[1], o[2]}, N}")),
]


def _edits(path: str, *edits):
    return [(path, e) for e in edits]


# gn_proj's B tile 160 W rows, its epilogue storing bf16 pairs (bias
# added) from registers, rows past M and columns past N left out; the ring
# 6 deep, as ln_proj's one output
_GN_STORE = """  const float* bias;
  int N;
  bf16* out;
  int M;

  __device__ __forceinline__ void store(const float (&acc)[80], int row, int ct, int tig) const {
#pragma unroll
    for (int j = 0; j < 20; ++j) {
      const int col = ct * 160 + 8 * j + 2 * tig;
      if (col < N) {
        const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + col));
        bf16* r0 = out + static_cast<size_t>(row) * N + col;
        if (row < M)
          *reinterpret_cast<uint32_t*>(r0) = pack_bf16x2(acc[4 * j] + bb.x, acc[4 * j + 1] + bb.y);
        if (row + 8 < M)
          *reinterpret_cast<uint32_t*>(r0 + 8 * static_cast<size_t>(N)) =
              pack_bf16x2(acc[4 * j + 2] + bb.x, acc[4 * j + 3] + bb.y);
      }
    }
  }
"""
_GN_REGISTER_STORE = [
    (HDR, _rep("kSlices = 1, kSliceRows = 192, kStages = 4, kOutBoxes = 3;",
               "kSlices = 1, kSliceRows = 160, kStages = 6, kOutBoxes = 0;")),
    (GN, _rep("  const float* bias;\n  int N;\n", _GN_STORE)),
    (GN, _rep("GnEpi epi{static_cast<const float*>(bias), N};",
              "GnEpi epi{static_cast<const float*>(bias), N, static_cast<bf16*>(out), M};")),
]


# name → (what it tests, [(source, edit), ...])
VARIANTS = {
    "not_persistent": ("a block for each tile (the grid of tiles), not one an SM",
                       _edits(HDR, _rep(_GRID, "<<<n_tiles, kThreads, T::kSmemBytes, st>>>("))),
    "stats_in_block": ("the statistics in each tile's prologue, no stats pass",
                       _edits(HDR, _rep(_STATS_READ, _STATS_IN_BLOCK),
                              _rep(_STATS_LAUNCH, ""),
                              _rep("      maps, stats, lw, lb, epi, M, C, N, S);",
                                   "      maps, reinterpret_cast<const float2*>(x), lw, lb, epi, "
                                   "M, C, N, S);"))),
    "direct_store": ("ln_geglu's and ln_proj's three-output epilogues stored from registers, "
                     "not staged for TMA stores", _DIRECT_STORE),
    "stages_minus1": ("every ring one stage shallower (3/4/6/4 as built: 2/3/5/3)",
                      _edits(HDR, _rep("kSliceRows = 128, kStages = 3,", "kSliceRows = 128, kStages = 2,"),
                             _rep("kSliceRows = 64, kStages = 4,", "kSliceRows = 64, kStages = 3,"),
                             _rep("kSliceRows = 160, kStages = 6,", "kSliceRows = 160, kStages = 5,"),
                             _rep("kSliceRows = 192, kStages = 4,", "kSliceRows = 192, kStages = 3,"))),
    "gn_register_store": ("gn_proj on 160-column tiles (m64n160) stored from registers, not "
                          "192-column tiles whose bf16 output leaves by stmatrix and TMA stores",
                          _GN_REGISTER_STORE),
    # diagnostics: each removes one piece of work; the outputs are wrong on purpose
    "d_no_launch": ("diagnostic: the wrapper alone (no tensor map encoded, no launch)",
                    _edits(HDR, _rep("  Maps maps{};\n", "  if (true) return cudaSuccess;\n"
                                     "  Maps maps{};\n"))),
    "d_maps_only": ("diagnostic: the wrapper and the tensor maps (no launch)",
                    _edits(HDR, _rep("  cudaError_t err = allow_smem(",
                                     "  if (true) return cudaSuccess;\n  cudaError_t err = allow_smem("))),
    "d_stats_only": ("diagnostic: the stats pass alone (the GEMM not launched)",
                     _edits(HDR, _rep("  const int n_tiles = ((M + kBM - 1) / kBM) * ((N",
                                      "  if (true) return cudaGetLastError();\n"
                                      "  const int n_tiles = ((M + kBM - 1) / kBM) * ((N"))),
    "d_gemm_only": ("diagnostic: the GEMM alone (the stats pass not launched)",
                    _edits(HDR, _rep(_STATS_LAUNCH, ""))),
    "d_no_norm": ("diagnostic: x enters the products raw (no LayerNorm arithmetic)",
                  _edits(HDR, _rep(_PACK, "  return u;\n"))),
    "d_no_products": ("diagnostic: no wgmma", _edits(HDR, _rep(_PRODUCT, ""))),
    "d_no_epilogue": ("diagnostic: no epilogue (the accumulators never stored)",
                      _edits(HDR, _rep(_EPILOGUE, _NO_EPILOGUE))),
    "d_no_gelu": ("diagnostic: ln_geglu's gate without erff (h·g)",
                  _edits(GEGLU, _rep("  return 0.5f * g * (1.f + erff(g * 0.70710678118654752f));",
                                     "  return g;"))),
    "d_no_refill": ("diagnostic: the ring loaded once, never refilled",
                    _edits(HDR, _rep(_EXPECT, "          if (seq >= ST) { mbar_arrive(&full[s]); "
                                     "continue; }\n" + _EXPECT))),
    "d_skeleton": ("diagnostic: no products, no LayerNorm arithmetic, no epilogue",
                   _edits(HDR, _rep(_PRODUCT, ""), _rep(_PACK, "  return u;\n"),
                          _rep(_EPILOGUE, _NO_EPILOGUE))),
    # planted faults
    "fault_drop_last_chunk": ("fault: the main loop drops its last K chunk's products",
                              _edits(HDR, _rep(_PRODUCT, "          if (k + 1 < n_k)\n  "
                                               + _PRODUCT))),
    "fault_neighbour_stats": ("fault: row r takes row r+1's statistics",
                              _edits(HDR, _rep(_STATS_READ,
                                               "        st0 = stats[(row + 1) % M];\n"
                                               "        st1 = stats[(row + 9) % M];\n"))),
    "fault_gate_shift": ("fault: GEGLU gates h column j with g column j+8 of its tile",
                         _edits(GEGLU, _rep("const int h = 4 * jb, g = 4 * (jb + 16);",
                                            "const int h = 4 * jb, g = 4 * ((jb + 1) % 16 + 16);"))),
    "fault_neighbour_affine": ("fault: K chunk k takes chunk k+1's LN affine",
                               _edits(HDR, _rep("lw + k * kBK,", "lw + ((k + 1) % n_k) * kBK,"),
                                      _rep("lb + k * kBK,", "lb + ((k + 1) % n_k) * kBK,"))),
    "fault_gn_neighbour_slot": ("fault: gn_proj's rows take the other batch slot's affine "
                                "(the neighbour element's, where a tile straddles two)",
                                _edits(HDR, _rep("sl0 = (row / S - b0) * kBK;",
                                                 "sl0 = (1 - (row / S - b0)) * kBK;"),
                                       _rep("sl1 = ((row + 8) / S - b0) * kBK;",
                                            "sl1 = (1 - ((row + 8) / S - b0)) * kBK;"))),
    "fault_gn_drop_bias": ("fault: gn_proj's epilogue drops the bias",
                           _edits(GN, _rep("col < N ? __ldg(reinterpret_cast<const float2*>(bias + "
                                           "col)) : make_float2(0.f, 0.f);",
                                           "make_float2(0.f, 0.f);"))),
    "fault_gn_ragged_unwritten": ("fault: a half-full last row tile's stores are not issued",
                                  _edits(HDR, _rep("        if (leader) {\n",
                                                   "        if (leader && (t / n_ct + 1) * kBM <= M) {"
                                                   "\n"))),
}


def make_tree(name: str) -> Path:
    """A copy of psd_tpu_torch/ under OUT with the edits of VARIANTS[name]."""
    root = OUT / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(ROOT / "psd_tpu_torch", root / "psd_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for src, edit in VARIANTS[name][1]:
        path = root / src
        path.write_text(edit(path.read_text()))
    return root


def ptxas(text: str) -> str:
    """Registers, spills and Performance Loss notes of the GEMM kernels."""
    found, name, spill = [], None, "?"
    kinds = {"0": "proj1", "1": "proj3", "2": "geglu", "3": "gn"}
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '\w*?ln_gemm_kernelILN\w*?KindE(\d)E", line)
        if m:
            name, spill = f"ln_gemm<{kinds[m.group(1)]}>", "?"
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found.append(f"{name} {m.group(1)} regs, {spill} B spilled")
            name = None
    notes = [l.strip() for l in text.splitlines()
             if "Performance Loss" in l and "ln_gemm_kernel" in l]
    return "; ".join(found) + f"; {len(notes)} Performance Loss notes" + "".join(
        f"\n  {n[:300]}" for n in notes[:3])


def build(root: Path) -> str:
    ok, text = compile_tree(root)
    return ptxas(text) if ok else text


_TIME_ONE = '''
import json, statistics, time, torch
from psd_tpu_torch.ops import geglu
shapes = {shapes!r}
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(0)
bf = torch.bfloat16

def randn(*shape, std=1.0, dtype=bf):
    return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

def rel(outs, refs):
    outs = outs if isinstance(outs, tuple) else (outs,)
    refs = refs if isinstance(refs, tuple) else (refs,)
    r, w, fin = 0.0, 0.0, True
    for o, f in zip(outs, refs):
        d = o.float() - f.float()
        r = max(r, (d.norm() / f.float().norm()).item())
        w = max(w, (d.norm(dim=-1) / f.float().norm(dim=-1).clamp_min(1e-30)).max().item())
        fin = fin and bool(torch.isfinite(o).all())
    return [r, w, fin]

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
    """(eager ms: one call between events, the wrapper's host time
    included; device ms: 10 calls captured in one CUDA graph, replayed;
    host ms: the call's own time on the host clock, after a synchronize)"""
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

res = []
for M, C in shapes:
    x = randn(M, C)
    lw = 1.0 + randn(C, std=0.1, dtype=torch.float32)
    lb = randn(C, std=0.1, dtype=torch.float32)
    for n_out in (3, 1):
        ws = tuple(randn(C, C, std=C ** -0.5) for _ in range(n_out))
        row = {{"kernel": f"ln_proj{{n_out}}", "shape": [M, C]}}
        row["judge"] = rel(geglu.ln_proj_fwd(x, lw, lb, ws), geglu.ln_proj_reference(x, lw, lb, ws))
        row["ms"] = timed(lambda: geglu.ln_proj_fwd(x, lw, lb, ws))
        res.append(row)
    w0 = randn(8 * C, C, std=C ** -0.5)
    b0 = randn(8 * C, std=0.02, dtype=torch.float32)
    row = {{"kernel": "ln_geglu", "shape": [M, C]}}
    row["judge"] = rel(geglu.ln_geglu_fwd(x, lw, lb, w0, b0),
                       geglu.ln_geglu_reference(x, lw, lb, w0, b0))
    row["ms"] = timed(lambda: geglu.ln_geglu_fwd(x, lw, lb, w0, b0))
    res.append(row)
    del x, w0
    torch.cuda.empty_cache()
from psd_tpu_torch.ops import gnproj
for B, S, C in {gn_shapes!r}:
    x = randn(B, S, C)
    gw = 1.0 + randn(B, C, std=0.1, dtype=torch.float32)
    gb = randn(B, C, std=0.1, dtype=torch.float32)
    w = randn(C, C, std=C ** -0.5)
    bias = randn(C, std=0.02, dtype=torch.float32)
    row = {{"kernel": "gn_proj", "shape": [B, S, C]}}
    row["judge"] = rel(gnproj.gn_proj_fwd(x, gw, gb, w, bias),
                       gnproj.gn_proj_reference(x, gw, gb, w, bias))
    row["ms"] = timed(lambda: gnproj.gn_proj_fwd(x, gw, gb, w, bias))
    res.append(row)
print(json.dumps(res))
'''


def time_tree(root: Path):
    """The timing rows of one tree, or the tail of its error output."""
    try:
        res = _in(root, _TIME_ONE.format(shapes=SHAPES, gn_shapes=GN_SHAPES), 300)
    except subprocess.TimeoutExpired:
        return "timed out after 300 s"
    if res.returncode != 0:
        return (res.stdout + res.stderr)[-1500:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", help=f"variants to time (default: all of {list(VARIANTS)})")
    ap.add_argument("--tree", action="append", default=[],
                    help="another checkout whose LN kernels are timed too (repeatable)")
    ap.add_argument("--trees-only", action="store_true",
                    help="time as_built and the --tree checkouts, no variant")
    ap.add_argument("--rounds", type=int, default=1,
                    help="time every tree this many times, alternating the order")
    args = ap.parse_args()
    import torch

    sys.path.insert(0, str(ROOT))
    from psd_tpu_torch.testing import GN_REL_L2_BAND, GN_ROW_BAND, LN_REL_L2_BAND, LN_ROW_BAND

    if not torch.cuda.is_available():
        raise SystemExit("torch_ln_gemm_variants.py: needs an NVIDIA GPU")
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
        rows = time_tree(trees[name])
        what = VARIANTS[name][0] if name in VARIANTS else ""
        if isinstance(rows, str):
            failed += 1
            print(f"[ln variant] {name:24s} FAILED | {what}\n{rows}", flush=True)
            continue

        def judged(r):
            rel, row, finite = r["judge"]
            bands = (GN_REL_L2_BAND, GN_ROW_BAND) if r["kernel"] == "gn_proj" else (
                LN_REL_L2_BAND, LN_ROW_BAND)
            ok = finite and rel <= bands[0] and row <= bands[1]
            eager, device, host = r["ms"]
            return (f"{r['kernel']} {tuple(r['shape'])} {device:.4f} ms device, {eager:.4f} eager, "
                    f"{host:.4f} host ({rel:.3e}/{row:.3e} {'pass' if ok else 'FAIL'})")

        print(f"[ln variant] {name:24s} " + " | ".join(judged(r) for r in rows)
              + f" | {regs[name]} | {what}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
