#!/usr/bin/env python3
"""Variants of the split3 kernel (`psd_tpu_torch/csrc/split3.cu`) on one
NVIDIA GPU (H100): where its time goes, and whether `split3_judge` sees
planted faults.

    python3 scripts/torch_split3_variants.py                        # every variant
    python3 scripts/torch_split3_variants.py d_copy_only fault_skip_group
    python3 scripts/torch_split3_variants.py --tree PARENT           # also another checkout
    python3 scripts/torch_split3_variants.py --trees-only --rounds 3 --tree A --tree B

Each variant is a set of edits of the kernel's sources (VARIANTS below):
another design choice (consumer warps, item rows, ring depth, store
route), a diagnostic that drops one piece of work ("d_*", wrong outputs on
purpose; `d_copy_only` streams q to the output with no arithmetic, the
floor the design is measured against) or a planted fault ("fault_*", as
chip_smoke.py's bands were set against). Each is built in a copy of
`psd_tpu_torch/` under `build/psd_tpu_torch/split3_variants/<name>/`
(git-ignored), four builds at once, with the helpers of
scripts/torch_attention_variants.py. Then each variant, the checkout as it
is ("as_built", first and last, to show the drift within the call) and
each `--tree` run one after another, each in its own process (with
`--rounds N`, N rounds, every other one in reverse order), at
chip_smoke.py's SPLIT3_SHAPES (banks of 16 tokens, δ = 1) and at
(2, 384, 8, 40) with banks of 4, 16 and 7 tokens and δ = −1.5, seeded
N(0,1) bf16 inputs: timed on the device (10 calls captured in one CUDA
graph, replayed; CUDA events, median of 10 replays), eagerly (one call
between CUDA events, median of 20, the wrapper's host time included) and on
the host clock (the wrapper's own time, after a synchronize, median of 20),
and held to split3_reference by relative L2 over the output and on its
worst row, against `split3_judge`'s bands. Prints ptxas's registers,
stack and spills of the split3 kernels, and the card's name and power
limit.
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

SRC = "psd_tpu_torch/csrc/split3.cu"
PLAN = "psd_tpu_torch/ops/split3.py"
OUT = ROOT / "build" / "psd_tpu_torch" / "split3_variants"
# ((B, S, H, D), bank lengths, δ)
CASES = [((8, 4096, 8, 40), (16, 16, 16), 1.0), ((8, 1024, 8, 80), (16, 16, 16), 1.0),
         ((8, 256, 8, 160), (16, 16, 16), 1.0), ((2, 384, 8, 40), (4, 16, 7), -1.5)]

_UNITS = "    for (int u = warp; u < units; u += kWarps) {\n"
_WARPS = "return NB == 2 ? 8 : DP <= 80 ? 16 : 8;"
_STORE = ("      for (int j = 0; j < n_box; ++j)\n"
          "        tma_store_3d(&maps.out, sp + j * R * 128,")
_MASK = "if (t * 8 + tig * 2 + e >= L) sj[e] = sj[2 + e] = -INFINITY;"
_QLOAD = "ldmatrix_x4(qa, qrow + swz(c8 + 2 * ks"
_S_PRODUCT = "          mma_bf16(sc[j], qa, ld_shared_u32(k0 + kj), ld_shared_u32(k1 + kj));\n"
# the item's output leaves by 16-byte stores of whole row segments, each
# thread a chunk at a time, instead of TMA stores; the stage is refilled
# (with the item ST ahead) once every thread has read it
_DIRECT = """    __syncthreads();
    for (int idx = threadIdx.x; idx < R * n_box * 8; idx += 32 * kWarps) {
      const int row = idx / (n_box * 8), col = (idx % (n_box * 8)) * 8;
      if (col < G * D && grp * G * D + col < H * D)
        *reinterpret_cast<uint4*>(out + (static_cast<size_t>(b) * S + (it % n_rb) * R + row) * H * D
                                  + grp * G * D + col) =
            *reinterpret_cast<const uint4*>(sp + row * 128 + swz(col / 8, row & 7, R));
    }
    __syncthreads();
    if (threadIdx.x == 0 && it + ST < i1) load_item(it + ST, s);
    if (threadIdx.x < 0) {
"""


def _edits(path: str, *edits):
    return [(path, e) for e in edits]


# name → (what it tests, [(source, edit), ...])
VARIANTS = {
    "warps8": ("one block an SM: eight warps at every head dim (sixteen as built where DP <= 80)",
               _edits(SRC, _rep(_WARPS, "return NB == 2 ? 8 : 8;"))),
    "warps16": ("one block an SM: sixteen warps at every head dim (at most 128 registers a thread)",
                _edits(SRC, _rep(_WARPS, "return NB == 2 ? 8 : 16;"))),
    "one_block": ("one block an SM everywhere (two of eight warps as built where D <= 80 and "
                  "one block would get fewer than two items)",
                  _edits(PLAN, _rep("    if D <= 80 and rows // R * (H // G) < 2 * sms:",
                                    "    if False:"))),
    "rows32": ("items of 32 rows, not 64",
               _edits(PLAN, _rep("    for R in (64, 32, 16):", "    for R in (32, 16):"))),
    "stages3": ("rings of at most 3 stages (4 as built where they fit)",
                _edits(PLAN, _rep("SPLIT3_SMEM_MAX_2, SPLIT3_MAX_STAGES = 232448, 115712, 4",
                                  "SPLIT3_SMEM_MAX_2, SPLIT3_MAX_STAGES = 232448, 115712, 3"))),
    "stages2": ("rings of 2 stages",
                _edits(PLAN, _rep("SPLIT3_SMEM_MAX_2, SPLIT3_MAX_STAGES = 232448, 115712, 4",
                                  "SPLIT3_SMEM_MAX_2, SPLIT3_MAX_STAGES = 232448, 115712, 2"))),
    "direct_store": ("the output stored by 16-byte stores of whole row segments from the stage, "
                     "not by TMA",
                     _edits(SRC, _rep("const __grid_constant__ Maps maps, const Split3Args a,",
                                      "const __grid_constant__ Maps maps, bf16* __restrict__ out, "
                                      "const Split3Args a,"),
                            _rep("    fence_async_shared();\n    __syncthreads();\n"
                                 "    if (threadIdx.x == 0) {\n", _DIRECT),
                            _rep("st>>>(maps, a, delta, B,", "st>>>(maps, out, a, delta, B,"))),
    # diagnostics: each removes one piece of work; the outputs are wrong on purpose
    "d_no_launch": ("diagnostic: the wrapper alone (no tensor map encoded, no launch)",
                    _edits(SRC, _rep("  Maps maps;\n", "  if (true) return cudaSuccess;\n  Maps maps;\n"))),
    "d_empty": ("diagnostic: the launch, the barriers' init and the banks' zero fill alone",
                _edits(SRC, _rep("    load_banks(i0 / n_rb);\n", ""),
                       _rep("    for (int it = i0; it < i1 && it < i0 + ST; ++it) load_item(it, it - i0);\n",
                            ""),
                       _rep("  __syncthreads();\n\n  const int g = lane",
                            "  __syncthreads();\n  if (i1 >= 0) return;\n\n  const int g = lane"))),
    "d_copy_only": ("diagnostic: q streamed to the output, no arithmetic (no unit computed)",
                    _edits(SRC, _rep(_UNITS, _UNITS.replace("u < units", "u < 0")))),
    "d_one_unit": ("diagnostic: each warp computes only its first unit of an item",
                   _edits(SRC, _rep(_UNITS, _UNITS.replace("u < units", "u < units && u < kWarps")))),
    "d_no_logits": ("diagnostic: no logit products (no K fragment loaded)",
                    _edits(SRC, _rep(_S_PRODUCT, ""))),
    "d_no_banks": ("diagnostic: the banks never loaded (nor waited for)",
                   _edits(SRC, _rep("    if (run != staged) {\n", "    if (false) {\n"),
                          _rep("    load_banks(i0 / n_rb);\n", ""),
                          _rep("    if (it == i0 || run != (it - 1) / n_rb) mbar_wait(", "    if (false) mbar_wait("))),
    "d_no_store": ("diagnostic: no TMA store of the output",
                   _edits(SRC, _rep(_STORE, _STORE.replace("j < n_box", "j < 0")))),
    # planted faults
    "fault_mask_last_key": ("fault: the disease bank's last valid key masked",
                            _edits(SRC, _rep(_MASK, _MASK.replace(">= L)", ">= L - (i == 1))")))),
    "fault_pad_key_in": ("fault: the delta bank lets one padded (zero) key in where it is short",
                         _edits(SRC, _rep(_MASK, _MASK.replace(">= L)",
                                                               ">= L + (i == 2 && L < 16))")))),
    "fault_delta_on_anat": ("fault: δ gates the anatomy bank",
                            _edits(SRC, _rep("{a.gate[0], a.gate[1], __ldg(delta)}",
                                             "{__ldg(delta), a.gate[1], __ldg(delta)}"))),
    "fault_neighbour_head_q": ("fault: a unit takes the next head's q",
                               _edits(SRC, _rep(_QLOAD, _QLOAD.replace(
                                   "swz(c8 + 2 * ks", "swz(((hl + 1) % G) * D / 8 + 2 * ks")))),
    "fault_skip_group": ("fault: each item's last 16-row unit is skipped (its rows keep q)",
                         _edits(SRC, _rep(_UNITS, _UNITS.replace("u < units", "u < units - 1")))),
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
    """Registers, stack and spills of the split3 kernels, by padded head dim."""
    found, name, extra = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '\w*?split3_kernelILi(\d+)E", line)
        if m:
            name, extra = m.group(1), ""
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m:
            extra = f", stack {m.group(1)}, {m.group(2)} B spilled"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found.append(f"<{name}> {m.group(1)} regs{extra}")
            name = None
    return "split3_kernel " + "; ".join(found)


def build(root: Path) -> str:
    ok, text = compile_tree(root)
    return ptxas(text) if ok else text


_TIME_ONE = '''
import json, statistics, time, torch
from psd_tpu_torch.ops import split3
cases = {cases!r}
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(0)
bf = torch.bfloat16

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

res = []
for (B, S, H, D), lens, delta in cases:
    q = torch.randn((B, S, H, D), generator=g, device=dev).to(bf)
    banks = [torch.randn((B, n, H, D), generator=g, device=dev).to(bf) for n in lens for _ in range(2)]
    dl = torch.tensor(delta, device=dev)  # δ in device memory, as the kernel reads it
    fn = lambda: split3.split3_fwd(q, *banks, dl, 0.1, 0.9)
    out, ref = fn().float(), split3.split3_reference(q, *banks, dl, 0.1, 0.9).float()
    d = out - ref
    rel = (d.norm() / ref.norm()).item()
    row = (d.norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)).max().item()
    res.append({{"shape": [B, S, H, D], "lens": list(lens), "delta": delta,
                 "judge": [rel, row, bool(torch.isfinite(out).all())], "ms": timed(fn)}})
    del q, banks, out, ref
    torch.cuda.empty_cache()
print(json.dumps(res))
'''


def time_tree(root: Path):
    """The timing rows of one tree, or the tail of its error output."""
    try:
        res = _in(root, _TIME_ONE.format(cases=CASES), 300)
    except subprocess.TimeoutExpired:
        return "timed out after 300 s"
    if res.returncode != 0:
        return (res.stdout + res.stderr)[-1500:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", help=f"variants to time (default: all of {list(VARIANTS)})")
    ap.add_argument("--tree", action="append", default=[],
                    help="another checkout whose split3 kernel is timed too (repeatable)")
    ap.add_argument("--trees-only", action="store_true",
                    help="time as_built and the --tree checkouts, no variant")
    ap.add_argument("--rounds", type=int, default=1,
                    help="time every tree this many times, alternating the order")
    args = ap.parse_args()
    import torch

    sys.path.insert(0, str(ROOT))
    from psd_tpu_torch.testing import SPLIT3_REL_L2_BAND, SPLIT3_ROW_BAND

    if not torch.cuda.is_available():
        raise SystemExit("torch_split3_variants.py: needs an NVIDIA GPU")
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
            print(f"[split3 variant] {name:24s} FAILED | {what}\n{rows}", flush=True)
            continue

        def judged(r):
            rel, row, finite = r["judge"]
            ok = finite and rel <= SPLIT3_REL_L2_BAND and row <= SPLIT3_ROW_BAND
            eager, device, host = r["ms"]
            return (f"{tuple(r['shape'])} banks {tuple(r['lens'])} {device:.4f} ms device, "
                    f"{eager:.4f} eager, {host:.4f} host ({rel:.3e}/{row:.3e} "
                    f"{'pass' if ok else 'FAIL'})")

        print(f"[split3 variant] {name:24s} " + " | ".join(judged(r) for r in rows)
              + f" | {regs[name]} | {what}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
