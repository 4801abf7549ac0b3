#!/usr/bin/env python3
"""Probe the wgmma descriptors of the narrow attention forward and of the
attention backward on one NVIDIA GPU (H100), each alone, against fp32
torch.matmul.

    python3 scripts/torch_wgmma_probe.py

Builds `scripts/torch_wgmma_probe.cu` with nvcc (sm_90a) into
`build/psd_tpu_torch/probe/` (git-ignored) and runs one warpgroup per
(Dp, tile, D): S = q·kᵀ through `wgmma_ss<BK>` over Dp/16 k-steps of
64-column swizzled boxes, and O = P·V through `wgmma_rs_tb<Dp>` with V
MN-major, the operands loaded by TMA from 3-D maps of a (rows, 3 heads,
D) tensor at head 1, so columns D..Dp arrive as zeros. These are the forms
of every product in attention_narrow.cu and attention_bwd.cu: the tile is
the forward's and the dQ pass's key tile, or the dK/dV pass's query tile,
whose Q and dO take both roles. Each product is held
to its fp32 torch.matmul (relative L2 ≤ 1e-5, the padding columns of O
exactly 0). Then the LayerNorm GEMMs' product `wgmma_rs<N>` (N = 160,
192, 256) with its A fragments ldmatrix-ed from a swizzled TMA tile of X and
B K-major from stacked boxes of W rows (RS_PROBES), against fp32
torch.matmul at the same band, the zero-filled columns past W's rows
exactly 0. Then attention_q8.cu's s8 products at every Dp it is built for
(32..256): QKᵀ by `wgmma_ss_s8<64>` for each warpgroup's rows and each
64-key half of a tile, from 128-byte boxes zero-filled past Dp
(S8_SS_PROBES), and P·V by `wgmma_rs_s8<Dp>` with A
loaded as the s8 fragment of a row-major P, and built as the kernel builds
it from the accumulator layout against V with its keys placed
(q8_place_keys), each held to the exact integer product (int32 equal,
computed in fp64, where every sum is exact). The bf16 probes also cover
`wgmma_rs_tb<192/224/256>`, attention_q8's "qk8" P·V at those Dp. Prints
the card's name and power limit; exits 1 if a probe fails.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "scripts" / "torch_wgmma_probe.cu"
OUT = ROOT / "build" / "psd_tpu_torch" / "probe"
# (padded head dim, tile, head dim): every (Dp, tile) the kernels are built
# for, with and without zero fill
PROBES = [(32, 64, 24), (32, 128, 32), (48, 64, 40), (48, 128, 40), (64, 64, 56),
          (64, 128, 64), (80, 128, 80), (80, 128, 72), (96, 128, 88), (128, 128, 104),
          (128, 128, 128), (160, 64, 136), (160, 64, 160),
          # the backward's own: dK/dV query tiles of 64 at Dp 80 and 96 and of
          # 32 above, dQ key tiles of 64 at Dp 96 and 128
          (80, 64, 72), (96, 64, 88), (128, 64, 104), (128, 32, 104), (128, 32, 128),
          (160, 32, 136), (160, 32, 160),
          # attention_q8.cu's "qk8" P·V at the Dp only it uses (V tiles of 128 keys)
          (192, 128, 184), (224, 128, 216), (256, 128, 256)]
# the LayerNorm GEMMs' wgmma_rs<N> (ln_gemm_sm90.cuh): (N, rows a box, W
# rows, C, K chunk): every B tile the kernels stack (one 160-row box, three
# of 64, two of 128), with W rows missing at the end (zero fill) and a K
# chunk past the first
RS_PROBES = [(160, 160, 160, 64, 0), (160, 160, 100, 192, 2), (192, 64, 192, 128, 1),
             (192, 64, 136, 64, 0), (256, 128, 256, 320, 4), (256, 128, 200, 128, 1)]
REL_BAND = 1e-5
# attention_q8.cu: every padded head dim, with the q rows of warpgroup c and
# the K half hh of a tile; (Dp, D, c, hh), D < Dp where q and k have zero
# padding columns
S8_SS_PROBES = [(32, 24, 0, 0), (64, 40, 1, 1), (96, 80, 0, 1), (128, 120, 1, 0),
                (160, 160, 1, 1), (192, 184, 0, 0), (224, 216, 1, 0), (256, 256, 0, 1)]
S8_DPS = (32, 64, 96, 128, 160, 192, 224, 256)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_wgmma_probe.py: needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    sys.path.insert(0, str(ROOT))
    from psd_tpu_torch.ops.kernels import NVCC_FLAGS, _nvcc

    OUT.mkdir(parents=True, exist_ok=True)
    lib_path = OUT / "libwgmma_probe.so"
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-I", str(ROOT / "psd_tpu_torch/csrc"),
                          "-o", str(lib_path), str(SRC)], capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit("nvcc failed:\n" + res.stdout[-3000:] + res.stderr[-3000:])
    lib = ctypes.CDLL(str(lib_path))
    lib.probe_run.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
    lib.probe_run.restype = ctypes.c_int

    g = torch.Generator(device="cuda").manual_seed(0)
    H, h, failed = 3, 1, 0
    for dp, bk, d in PROBES:
        q = torch.randn((64, H, d), generator=g, device="cuda").bfloat16()
        k = torch.randn((bk, H, d), generator=g, device="cuda").bfloat16()
        v = torch.randn((bk, H, d), generator=g, device="cuda").bfloat16()
        p = torch.rand((64, bk), generator=g, device="cuda").bfloat16()
        s = torch.zeros((64, bk), device="cuda")
        o = torch.zeros((64, dp), device="cuda")
        rc = lib.probe_run(dp, bk, q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
                           s.data_ptr(), o.data_ptr(), H, d, h)
        s_ref = q[:, h].float() @ k[:, h].float().T
        o_ref = p.float() @ v[:, h].float()
        s_rel = ((s - s_ref).norm() / s_ref.norm()).item()
        o_rel = ((o[:, :d] - o_ref).norm() / o_ref.norm()).item()
        pad = o[:, d:].abs().max().item() if dp > d else 0.0
        ok = rc == 0 and s_rel <= REL_BAND and o_rel <= REL_BAND and pad == 0.0
        failed += not ok
        print(f"[probe] Dp {dp} tile {bk} D {d}: rc {rc}; S wgmma_ss<{bk}> rel L2 {s_rel:.3e}; "
              f"O wgmma_rs_tb<{dp}> rel L2 {o_rel:.3e}, padding columns max {pad:.3e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
    lib.probe_rs_run.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    lib.probe_rs_run.restype = ctypes.c_int
    for n, r, nw, c, kc in RS_PROBES:
        x = torch.randn((64, c), generator=g, device="cuda").bfloat16()
        w = torch.randn((nw, c), generator=g, device="cuda").bfloat16()
        d = torch.full((64, n), float("nan"), device="cuda")
        rc = lib.probe_rs_run(n, r, x.data_ptr(), w.data_ptr(), d.data_ptr(), c, nw, kc)
        cols = slice(64 * kc, 64 * kc + 64)
        ref = x[:, cols].float() @ w[:, cols].float().T
        rel = ((d[:, :nw] - ref).norm() / ref.norm()).item()
        pad = d[:, nw:].abs().max().item() if n > nw else 0.0
        ok = rc == 0 and rel <= REL_BAND and pad == 0.0
        failed += not ok
        print(f"[probe] wgmma_rs<{n}> B of {n // r} box(es) of {r} rows, W rows {nw}, C {c}, "
              f"K chunk {kc}: rc {rc}; rel L2 {rel:.3e}, zero-filled columns max {pad:.3e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
    from psd_tpu_torch.ops.attention import q8_place_keys

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device="cuda", dtype=torch.int8)

    lib.probe_s8_ss_run.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    lib.probe_s8_ss_run.restype = ctypes.c_int
    for dp, d, c, hh in S8_SS_PROBES:
        q, k = i8(128, dp), i8(128, dp)
        q[:, d:] = 0
        k[:, d:] = 0
        s = torch.full((64, 64), -1, dtype=torch.int32, device="cuda")
        rc = lib.probe_s8_ss_run(dp, q.data_ptr(), k.data_ptr(), s.data_ptr(), c, hh)
        ref = (q[64 * c:64 * c + 64].double() @ k[64 * hh:64 * hh + 64].double().T).int()
        ok = rc == 0 and torch.equal(s, ref)
        failed += not ok
        print(f"[probe] wgmma_ss_s8<64> Dp {dp} D {d}, rows of WG {c}, key half {hh}: rc {rc}; "
              f"{int((s != ref).sum())} of 4096 int32 differ {'ok' if ok else 'FAIL'}", flush=True)
    lib.probe_s8_rs_run.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.probe_s8_rs_run.restype = ctypes.c_int
    for dp in S8_DPS:
        for placed in (0, 1):
            v, p = i8(dp, 128), i8(64, 128)
            o = torch.full((64, dp), -1, dtype=torch.int32, device="cuda")
            vt = q8_place_keys(v).contiguous() if placed else v
            rc = lib.probe_s8_rs_run(dp, vt.data_ptr(), p.data_ptr(), o.data_ptr(), placed)
            ref = (p.double() @ v.double().T).int()
            ok = rc == 0 and torch.equal(o, ref)
            failed += not ok
            how = "built from the accumulator, keys placed" if placed else "loaded"
            print(f"[probe] wgmma_rs_s8<{dp}> A {how}: rc {rc}; {int((o != ref).sum())} of "
                  f"{64 * dp} int32 differ {'ok' if ok else 'FAIL'}", flush=True)
    n_all = len(PROBES) + len(RS_PROBES) + len(S8_SS_PROBES) + 2 * len(S8_DPS)
    print(f"[probe] {failed} of {n_all} failed (bf16 band {REL_BAND:g}; s8 exact)")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
