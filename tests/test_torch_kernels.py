"""Port kernels vs the Pallas kernels they replace, on the CPU.

The hand-written CUDA kernels run only on the GPU (chip_smoke.py checks them
there against these same plain versions). Here each wrapper takes its CPU
path, the plain PyTorch version, and is held against the JAX function run as
psd_tpu's own tests run it: the Pallas kernel in interpret mode, or the XLA
path where the Pallas kernel has no CPU mode (the stock flash kernel).

Inputs come from numpy's default_rng, in fp32. Tolerance: rtol 1e-5,
atol 1e-5 unless stated — both sides compute the same fp32 math and differ
only in summation order and in the kernels' exp2/log2e folding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psd_tpu.ops.attention import dot_product_attention as jax_attention
from psd_tpu.ops.geglu import ln_geglu as jax_ln_geglu
from psd_tpu.ops.geglu import ln_proj as jax_ln_proj
from psd_tpu.ops.gnproj import gn_proj as jax_gn_proj
from psd_tpu.ops.spattn import spatial_attention
from psd_tpu.ops.split3 import split3_attention
from psd_tpu_torch.ops import attention, geglu, gnproj, split3
from psd_tpu_torch.ops.norms import group_norm_fold

RTOL = ATOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("S,D", [(256, 40), (512, 40), (256, 80), (512, 80)])
def test_attention_matches_spattn_interpret(S, D):
    rng = _rng(S + D)
    q, k, v = (rng.standard_normal((2, S, 2, D)).astype(np.float32) for _ in range(3))
    ref = np.asarray(spatial_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       interpret=True))
    out = attention.attention_fwd(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_attention_matches_flash_role_d512():
    """The VAE mid-block shape class (one head, D=512). On the CPU
    psd_tpu's flash wrapper returns None and dot_product_attention runs its
    XLA path, which is the function the flash kernel computes."""
    rng = _rng(512)
    q, k, v = (rng.standard_normal((1, 512, 1, 512)).astype(np.float32) * 0.2
               for _ in range(3))
    ref = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    out = attention.attention_fwd(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape,route", [
    ((8, 4096, 8, 40), "spattn"),
    ((8, 1024, 8, 80), "spattn"),
    ((8, 4096, 1, 512), "flash"),
    ((8, 256, 8, 160), None),
    ((8, 64, 8, 160), None),
])
def test_attention_routing_follows_psd_tpu(shape, route):
    q = torch.empty(shape, device="meta")
    assert attention.kernel_route(q, q) == route


@pytest.mark.parametrize("delta,lens,S", [
    pytest.param(0.0, (16, 16, 16), 256, id="0.0"),
    pytest.param(1.3, (16, 16, 16), 256, id="1.3"),
    pytest.param(-1.5, (4, 16, 7), 384, id="unequal_banks_S384"),
])
def test_split3_matches_pallas_interpret(delta, lens, S):
    """Banks of 16 tokens each, and banks of unequal lengths at S = 384
    (three 128-row Pallas blocks)."""
    rng = _rng(int(delta * 10) + sum(lens))
    B, H, D = 2, 2, 40
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    banks = [rng.standard_normal((B, n, H, D)).astype(np.float32) for n in lens for _ in range(2)]
    ref = np.asarray(split3_attention(jnp.asarray(q), *map(jnp.asarray, banks),
                                      jnp.float32(delta), 0.9, 0.2, None, 128, True))
    out = split3.split3_fwd(_t(q), *map(_t, banks), delta, 0.9, 0.2).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def _ln_inputs(seed, M=512, C=64):
    rng = _rng(seed)
    x = (rng.standard_normal((M, C)) * 2.0 + 0.5).astype(np.float32)
    s = (1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    return x, s, b


@pytest.mark.parametrize("n_out", [1, 3])
def test_ln_proj_matches_pallas_interpret(n_out):
    x, s, b = _ln_inputs(n_out)
    rng = _rng(10 + n_out)
    ws = [(rng.standard_normal((64, 64)) / 8.0).astype(np.float32) for _ in range(n_out)]
    ref = jax_ln_proj(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                      tuple(jnp.asarray(w) for w in ws), 1e-5, 256, True)
    # the port takes weights in Linear layout (out, in)
    outs = geglu.ln_proj_fwd(_t(x), _t(s), _t(b), tuple(_t(w.T.copy()) for w in ws))
    assert len(outs) == n_out
    for o, r in zip(outs, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)


def test_ln_geglu_matches_pallas_interpret():
    """Tolerance atol 2e-5: the Pallas kernel's A&S erf polynomial differs
    from exact erf by up to 1.5e-7, times |h| of order 10."""
    x, s, b = _ln_inputs(7)
    rng = _rng(17)
    w0 = (rng.standard_normal((64, 512)) / 8.0).astype(np.float32)
    b0 = (0.1 * rng.standard_normal(512)).astype(np.float32)
    ref = np.asarray(jax_ln_geglu(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                                  jnp.asarray(w0), jnp.asarray(b0), 1e-5, 256, True))
    out = geglu.ln_geglu_fwd(_t(x), _t(s), _t(b), _t(w0.T.copy()), _t(b0)).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=2e-5)


def test_ln_reference_is_flax_fast_variance():
    """A row of large mean and tiny spread: E[x²]−μ² goes slightly negative
    in fp32 and must clamp at 0 rather than give NaN."""
    x = torch.full((1, 64), 1000.0) + torch.linspace(0, 1e-3, 64)[None]
    y = geglu.ln_reference(x, torch.ones(64), torch.zeros(64))
    assert torch.isfinite(y).all()


@pytest.mark.parametrize("B,S,C,N", [
    pytest.param(2, 64, 64, 64, id="64-64-64"),
    pytest.param(2, 256, 64, 128, id="256-64-128"),
    pytest.param(2, 128, 128, 64, id="128-128-64"),
    pytest.param(3, 64, 128, 128, id="B3-S64"),
])
def test_gn_proj_matches_pallas_interpret(B, S, C, N):
    """S = 64 is the mid-block case, where a 128-row tile of the CUDA
    kernel spans two batch elements; at B = 3 the last tile holds the third
    element's 64 rows alone (half full)."""
    rng = _rng(S + C + N + 100 * (B - 2))
    x = (rng.standard_normal((B, S, C)) * 2.0 + 0.3).astype(np.float32)
    gs = (1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    gb = (0.1 * rng.standard_normal(C)).astype(np.float32)
    w_in = (rng.standard_normal((C, N)) / np.sqrt(C)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(N)).astype(np.float32)
    w, b = group_norm_fold(_t(x), _t(gs), _t(gb), 32, 1e-6)
    ref = jax_gn_proj(jnp.asarray(x), jnp.asarray(w.numpy()), jnp.asarray(b.numpy()),
                      (jnp.asarray(w_in),), (jnp.asarray(bias),), interpret=True)[0]
    out = gnproj.gn_proj_fwd(_t(x), w, b, _t(w_in.T.copy()), _t(bias))
    assert out.shape == (B, S, N)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


# ---- int8 spatial attention (spattn.py::_kernel_q8) ------------------------------
def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("quant", ["qk8", "int8"])
@pytest.mark.parametrize("shape", [(1, 256, 2, 40), (2, 512, 2, 80), (1, 256, 1, 160)])
def test_spatial_attention_q8_matches_pallas_interpret(shape, quant):
    """The port's op (plain torch quantization pre-pass, then the kernel
    wrapper's plain version) against psd_tpu's with `_kernel_q8` in
    interpret mode, fp32 inputs. The quantized operands are bit-equal; the
    logits, softmax and exact integer products agree to fp32 rounding:
    relative L2 ≤ 1e-5 in "qk8". "int8" also rounds p to int8, and an
    fp32-rounding difference in p/l can flip one tie (1e-3: one flip at
    D = 160 reads 3e-4)."""
    rng = _rng(sum(shape))
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    ref = np.asarray(spatial_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       quant=quant, interpret=True))
    out = attention.spatial_attention(_t(q), _t(k), _t(v), quant=quant)
    assert out.shape == shape and out.dtype == torch.float32
    assert _rel_l2(out.numpy(), ref) <= (1e-5 if quant == "qk8" else 1e-3)


@pytest.mark.parametrize("shape_q,shape_k", [
    ((1, 100, 2, 40), (1, 100, 2, 40)),    # S % 256
    ((1, 256, 2, 40), (1, 512, 2, 40)),    # Sq != Sk
    ((1, 4352, 1, 8), (1, 4352, 1, 8)),    # S > 4096
    ((1, 256, 1, 264), (1, 256, 1, 264)),  # D > 256
])
@pytest.mark.parametrize("quant", ["none", "qk8", "int8"])
def test_spatial_attention_declines_like_psd_tpu(shape_q, shape_k, quant):
    q, k = np.zeros(shape_q, np.float32), np.zeros(shape_k, np.float32)
    assert spatial_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), quant=quant,
                             interpret=True) is None
    assert attention.spatial_attention(_t(q), _t(k), _t(k), quant=quant) is None


def test_quant_rows_cols_bit_equal_with_ties():
    """quant_rows / quant_cols bit for bit against psd_tpu, on inputs built
    with exact rounding ties (x/scale = n + 0.5): half to even, as
    jnp.round; half away from zero would differ at every tie."""
    from psd_tpu.ops.quant import quant_cols as jax_quant_cols
    from psd_tpu.ops.quant import quant_rows as jax_quant_rows
    from psd_tpu_torch.ops.quant import quant_cols, quant_rows

    rng = _rng(7)
    x = rng.standard_normal((4, 6, 16)).astype(np.float32)
    x[..., 0] = 127.0  # scale = 1 in every row: x[..., 1:8] are exact ties
    x[..., 1:8] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5], np.float32)
    for jfn, tfn, kw in ((jax_quant_rows, quant_rows, {}),
                         (jax_quant_cols, quant_cols, {"axis": 0}),
                         (jax_quant_cols, quant_cols, {"axis": -1})):
        jq, js = jfn(jnp.asarray(x), **kw)
        tq, ts = tfn(_t(x), **kw)
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert quant_rows(_t(x))[0][0, 0, 1:8].tolist() == [0, 2, 2, 0, -2, -2, 126]


def test_attention_q8_cpu_path_never_builds(monkeypatch):
    """A CPU tensor takes the plain version: no nvcc, no launch counted."""
    from psd_tpu_torch.ops import kernels

    def boom():
        raise AssertionError("kernel library requested for a CPU tensor")

    monkeypatch.setattr(kernels, "library", boom)
    kernels.reset_launch_counts()
    q = torch.randn(1, 256, 2, 40)
    for quant in ("qk8", "int8"):
        assert attention.spatial_attention(q, q, q, quant=quant).shape == q.shape
    assert kernels.launch_counts["attention_q8"] == 0


@pytest.mark.parametrize("quant", ["none", "qk8", "int8"])
def test_spatial_attention_rejects_block_q(quant):
    """psd_tpu's query-tile knob has no meaning for the CUDA kernels, which
    fix their own tile: giving one raises instead of being ignored."""
    q = torch.randn(1, 256, 2, 40)
    with pytest.raises(ValueError, match="block_q"):
        attention.spatial_attention(q, q, q, block_q=256, quant=quant)


def test_chip_smoke_q8_tie_probe_tells_half_even_from_half_away(monkeypatch):
    """chip_smoke.py's tie probe for attention_q8, at a reduced shape: its
    rows hold exact ties pn/ps = k + 1/2 (k even), the plain version rounds
    them half to even, and an output rounded half away from zero would miss
    the probe's band (2^-7·|ref|) on every tie row and on no other."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "Q8_PROBE_SHAPE", (1, 1024, 2, 40))
    ops, shape, scale, n_ties = chip_smoke.q8_tie_probe(torch.device("cpu"))
    assert n_ties >= 20
    ref = attention.attention_q8_reference(*ops, scale, shape, torch.float32)
    qq, sq, kq, sk, vq, sv = ops
    B, S, H, D = shape
    # the one live key's pn/ps and the output pq·ps·(127·sv), as the plain
    # version computes them
    c = float(torch.tensor(attention.LOG2E, dtype=torch.float32))
    sk1 = 1.0 + torch.arange(B * H).float() / 64.0
    p1 = torch.exp2((-1.0 * (sq * c)) * sk1[:, None])
    l_ = 1.0 + p1
    ps = (1.0 / l_) * (1.0 / 127.0)
    ratio = (p1 / l_) / ps

    def out(pq):
        return (pq * 127.0 * ps * sv[:, :1]).reshape(B, H, S).permute(0, 2, 1)

    assert torch.equal(ref[..., :D], out(torch.round(ratio))[..., None].expand(B, S, H, D))
    off = (out(torch.floor(ratio + 0.5)) - ref[..., 0]).abs() > 2.0 ** -7 * ref[..., 0].abs()
    assert int(off.sum()) == n_ties


# ---- the wide-head attention judge (chip_smoke.py, attention_wide.cu) ----------
def _wide_kernel_emulation(q, k, v, fault=None):
    """attention_wide.cu's arithmetic in plain torch, bf16 (B, S, H, D) in and
    out: 32-key tiles, online softmax in log2 units whose denominator sums
    the bf16-rounded p, fp32 accumulators. `fault` plants one of chip_smoke's
    faults: "drop_last_tile" (the last key tile never enters), "skip_rescale"
    (the second consumer's O half, columns 256-511, is not rescaled on the
    last tile), "v_box" (V's 64-column box 5 is loaded from box 4's columns)."""
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))  # (B, H, S, D)
    if fault == "v_box":
        vf = vf.clone()
        vf[..., 320:384] = vf[..., 256:320]
    c = float(np.float32(q.shape[-1] ** -0.5 * attention.LOG2E))
    m = torch.full(qf.shape[:-1], -float("inf"))
    l = torch.zeros(qf.shape[:-1])
    o = torch.zeros(qf.shape)
    starts = list(range(0, kf.shape[2], 32))
    if fault == "drop_last_tile":
        starts = starts[:-1]
    for k0 in starts:
        s = qf @ kf[:, :, k0:k0 + 32].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1) * c)
        corr = torch.exp2(m - m_new)[..., None].expand(o.shape).clone()
        p = torch.exp2(s * c - m_new[..., None]).bfloat16().float()
        l = l * corr[..., 0] + p.sum(-1)
        if fault == "skip_rescale" and k0 == starts[-1]:
            corr[..., 256:] = 1.0
        o = o * corr + p @ vf[:, :, k0:k0 + 32]
        m = m_new
    return (o / l[..., None]).permute(0, 2, 1, 3).bfloat16()


@pytest.mark.parametrize("fault", [None, "drop_last_tile", "skip_rescale", "v_box"])
def test_wide_attention_judge_sees_planted_faults(fault):
    """chip_smoke.py holds the D=512 attention kernel to `attention_reference`
    with `attention_judge` (relative L2 ≤ 1e-2 over the output, ≤ 2e-2
    on the worst query row). At (1, 1024, 1, 512), N(0,1) bf16 inputs, the
    kernel's arithmetic emulated in plain torch reads (relative L2 / worst
    row; then the max abs error against the old band 1e-2 + 1e-2·max|ref| =
    1.30e-2):
      sound            3.03e-3 / 4.06e-3; 1.95e-3, passes both;
      drop_last_tile   1.81e-1 / 6.19e-1; 1.43e-1, fails both;
      skip_rescale     5.71e-2 / 6.82e-1; 1.57e-1, fails both;
      v_box            5.00e-1 / 6.33e-1; 4.38e-1, fails both.
    (At S = 1024 one tile is 1/32 of the keys; PERF.md §6 gives the
    readings of the same faults planted in the kernel, on the card at
    S = 4096.)
    The judge passes the sound emulation and fails each fault."""
    from psd_tpu_torch.testing import attention_judge

    rng = _rng(512)
    q, k, v = (_t(rng.standard_normal((1, 1024, 1, 512)).astype(np.float32)).bfloat16()
               for _ in range(3))
    ref = attention.attention_reference(q, k, v)
    ok, text, readings = attention_judge(_wide_kernel_emulation(q, k, v, fault), ref)
    assert ok == (fault is None), text


# ---- the narrow-head attention (attention_narrow.cu): admission and judge ----
@pytest.mark.parametrize("training", [False, True])
def test_fwd_shape_error_admits_every_routed_shape(training):
    """Every shape kernel_route sends to a kernel at D = 8..160 and
    S = 512..4096 (steps of 128) is one the forward kernels take."""
    from types import SimpleNamespace

    routed = 0
    for D in range(8, 161, 8):
        for Sq in range(512, 4097, 128):
            for Sk in range(512, 4097, 128):
                q = SimpleNamespace(shape=(2, Sq, 8, D))
                k = SimpleNamespace(shape=(2, Sk, 8, D))
                if attention.kernel_route(q, k, training) is not None:
                    routed += 1
                    assert attention.fwd_shape_error(Sq, Sk, D) is None, (Sq, Sk, D)
    assert routed == 20 * 29 * 29  # every Sq, Sk pair takes the flash role


@pytest.mark.parametrize("Sq,Sk,D,admitted", [
    (128, 128, 40, True), (512, 1536, 80, True), (256, 384, 160, True),
    (64, 128, 40, False),    # the narrow kernel's blocks hold 128 query rows
    (128, 192, 80, False),   # and its key tiles 128 keys
    (128, 128, 36, False),   # D % 8
    (64, 64, 512, True), (64, 32, 512, False), (64, 64, 520, False),
])
def test_fwd_shape_error_refuses_what_the_kernels_do_not_take(Sq, Sk, D, admitted):
    assert (attention.fwd_shape_error(Sq, Sk, D) is None) == admitted


def _narrow_kernel_emulation(q, k, v, fault=None):
    """attention_narrow.cu's arithmetic in plain torch, bf16 (B, S, H, D) in
    and out: 128-key tiles, online softmax in log2 units whose denominator
    sums the bf16-rounded p, fp32 accumulators; each block's query rows
    64..127 belong to the second consumer warpgroup. `fault` plants one of
    chip_smoke's faults: "drop_last_tile" (the last key tile never enters),
    "skip_rescale" (the second warpgroup's O is not rescaled on the last
    tile), "neighbour_pad" (q and k padded to Dp = ceil16(D) with head h+1's
    first columns, as a 2-D (rows, H·D) tensor map would fill them; zeros
    for the last head)."""
    B, S, H, D = q.shape
    Dp = (D + 15) // 16 * 16
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))  # (B, H, S, D)
    if fault == "neighbour_pad":
        def pad(t):
            nb = torch.zeros_like(t[..., :Dp - D])
            nb[:, :-1] = t[:, 1:, :, :Dp - D]
            return torch.cat([t, nb], -1)
        qf, kf = pad(qf), pad(kf)
    c = float(np.float32(D ** -0.5 * attention.LOG2E))
    m = torch.full(qf.shape[:-1], -float("inf"))
    l = torch.zeros(qf.shape[:-1])
    o = torch.zeros(vf.shape)
    wg1 = torch.arange(S) % 128 >= 64
    starts = list(range(0, S, 128))
    if fault == "drop_last_tile":
        starts = starts[:-1]
    for k0 in starts:
        s = qf @ kf[:, :, k0:k0 + 128].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1) * c)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s * c - m_new[..., None]).bfloat16().float()
        l = l * corr + p.sum(-1)
        if fault == "skip_rescale" and k0 == starts[-1]:
            corr = torch.where(wg1, torch.ones_like(corr), corr)
        o = o * corr[..., None] + p @ vf[:, :, k0:k0 + 128]
        m = m_new
    return (o / l[..., None]).permute(0, 2, 1, 3).bfloat16()


@pytest.mark.parametrize("D", [40, 80])
@pytest.mark.parametrize("fault", [None, "drop_last_tile", "skip_rescale", "neighbour_pad"])
def test_narrow_attention_judge_sees_planted_faults(fault, D):
    """chip_smoke.py holds the D=40/80 attention kernel to
    `attention_reference` with `attention_judge` (relative L2 ≤ 1e-2
    over the output, ≤ 2e-2 on the worst query row). At (1, 1024, 2, D),
    N(0,1) bf16 inputs, the kernel's arithmetic emulated in plain torch
    reads (relative L2 / worst row at D = 40; D = 80):
      sound            2.98e-3 / 5.41e-3;  3.07e-3 / 4.67e-3, passes;
      drop_last_tile   3.60e-1 / 8.51e-1;  4.02e-1 / 9.16e-1, fails;
      skip_rescale     1.28e-1 / 1.69;     1.42e-1 / 2.17, fails;
      neighbour_pad    3.11e-1 / 1.31;     the sound output bit for bit.
    At D = 80, Dp = D: S reads no padding column, so a 2-D map's neighbour
    columns never enter and the judge rightly passes. (PERF.md §6 PR 6
    gives the readings of the same faults planted in the kernel, on the
    card.)"""
    from psd_tpu_torch.testing import attention_judge

    rng = _rng(D)
    q, k, v = (_t(rng.standard_normal((1, 1024, 2, D)).astype(np.float32)).bfloat16()
               for _ in range(3))
    ref = attention.attention_reference(q, k, v)
    out = _narrow_kernel_emulation(q, k, v, fault)
    ok, text, _ = attention_judge(out, ref)
    blind = fault == "neighbour_pad" and D % 16 == 0
    if blind:
        assert torch.equal(out, _narrow_kernel_emulation(q, k, v))
    assert ok == (fault is None or blind), text


# ---- the attention backward (attention_bwd.cu): admission and judge ----------
@pytest.mark.parametrize("training", [False, True])
def test_bwd_shape_error_admits_every_routed_shape(training):
    """Every shape kernel_route sends to a kernel at D = 8..160 and
    S = 512..4096 (steps of 128) is one the backward kernels take: the
    FlashAttention autograd.Function runs the backward wherever a routed
    shape needs gradients."""
    from types import SimpleNamespace

    routed = 0
    for D in range(8, 161, 8):
        for Sq in range(512, 4097, 128):
            for Sk in range(512, 4097, 128):
                q = SimpleNamespace(shape=(2, Sq, 8, D))
                k = SimpleNamespace(shape=(2, Sk, 8, D))
                if attention.kernel_route(q, k, training) is not None:
                    routed += 1
                    assert attention.bwd_shape_error(Sq, Sk, D) is None, (Sq, Sk, D)
    assert routed == 20 * 29 * 29


@pytest.mark.parametrize("Sq,Sk,D,admitted", [
    (128, 128, 40, True), (512, 1536, 80, True), (256, 384, 160, True), (1024, 1024, 104, True),
    (64, 128, 40, False),    # the dQ pass's blocks hold 128 query rows
    (128, 192, 80, False),   # and the dK/dV pass's 128 key rows
    (128, 128, 36, False),   # D % 8
    (128, 128, 168, False),  # Dp <= 160
    (512, 512, 512, False),  # the VAE's head width has no backward kernel
])
def test_bwd_shape_error_refuses_what_the_kernels_do_not_take(Sq, Sk, D, admitted):
    assert (attention.bwd_shape_error(Sq, Sk, D) is None) == admitted


def _bwd_kernel_emulation(q, k, v, dout, fault=None):
    """attention_bwd.cu's arithmetic in plain torch, bf16 (B, S, H, D) in
    and out: P = 2^(S·scale·log2e − lse) from the forward's lse, Δ from its
    bf16 output, dS = P∘(dP − Δ) in fp32, P and dS rounded to bf16 before
    the dV, dK and dQ products, fp32 accumulators. `fault` plants one of
    chip_smoke's faults: "dkv_drop_last_tile" (the dK/dV pass skips its last
    tile of 64 queries), "dq_drop_last_tile" (the dQ pass skips its last
    tile of 128 keys), "lse_offset" (lse + 0.02 in both passes),
    "neighbour_pad" (q, k, v, dO padded to Dp = ceil16(D) with head h+1's
    first columns, as 2-D (rows, H·D) tensor maps would fill them; zeros for
    the last head)."""
    B, S, H, D = q.shape
    Dp = (D + 15) // 16 * 16
    scale = D ** -0.5
    c = float(np.float32(scale * attention.LOG2E))
    out, lse = attention.attention_fwd(q, k, v, return_lse=True)
    if fault == "lse_offset":
        lse = lse + 0.02
    qf, kf, vf, of, gf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v, out, dout))
    delta = (gf * of).sum(-1)
    ops = [qf, kf, vf, gf]
    if fault == "neighbour_pad":
        def pad(t):
            nb = torch.zeros_like(t[..., :Dp - D])
            nb[:, :-1] = t[:, 1:, :, :Dp - D]
            return torch.cat([t, nb], -1)
        ops = [pad(t) for t in ops]
    qs, ks, vs, gs = ops
    p = torch.exp2((qs @ ks.transpose(-1, -2)) * c - lse[..., None])
    ds = (p * (gs @ vs.transpose(-1, -2) - delta[..., None])).bfloat16().float()
    p = p.bfloat16().float()
    ds_kv, p_kv, ds_q = ds.clone(), p.clone(), ds.clone()
    if fault == "dkv_drop_last_tile":  # the dK/dV pass's tiles are 64 queries
        ds_kv[..., -64:, :] = 0
        p_kv[..., -64:, :] = 0
    if fault == "dq_drop_last_tile":   # the dQ pass's tiles are 128 keys at Dp <= 80
        ds_q[..., -128:] = 0
    grads = (scale * ds_q @ kf, scale * ds_kv.transpose(-1, -2) @ qf,
             p_kv.transpose(-1, -2) @ gf)
    return tuple(t.permute(0, 2, 1, 3).bfloat16() for t in grads)


@pytest.mark.parametrize("D", [40, 80])
@pytest.mark.parametrize("fault", [None, "dkv_drop_last_tile", "dq_drop_last_tile",
                                   "lse_offset", "neighbour_pad"])
def test_attention_bwd_judge_sees_planted_faults(fault, D):
    """chip_smoke.py holds the attention backward to
    `attention_bwd_reference` with `attention_bwd_judge` (each of dQ, dK,
    dV: relative L2 ≤ 8e-3 over the gradient, ≤ 2e-2 on its worst row). At
    (1, 1024, 2, D), N(0,1) bf16 inputs, the kernel's arithmetic emulated in
    plain torch reads (relative L2 / worst row of dQ, dK, dV at D = 40):
      sound               3.3e-3 / 6.5e-3, 3.2e-3 / 5.8e-3, 1.3e-4 / 2.3e-3, passes;
      dkv_drop_last_tile  dK 0.24 / 0.88, dV 0.26 / 0.61, fails;
      dq_drop_last_tile   dQ 0.36 / 0.93, fails;
      lse_offset          1.4e-2 / 1.7e-2..1.9e-2 on each, fails;
      neighbour_pad       0.39..0.58 / 2.5..4.1, fails; at D = 80 the
                          sound gradients bit for bit (Dp = D: no padding
                          column is read), and the judge rightly passes.
    (PERF.md §6 PR 7 gives the readings of the same faults planted in the
    kernel, on the card.)"""
    from psd_tpu_torch.testing import attention_bwd_judge

    rng = _rng(100 + D)
    q, k, v, g = (_t(rng.standard_normal((1, 1024, 2, D)).astype(np.float32)).bfloat16()
                  for _ in range(4))
    refs = attention.attention_bwd_reference(q, k, v, g)
    grads = _bwd_kernel_emulation(q, k, v, g, fault)
    ok, text, _ = attention_bwd_judge(grads, refs)
    blind = fault == "neighbour_pad" and D % 16 == 0
    if blind:
        assert all(torch.equal(a, b) for a, b in zip(grads, _bwd_kernel_emulation(q, k, v, g)))
    assert ok == (fault is None or blind), text


# ---- the LayerNorm-fused GEMMs (ln_gemm_sm90.cuh): admission, judge, edges ----
@pytest.mark.parametrize("kind", ["ln_proj", "ln_geglu"])
def test_ln_shape_error_admits_every_routed_shape(kind):
    """Every (B, S, C) that `ln_fused_ok` sends to the fused LayerNorm
    kernels (B·S = 64..8192 in steps of 64, C = 32..4096 in steps of 32)
    is one they take: N = C for the projections, N = 4C for GEGLU. The
    gate routes every B·S % 128, C % 64 (half of each range)."""
    from types import SimpleNamespace

    from psd_tpu_torch.models.layers import ln_fused_ok

    routed = 0
    for M in range(64, 8193, 64):
        for C in range(32, 4097, 32):
            if ln_fused_ok(SimpleNamespace(shape=(1, M, C))):
                routed += 1
                N = C if kind == "ln_proj" else 4 * C
                assert geglu.ln_shape_error(M, C, N) is None, (M, C, N)
    assert routed == 64 * 64


@pytest.mark.parametrize("M,C,N,admitted", [
    (32768, 320, 320, True), (512, 1280, 5120, True), (128, 64, 8, True), (1024, 192, 200, True),
    (64, 320, 320, False),    # the kernels' tiles hold 128 rows
    (512, 96, 96, False),     # and their K chunks 64 columns (one TMA box)
    (512, 320, 300, False),   # 16-byte rows for TMA and the bf16x2 stores
    (0, 64, 64, False), (512, 0, 64, False), (512, 64, 0, False),
])
def test_ln_shape_error_refuses_what_the_kernels_do_not_take(M, C, N, admitted):
    assert (geglu.ln_shape_error(M, C, N) is None) == admitted


def _ln_gemm_kernel_emulation(x, lw, lb, ws, b0=None, fault=None):
    """ln_gemm_sm90.cuh's arithmetic in plain torch: per-row fp32 statistics
    (fast variance), x̂ = (x − μ)·rstd·lw + lb in fp32 rounded to bf16, the
    products in fp32 over 64-column K chunks, bf16 outputs; with `b0`, W0 =
    ws[0] and the GEGLU epilogue (fp32 bias, h·gelu(g), 128-column tiles).
    `fault` plants one of chip_smoke's faults: "drop_last_chunk" (the last
    K chunk never enters), "neighbour_stats" (row r takes row r+1's μ and
    rstd), "neighbour_affine" (K chunk k takes chunk k+1's lw and lb),
    "gate_shift" (GEGLU's h column j gated by g column j+8 of its tile)."""
    xf = x.float()
    M, C = xf.shape
    mu = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0) + 1e-5)
    if fault == "neighbour_stats":
        mu, rstd = mu.roll(-1, 0), rstd.roll(-1, 0)
    if fault == "neighbour_affine":
        lw, lb = lw.reshape(-1, 64).roll(-1, 0).reshape(-1), lb.reshape(-1, 64).roll(-1, 0).reshape(-1)
    xn = ((xf - mu) * rstd * lw + lb).bfloat16().float()
    if fault == "drop_last_chunk":
        xn[:, -64:] = 0
    outs = tuple(xn @ w.float().T for w in ws)
    if b0 is None:
        return tuple(o.bfloat16() for o in outs)
    h, g = (outs[0] + b0).chunk(2, dim=-1)
    if fault == "gate_shift":
        g = g.reshape(M, -1, 128).roll(-8, -1).reshape(M, -1)
    return (h * geglu.gelu_exact(g)).bfloat16()


@pytest.mark.parametrize("kind,fault", [
    (kind, fault) for kind in ("ln_proj", "ln_geglu")
    for fault in (None, "drop_last_chunk", "neighbour_stats", "neighbour_affine")
] + [("ln_geglu", "gate_shift")])
def test_ln_gemm_judge_sees_planted_faults(kind, fault):
    """chip_smoke.py holds ln_proj and ln_geglu to their plain versions with
    `ln_gemm_judge` (relative L2 ≤ LN_REL_L2_BAND over each output, ≤
    LN_ROW_BAND on its worst row). At (M, C) = (512, 320), N(0,1) bf16 x,
    the SD-scale weights' spread, the kernel's arithmetic emulated in plain
    torch reads (relative L2 / worst row; the worst of ln_proj's three
    outputs, then ln_geglu):
      sound              2.9e-5 / 4.6e-4;  3.5e-3 / 4.6e-3, passes (the plain
                         GEGLU rounds h and g to bf16 before the gate, the
                         kernel keeps them in fp32);
      drop_last_chunk    0.44 / 0.59;      0.60 / 0.76, fails;
      neighbour_stats    0.096 / 0.24;     0.17 / 0.48, fails;
      neighbour_affine   0.18 / 0.22;      0.26 / 0.34, fails;
      gate_shift         (ln_geglu)        1.27 / 1.46, fails.
    (PERF.md §6 gives the readings of the same faults planted in the
    kernels, on the card.)"""
    from psd_tpu_torch.testing import ln_gemm_judge

    rng = _rng(808)
    M, C = 512, 320
    x = _t(rng.standard_normal((M, C)).astype(np.float32)).bfloat16()
    lw = _t((1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32))
    lb = _t((0.1 * rng.standard_normal(C)).astype(np.float32))
    if kind == "ln_proj":
        ws = tuple(_t((rng.standard_normal((C, C)) / np.sqrt(C)).astype(np.float32)).bfloat16()
                   for _ in range(3))
        ref = geglu.ln_proj_reference(x, lw, lb, ws)
        out = _ln_gemm_kernel_emulation(x, lw, lb, ws, fault=fault)
    else:
        w0 = _t((rng.standard_normal((8 * C, C)) / np.sqrt(C)).astype(np.float32)).bfloat16()
        b0 = _t((0.02 * rng.standard_normal(8 * C)).astype(np.float32))
        ref = geglu.ln_geglu_reference(x, lw, lb, w0, b0)
        out = _ln_gemm_kernel_emulation(x, lw, lb, (w0,), b0=b0, fault=fault)
    ok, text, _ = ln_gemm_judge(out, ref)
    assert ok == (fault is None), text


def _large_mean_inputs(seed, M=512, C=64):
    """x with a per-row offset of std 8 (rows of large mean: E[x²] − μ²
    cancels to 1 part in up to ≈ 10³ in fp32)."""
    rng = _rng(seed)
    x = (rng.standard_normal((M, C)) + 8.0 * rng.standard_normal((M, 1))).astype(np.float32)
    s = (1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    return x, s, b


@pytest.mark.parametrize("n_out", [1, 3])
def test_ln_proj_matches_pallas_interpret_on_large_mean_rows(n_out):
    """The plain version the kernels are held to, against psd_tpu's Pallas
    kernel in interpret mode on rows of large mean. Tolerance rtol = atol =
    1e-3: both take the fast variance in fp32 and sum in other orders, and
    the cancellation of E[x²] − μ² (μ² up to 1035 times the variance here)
    leaves each side's x̂ up to 1.8e-4 from its fp64 value and the two
    2.8e-4 apart; the outputs (up to ≈ 4) then differ by up to 2.8e-4."""
    x, s, b = _large_mean_inputs(30 + n_out)
    rng = _rng(40 + n_out)
    ws = [(rng.standard_normal((64, 64)) / 8.0).astype(np.float32) for _ in range(n_out)]
    ref = jax_ln_proj(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                      tuple(jnp.asarray(w) for w in ws), 1e-5, 256, True)
    outs = geglu.ln_proj_reference(_t(x), _t(s), _t(b), tuple(_t(w.T.copy()) for w in ws))
    for o, r in zip(outs, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-3, atol=1e-3)


def test_ln_geglu_matches_pallas_interpret_on_large_mean_rows():
    """As above for GEGLU (rtol = atol = 1e-3): h·gelu(g) of two sums that
    each carry x̂'s cancellation error reads up to 8.5e-4 apart on outputs up
    to ≈ 9 (2.3e-5 relative L2); the A&S erf polynomial's 1.5e-7 is far
    below."""
    x, s, b = _large_mean_inputs(37)
    rng = _rng(47)
    w0 = (rng.standard_normal((64, 512)) / 8.0).astype(np.float32)
    b0 = (0.1 * rng.standard_normal(512)).astype(np.float32)
    ref = np.asarray(jax_ln_geglu(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                                  jnp.asarray(w0), jnp.asarray(b0), 1e-5, 256, True))
    out = geglu.ln_geglu_reference(_t(x), _t(s), _t(b), _t(w0.T.copy()), _t(b0)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-3)


# ---- gn_proj (ln_gemm_sm90.cuh, Kind::kGn): admission and judge ---------------
def test_gn_shape_error_admits_every_routed_shape():
    """Every (B, S, C) that `Transformer2D` sends to gn_proj (`gn_proj_ok`:
    S % 64 == 0, C % 64 == 0, any B; N = C) is one the kernel takes,
    B·S % 128 == 64 (a half-full last row tile) included."""
    from psd_tpu_torch.models.layers import gn_proj_ok

    routed = ragged = 0
    for B in range(1, 9):
        for S in range(64, 4097, 64):
            for C in range(32, 1313, 32):
                if gn_proj_ok(S, C):
                    routed += 1
                    ragged += (B * S) % 128 == 64
                    assert gnproj.gn_shape_error(B, S, C, C) is None, (B, S, C)
    assert routed == 8 * 64 * 20 and ragged == 4 * 32 * 20


@pytest.mark.parametrize("B,S,C,N,admitted", [
    (8, 4096, 320, 320, True), (8, 64, 1280, 1280, True),
    (3, 64, 1280, 1280, True),   # B·S % 128 == 64: a half-full last row tile
    (3, 192, 640, 640, True),    # the same with S % 128 == 64, S > 128
    (3, 64, 320, 200, True),     # N not a multiple of the kernel's 192-column tile
    (8, 96, 320, 320, False),    # S % 64: a row tile could span three batch elements
    (8, 64, 96, 96, False),      # C % 64: the kernel's K chunks are 64 columns
    (8, 64, 320, 300, False),    # N % 8: 16-byte output rows for TMA
    (0, 64, 64, 64, False), (8, 0, 64, 64, False), (8, 64, 0, 64, False), (8, 64, 64, 0, False),
])
def test_gn_shape_error_refuses_what_the_kernel_does_not_take(B, S, C, N, admitted):
    assert (gnproj.gn_shape_error(B, S, C, N) is None) == admitted


def _gn_proj_kernel_emulation(x, w, b, weight, bias, fault=None):
    """gn_proj's kernel arithmetic in plain torch: x̂ = bf16(x·w[b] + b[b])
    (a product, then a sum, in fp32), fp32 products, the fp32 bias added
    before one rounding to bf16. `fault` plants one of the faults the bands
    were set against: "neighbour_slot" (rows take the other batch slot of
    their 128-row tile: element b ^ 1, the last element its own where B is
    odd and S = 64), "drop_last_chunk" (the last 64-column K chunk never
    enters), "drop_bias", "ragged_unwritten" (the half-full last row
    tile's 64 rows left at zero)."""
    B, S, C = x.shape
    bidx = torch.arange(B)
    if fault == "neighbour_slot":
        bidx = torch.clamp(bidx ^ 1, max=B - 1)
    xa = (x.float() * w[bidx][:, None, :] + b[bidx][:, None, :]).bfloat16().float()
    if fault == "drop_last_chunk":
        xa[..., -64:] = 0
    out = xa.reshape(B * S, C) @ weight.float().T
    if fault != "drop_bias":
        out = out + bias
    out = out.bfloat16()
    if fault == "ragged_unwritten" and (B * S) % 128 == 64:
        out[B * S - 64:] = 0
    return out.reshape(B, S, -1)


@pytest.mark.parametrize("fault", [None, "neighbour_slot", "drop_last_chunk", "drop_bias",
                                   "ragged_unwritten"])
@pytest.mark.parametrize("large_shift", [False, True])
def test_gn_proj_judge_sees_planted_faults(fault, large_shift):
    """chip_smoke.py holds gn_proj to its plain version with
    `gn_proj_judge` (relative L2 ≤ GN_REL_L2_BAND over the output, ≤
    GN_ROW_BAND on its worst row). At (B, S, C) = (3, 64, 320), where every
    row tile but the last straddles two batch elements and the last is half
    full, N(0,1) bf16 x, affines w = 1 + 0.1·N(0,1), b = 0.1·N(0,1) (or, with
    `large_shift`, folded by group_norm_fold from channels of mean std 8)
    and a bias of std 0.02, the kernel's arithmetic emulated in plain torch
    reads ≤ 2.93e-3 / ≤ 3.67e-3 sound; the faults ≥ 1.91e-2 / ≥ 2.01e-2,
    the dropped bias the least. (PERF.md §6 gives the readings of the same
    faults planted in the kernel, on the card.)"""
    from psd_tpu_torch.testing import gn_proj_judge

    rng = _rng(909 + large_shift)
    B, S, C = 3, 64, 320
    xf = rng.standard_normal((B, S, C)).astype(np.float32)
    if large_shift:
        xf = xf + 8.0 * rng.standard_normal((B, 1, C)).astype(np.float32)
        x = _t(xf).bfloat16()
        w, b = group_norm_fold(x.float(), _t((1 + 0.1 * rng.standard_normal(C)).astype(np.float32)),
                               _t((0.1 * rng.standard_normal(C)).astype(np.float32)), 32, 1e-6)
    else:
        x = _t(xf).bfloat16()
        w = _t((1 + 0.1 * rng.standard_normal((B, C))).astype(np.float32))
        b = _t((0.1 * rng.standard_normal((B, C))).astype(np.float32))
    weight = _t((rng.standard_normal((C, C)) / np.sqrt(C)).astype(np.float32)).bfloat16()
    bias = _t((0.02 * rng.standard_normal(C)).astype(np.float32))
    ref = gnproj.gn_proj_reference(x, w, b, weight, bias)
    ok, text, _ = gn_proj_judge(_gn_proj_kernel_emulation(x, w, b, weight, bias, fault), ref)
    assert ok == (fault is None), text


# ---- split3 (csrc/split3.cu): admission, plan, judge ----------------------------
def test_split3_shape_error_admits_every_routed_shape():
    """Every q the UNet sends to split3 (`split3_kernel_ok`: S ≥ 256,
    S % 128 == 0; 8 heads of C/8 at C = 320, 640, 1280; banks of 1..16
    tokens) is one the kernel takes, serving's and training's batches."""
    from psd_tpu_torch.models.layers import split3_kernel_ok

    routed = 0
    for S in range(64, 4097, 64):
        for D in (40, 80, 160):
            for B in (1, 3, 8, 64):
                for lens in ((16, 16, 16), (1, 4, 15), (4, 16, 7)):
                    if not split3_kernel_ok(B, S, 8, D, lens):
                        continue
                    routed += 1
                    assert split3.split3_shape_error(B, S, 8, D, lens) is None, (B, S, D, lens)
    assert routed == 31 * 3 * 4 * 3


@pytest.mark.parametrize("B,S,H,D,lens,admitted", [
    (8, 4096, 8, 40, (16, 16, 16), True), (1, 384, 3, 24, (1, 4, 15), True),
    (3, 256, 1, 160, (16, 4, 15), True), (3, 384, 3, 160, (4, 15, 1), True),
    (8, 64, 8, 40, (16, 16, 16), True),     # S % 64 == 0 is enough for the kernel
    (8, 4096, 8, 40, (0, 16, 16), False),   # a bank needs a token
    (8, 4096, 8, 40, (16, 17, 16), False),  # and holds at most 16 (one 16-key slice)
    (8, 4096, 8, 44, (16, 16, 16), False),  # 16-byte head slices
    (8, 4096, 8, 16, (16, 16, 16), False),  # head dims 24..160
    (8, 4096, 8, 168, (16, 16, 16), False),
    (8, 4032, 8, 40, (16, 16, 16), True), (8, 4000, 8, 40, (16, 16, 16), False),
    (8, 4096, 8, 152, (16, 16, 16), False),  # no head group's banks fit beside the ring
])
def test_split3_shape_error_refuses_what_the_kernel_does_not_take(B, S, H, D, lens, admitted):
    assert (split3.split3_shape_error(B, S, H, D, lens) is None) == admitted


@pytest.mark.parametrize("H,D,rows,plan", [
    (8, 40, 8 * 4096, (64, 8, 4, 1)),   # whole rows, four items a block
    (8, 80, 8 * 1024, (32, 4, 2, 2)),   # fewer than two items a block: two blocks an SM
    (8, 160, 8 * 256, (64, 2, 4, 1)),   # D > 80: one block an SM
    (8, 40, 64 * 1024, (64, 8, 4, 1)), (8, 80, 64 * 256, (64, 4, 4, 1)),  # training
    (3, 160, 384, (64, 3, 2, 1)),       # G = H, whose last box runs past H·D
])
def test_split3_plan_fits_and_follows_the_rows(H, D, rows, plan):
    """split3_plan on an H100's 132 SMs: the plan, a group G whose TMA boxes
    cover it exactly (or all H heads), and shared memory within what one or
    two blocks an SM may take."""
    got = split3.split3_plan(H, D, rows, 132)
    assert got == plan
    R, G, stages, blocks = got
    assert H % G == 0 and (G == H or G * D % 64 == 0) and rows % R == 0
    limit = split3.SPLIT3_SMEM_MAX if blocks == 1 else split3.SPLIT3_SMEM_MAX_2
    assert split3._split3_smem(R, G, stages, D) <= limit


def _split3_kernel_emulation(q, banks, delta, anat_gate, dis_gate, fault=None):
    """split3's kernel arithmetic in plain torch: fp32 logits, an exact
    softmax per bank in exp2 form, p·gate/sum rounded to bf16, the three
    products summed in fp32, one rounding to bf16. `fault` plants one of the
    faults the bands were set against: "mask_last_key" (the disease bank's
    last valid key masked), "pad_key_in" (the delta bank, where shorter
    than 16, lets one zero padding key in), "delta_on_anat" (δ gates the anatomy bank),
    "neighbour_head_q" (each head takes the next head's q), "skip_group"
    (rows 48..63 of every 64 of the last head left as q)."""
    B, S, H, D = q.shape
    gates = [anat_gate, dis_gate, delta]
    if fault == "delta_on_anat":
        gates[0] = delta
    qf = q.float().roll(-1, dims=2) if fault == "neighbour_head_q" else q.float()
    out = torch.zeros(B, S, H, D)
    for i in range(3):
        k, v = banks[2 * i].float(), banks[2 * i + 1].float()
        if fault == "mask_last_key" and i == 1:
            k, v = k[:, :-1], v[:, :-1]
        if fault == "pad_key_in" and i == 2 and k.shape[1] < 16:
            k = torch.cat([k, torch.zeros(B, 1, H, D)], 1)
            v = torch.cat([v, torch.zeros(B, 1, H, D)], 1)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k) * (D ** -0.5 * 1.4426950408889634)
        p = torch.exp2(s - s.amax(-1, keepdim=True))
        p = (p * (gates[i] / p.sum(-1, keepdim=True))).bfloat16().float()
        out += torch.einsum("bhqk,bkhd->bqhd", p, v)
    out = out.bfloat16()
    if fault == "skip_group":
        rows = torch.arange(S) % 64 >= 48
        out[:, rows, H - 1] = q[:, rows, H - 1]
    return out


@pytest.mark.parametrize("fault", [None, "mask_last_key", "pad_key_in", "delta_on_anat",
                                   "neighbour_head_q", "skip_group"])
@pytest.mark.parametrize("shape,lens,delta", [
    ((2, 256, 8, 40), (16, 16, 16), 1.0),
    ((2, 384, 8, 80), (4, 16, 7), -1.5),
    ((1, 384, 3, 24), (1, 4, 15), 0.0),
    ((2, 128, 2, 160), (15, 4, 1), 1.0),
])
def test_split3_judge_sees_planted_faults(fault, shape, lens, delta):
    """chip_smoke.py holds split3 to its plain version with `split3_judge`
    (relative L2 ≤ SPLIT3_REL_L2_BAND over the output, ≤ SPLIT3_ROW_BAND on
    its worst query row). With N(0,1) bf16 inputs and gates 0.1 (anatomy)
    and 0.9 (disease), the kernel's arithmetic emulated in plain torch reads
    ≤ 4.24e-3 / ≤ 8.21e-3 sound; every fault that changes the output reads ≥
    8.7e-2 / ≥ 0.256 (a padded key let in changes only a short delta bank
    gated by δ ≠ 0). (PERF.md §6 gives the readings of the same faults planted in the
    kernel, on the card.)"""
    from psd_tpu_torch.testing import split3_judge

    rng = _rng(303 + sum(shape) + sum(lens))
    B, S, H, D = shape
    q = _t(rng.standard_normal(shape).astype(np.float32)).bfloat16()
    banks = [_t(rng.standard_normal((B, n, H, D)).astype(np.float32)).bfloat16()
             for n in lens for _ in range(2)]
    ref = split3.split3_reference(q, *banks, delta, 0.1, 0.9)
    out = _split3_kernel_emulation(q, banks, delta, 0.1, 0.9, fault)
    ok, text, _ = split3_judge(out, ref)
    changes = not (fault == "pad_key_in" and (lens[2] == 16 or delta == 0.0))
    assert ok == (fault is None or not changes), text


# ---- the int8 attention (csrc/attention_q8.cu): admission, layout, arithmetic ----
def test_q8_shape_error_admits_every_routed_shape():
    """Every attention spatial_attention routes (S % 256 == 0, S ≤ 4096,
    D ≤ 256) whose head dim is a multiple of 8 is one the int8 kernel
    takes; every D % 8 != 0 it routes is refused (no model routes one)."""
    routed = refused = 0
    for D in range(1, 265):
        for S in range(128, 4353, 128):
            if not attention.spatial_attention_routes(S, S, D):
                continue
            if D % 8:
                refused += 1
                assert attention.q8_shape_error(S, D) is not None, (S, D)
            else:
                routed += 1
                assert attention.q8_shape_error(S, D) is None, (S, D)
    assert routed == 32 * 16 and refused == (256 - 32) * 16


@pytest.mark.parametrize("S,D,admitted", [
    (4096, 40, True), (1024, 80, True), (256, 160, True), (768, 256, True), (256, 24, True),
    (256, 44, False),    # D % 8: TMA's 16-byte strides for v
    (256, 264, False),   # D > 256
    (256, 0, False),
    (320, 40, False),    # S % 256
    (384, 40, False),
    (4352, 40, False),   # S > 4096
    (0, 40, False),
])
def test_q8_shape_error_refuses_what_the_kernel_does_not_take(S, D, admitted):
    assert (attention.q8_shape_error(S, D) is None) == admitted


def test_q8_key_placement_round_trips_and_matches_the_a_fragment():
    """q8_place_keys puts key 2·t + {0, 1, 8, 9}[e] (+16) at position
    4·t + e (+16) of each 32-key chunk, where the kernel's s8 A fragment of
    lane t takes it; q8_unplace_keys undoes it; q8_key_position agrees."""
    x = torch.arange(3 * 96).reshape(3, 96)
    placed = attention.q8_place_keys(x)
    assert torch.equal(attention.q8_unplace_keys(placed), x)
    keys = torch.arange(96)
    assert torch.equal(placed[:, attention.q8_key_position(keys)], x)
    for chunk in range(3):
        for hi in (0, 1):
            for t in range(4):
                for e in range(4):
                    key = 32 * chunk + 16 * hi + 2 * t + (0, 1, 8, 9)[e]
                    assert placed[0, 32 * chunk + 16 * hi + 4 * t + e] == key
    assert attention.q8_key_position(37) == int(attention.q8_key_position(torch.tensor(37)))


def test_q8_rint_rewrite_and_int_conversion_are_exact():
    """The kernel's rounding of pn/ps (the low byte of y + 1.5·2²³) against
    round half to even over every fp32 y in [2⁻³, 128) and the values
    below; and its int32 → fp32 of the QKᵀ sums exact (|acc| ≤ 127²·256,
    the most a Dp ≤ 256 product reaches, below 2²⁴), as is the add trick
    (the bits of acc + 0x4B400000, less 1.5·2²³) measured against it."""
    acc = np.arange(-127 * 127 * 256, 127 * 127 * 256 + 1, dtype=np.int32)
    np.testing.assert_array_equal(acc.astype(np.float32).astype(np.int64), acc)
    conv = (acc + np.int32(0x4B400000)).view(np.float32) - np.float32(12582912.0)
    np.testing.assert_array_equal(conv, acc.astype(np.float32))
    magic = np.float32(12582912.0)
    for e in range(-3, 7):  # each binade [2^e, 2^(e+1)) in full
        lo = np.float32(2.0 ** e).view(np.uint32)
        y = np.arange(lo, lo + (1 << 23), dtype=np.uint32).view(np.float32)
        got = (y + magic).view(np.uint32) & 0xFF
        np.testing.assert_array_equal(got, np.rint(y).astype(np.uint32))
    small = np.concatenate([np.float32([0.0, 0.5]),
                            np.linspace(0, 0.125, 100001, dtype=np.float32)])
    np.testing.assert_array_equal((small + magic).view(np.uint32) & 0xFF,
                                  np.rint(small).astype(np.uint32))


def _fma32(a, b, c):
    """fp32 fma(a, b, c), correctly rounded: a·b is exact in fp64; the fp64
    sum's rounding error (TwoSum) decides the fp32 rounding where the fp64
    sum falls exactly halfway between two fp32 values."""
    a, b, c = (np.asarray(t, np.float32).astype(np.float64) for t in (a, b, c))
    prod = a * b
    s = prod + c
    bb = s - prod
    err = (prod - (s - bb)) + (c - bb)
    r = s.astype(np.float32)
    other = np.nextafter(r, np.where(s > r.astype(np.float64), np.inf, -np.inf).astype(np.float32))
    mid = (r.astype(np.float64) + other.astype(np.float64)) / 2
    tie = (s == mid) & (other != r)
    up = np.maximum(r, other)
    down = np.minimum(r, other)
    fixed = np.where(err > 0, up, np.where(err < 0, down, r))
    return np.where(tie, fixed, r).astype(np.float32)


def _markstein(x, d):
    """The kernel's x/d: q0 = x·r with r the correctly rounded 1/d, then
    q0 + (x − q0·d)·r by two fmas (csrc/attention_q8.cu div_rn)."""
    x, d = np.asarray(x, np.float32), np.asarray(d, np.float32)
    r = np.float32(1.0) / d
    q0 = x * r
    return _fma32(_fma32(-q0, d, x), r, q0)


def test_q8_division_rewrite_equals_ieee_division():
    """The kernel's two divisions per logit, p/l and pn/ps, by Markstein's
    correction from one reciprocal a row, against IEEE fp32 division: on
    every logit of seeded rows as the plain version forms them (random
    q, k at S = 1024, D = 40, 80, 160), on random (p, l) over the ranges a
    row can give, and on the tie probe's rows (chip_smoke.q8_tie_probe)."""
    import chip_smoke

    def check(p, l):
        p, l = np.asarray(p, np.float32), np.asarray(l, np.float32)
        pn = p / l
        np.testing.assert_array_equal(_markstein(p, l), pn)
        ps = (np.maximum(np.float32(1.0) / l, np.float32(1e-20))
              * np.float32(1.0 / 127.0)).astype(np.float32)
        np.testing.assert_array_equal(_markstein(pn, ps), pn / ps)
        return int(p.size)

    checked = 0
    for D in (40, 80, 160):
        rng = _rng(D)
        q, k, v = (_t(rng.standard_normal((1, 1024, 2, D)).astype(np.float32)) for _ in range(3))
        qq, sq, kq, sk, _, _ = attention.quantize_qkv(q, k, v, True)
        c = float(np.float32(D ** -0.5 * attention.LOG2E))
        acc = (qq.double() @ kq.double().transpose(1, 2)).float()
        x = acc * (sq[:, :, None] * c) * sk[:, None, :]
        p = torch.exp2(x - x.amax(-1, keepdim=True))
        l = p.sum(-1, keepdim=True).expand_as(p)
        checked += check(p.numpy(), l.numpy())
    rng = _rng(11)
    l = np.float32(1.0) + rng.random(1 << 20, dtype=np.float32) * np.float32(4095.0)
    p = np.exp2(-rng.random(1 << 20, dtype=np.float32) * np.float32(30.0)).astype(np.float32)
    checked += check(p, l)
    ops, shape, _, n_ties = chip_smoke.q8_tie_probe(torch.device("cpu"))
    assert n_ties >= chip_smoke.Q8_PROBE_MIN_TIES
    qq, sq, kq, sk, _, _ = ops
    cl = float(torch.tensor(attention.LOG2E, dtype=torch.float32))
    sk1 = 1.0 + torch.arange(shape[0] * shape[2]).float() / 64.0
    p1 = torch.exp2((-1.0 * (sq * cl)) * sk1[:, None])
    l1 = 1.0 + p1
    checked += check(p1.numpy(), l1.numpy()) + check(np.ones_like(l1.numpy()), l1.numpy())
    assert checked > 6_000_000


def _q8_kernel_emulation(qq, sq, kq, sk, v, sv, scale, shape, fault=None):
    """attention_q8.cu's arithmetic in plain torch, bf16 (B, S, H, D) out:
    the plain version's fp32 logits, p and pq, with l summed as the kernel
    sums it (each lane's keys 8j + 2·t (+1) online over 64-key halves, then
    the 4 lanes) and P·V accumulated in fp32 over 64-key halves. `fault`
    plants one of the faults the bands were set against: "unquantized_p"
    ("int8": pn·v in place of pq·ps·vq), "p_unscaled" ("int8": pq =
    rint(p/l), without the 1/ps scale), "drop_last_chunk" (keys 96..127 of
    every 128-key tile left out of P·V), "neighbour_sk" (the next b·h's key
    scales), "fragment_lane" (each lane's pq meets the keys of the next
    lane of its quad), "half_away" ("int8": pq rounded half away from zero)."""
    B, S, H, D = shape
    pv8 = sv is not None
    c = float(np.float32(scale * attention.LOG2E))
    if fault == "neighbour_sk":
        sk = sk.roll(-1, 0)
    acc = (qq[..., :D].double() @ kq[..., :D].double().transpose(1, 2)).float()
    x = acc * (sq[:, :, None] * c) * sk[:, None, :]
    m = x.amax(-1, keepdim=True)
    p = torch.exp2(x - m)
    if pv8:
        # lane t's keys: 8j + 2t + {0, 1}; online over 64-key halves
        xt = x.reshape(*x.shape[:2], S // 64, 8, 4, 2).transpose(-2, -3)  # (.., half, lane, j, e)
        xt = xt.reshape(*x.shape[:2], S // 64, 4, 16)
        ml = torch.full((*x.shape[:2], 4), -float("inf"))
        ll = torch.zeros((*x.shape[:2], 4))
        for hh in range(S // 64):
            mx = torch.maximum(ml, xt[..., hh, :, :].amax(-1))
            ll = ll * torch.exp2(ml - mx) + torch.exp2(xt[..., hh, :, :] - mx[..., None]).sum(-1)
            ml = mx
        lanes = ll * torch.exp2(ml - m)
        l = ((lanes[..., 0] + lanes[..., 1]) + (lanes[..., 2] + lanes[..., 3]))[..., None]
        pn = p / l
        ps = (1.0 / l).clamp_min(1e-20) * (1.0 / 127.0)
        ratio = pn / ps
        pq = torch.floor(ratio + 0.5) if fault == "half_away" else torch.round(ratio)
        if fault == "p_unscaled":
            pq = torch.round(pn)
        vq = attention.q8_unplace_keys(v[:, :D, :]).transpose(1, 2).float()  # (BH, S, D)
        if fault == "unquantized_p":
            lhs, rhs, post = pn, vq * sv[:, None, :D], None
        else:
            lhs, rhs, post = pq, vq, (ps, sv[:, None, :D])
    else:
        l = p.sum(-1, keepdim=True)
        lhs = p.bfloat16().float()
        rhs = v.permute(0, 2, 1, 3).reshape(B * H, S, D).float()
        post = None
    if fault == "fragment_lane":
        idx = torch.arange(S)
        idx = idx - idx % 8 + (idx % 8 + 2) % 8
        rhs = rhs[:, idx]
    if fault == "drop_last_chunk":
        lhs = lhs.clone()
        lhs[..., torch.arange(S) % 128 >= 96] = 0
    z = torch.zeros(B * H, S, D)
    for k0 in range(0, S, 64):
        z = z + lhs[..., k0:k0 + 64] @ rhs[:, k0:k0 + 64]
    if post is not None:
        z = z * post[0] * post[1]
    else:
        z = z / l
    return z.bfloat16().reshape(B, H, S, D).permute(0, 2, 1, 3)


@pytest.mark.parametrize("fault", [None, "unquantized_p", "p_unscaled", "drop_last_chunk",
                                   "neighbour_sk", "fragment_lane", "half_away"])
@pytest.mark.parametrize("mode", ["qk8", "int8"])
@pytest.mark.parametrize("shape", [(1, 512, 2, 40), (1, 256, 2, 80), (2, 256, 1, 160)])
def test_attention_q8_judge_sees_planted_faults(fault, mode, shape):
    """chip_smoke.py holds attention_q8 to its plain version with
    `attention_q8_judge` (relative L2 ≤ Q8_REL_L2_BAND over the output,
    ≤ Q8_ROW_BAND on its worst query row). With N(0,1) bf16 inputs, the
    kernel's arithmetic emulated in plain torch passes and every fault that
    changes the output fails; p's quantization exists only in "int8", and
    half-away rounding moves only exact ties, which random rows almost
    never hold: chip_smoke's tie probe catches it
    (test_chip_smoke_q8_tie_probe_tells_half_even_from_half_away). (PERF.md
    §6 gives the readings of the same faults planted in the kernel.)"""
    from psd_tpu_torch.testing import attention_q8_judge

    rng = _rng(909 + sum(shape))
    q, k, v = (_t(rng.standard_normal(shape).astype(np.float32)).bfloat16() for _ in range(3))
    pv8 = mode == "int8"
    ops = attention.quantize_qkv(q, k, v, pv8)
    scale = shape[-1] ** -0.5
    ref = attention.attention_q8_reference(*ops, scale, shape, torch.bfloat16)
    out = _q8_kernel_emulation(*ops, scale, shape, fault)
    ok, text, _ = attention_q8_judge(out, ref)
    unseen = (fault is None or fault == "half_away"
              or (fault in ("unquantized_p", "p_unscaled") and not pv8))
    assert ok == unseen, text
