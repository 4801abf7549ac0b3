"""The kernel routes held to the kernels' admissions, on the CPU.

psd_tpu gates its kernels on shape alone and its Pallas kernels take any
head dim; the port's CUDA kernels admit fewer shapes (`fwd_shape_error`,
`bwd_shape_error`, `split3_shape_error`). A route sends a shape to a kernel
only where psd_tpu's gate takes it AND the kernel admits it; every other
shape takes the plain path, as psd_tpu's None return does. The port's copy
of psd_tpu's attention gate (`attention.psd_tpu_route`) is held to psd_tpu's
own dispatcher on a sample of shapes; the sweeps then cover every head dim
1..600 for attention (both modes) and H 1..16, D 1..200 and bank lengths
1..20 for split3; the models' shapes (D = 40, 80, 160 in the UNet, 512 in
the VAE) must still reach the kernels.
"""

import contextlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psd_tpu_torch.models import layers
from psd_tpu_torch.models.layers import split3_kernel_ok
from psd_tpu_torch.ops import attention, split3

SEQ_GRID = (64, 128, 192, 256, 384, 448, 512, 576, 640, 768, 1024, 1280, 1536, 4096, 4608)
# head dims on both sides of every limit of psd_tpu's gate and the port's
# admissions (D % 8, 160, 256, 512)
D_SAMPLE = (1, 8, 36, 40, 80, 160, 168, 192, 256, 264, 512, 520, 600)


@pytest.fixture
def psd_tpu_dispatch(monkeypatch):
    """psd_tpu's own `dot_product_attention` (`psd_tpu/ops/attention.py:46-59`,
    with the gates of `ops/spattn.py:238` and `ops/flash.py:52`) run under
    `jax.eval_shape` as on a TPU, its Pallas kernels replaced by stubs that
    record their call → route(Sq, Sk, D, training): the kernel psd_tpu
    sends that shape to ("spattn", "flash"), or None for its einsum."""
    from psd_tpu.core import mode as jmode
    from psd_tpu.ops import attention as jattn
    from psd_tpu.ops import flash, spattn

    taken = []

    def stub(name):
        def kernel(q, *args, **kw):
            taken.append(name)
            return q
        return kernel

    monkeypatch.setenv("PSD_TPU_FORCE_KERNELS", "interpret")  # kernel_backend_ok()
    monkeypatch.setattr(jattn, "_BACKEND", "auto")
    monkeypatch.setattr(flash, "_on_tpu", lambda: True)
    monkeypatch.setattr(flash, "_get_kernel", lambda: (stub("flash"), lambda **kw: None))
    monkeypatch.setattr(spattn, "_spattn", stub("spattn"))

    def route(Sq, Sk, D, training):
        taken.clear()
        q = jax.ShapeDtypeStruct((1, Sq, 1, D), jnp.bfloat16)
        k = jax.ShapeDtypeStruct((1, Sk, 1, D), jnp.bfloat16)
        with jmode.training_mode() if training else contextlib.nullcontext():
            # a fresh function each call: jax caches a trace by function and
            # shapes, and a cached trace would call no stub
            jax.eval_shape(lambda *qkv: jattn.dot_product_attention(*qkv), q, k, k)
        assert len(taken) <= 1, taken
        return taken[0] if taken else None

    return route


@pytest.mark.parametrize("training", [False, True])
def test_psd_tpu_route_is_psd_tpu_own_dispatch(psd_tpu_dispatch, training):
    """Over D_SAMPLE × SEQ_GRID², `psd_tpu_route` names the kernel psd_tpu's
    own dispatcher calls."""
    kinds = set()
    for D in D_SAMPLE:
        for Sq in SEQ_GRID:
            for Sk in SEQ_GRID:
                want = psd_tpu_dispatch(Sq, Sk, D, training)
                assert attention.psd_tpu_route(Sq, Sk, D, training) == want, (Sq, Sk, D)
                kinds.add(want)
    assert kinds == ({None, "flash"} if training else {None, "flash", "spattn"})


def _shape(S, D):
    return SimpleNamespace(shape=(2, S, 8, D))


@pytest.mark.parametrize("training", [False, True])
def test_attention_route_is_psd_tpu_gate_and_admission(training):
    """Over D = 1..600 and SEQ_GRID², the route equals psd_tpu's gate
    (`psd_tpu_route`, held to psd_tpu above) where the forward kernels (and
    in training the backward kernels) admit the shape, None elsewhere; so
    every routed shape is admitted."""
    routed = refused = 0
    for D in range(1, 601):
        for Sq in SEQ_GRID:
            for Sk in SEQ_GRID:
                gate = attention.psd_tpu_route(Sq, Sk, D, training)
                admitted = attention.fwd_shape_error(Sq, Sk, D) is None and (
                    not training or attention.bwd_shape_error(Sq, Sk, D) is None)
                route = attention.kernel_route(_shape(Sq, D), _shape(Sk, D), training)
                assert route == (gate if admitted else None), (Sq, Sk, D, gate, admitted)
                routed += route is not None
                refused += gate is not None and route is None
    # the sweep reaches both sides of every admission
    assert routed > 0 and refused > 0


@pytest.mark.parametrize("shape,training,route", [
    ((8, 4096, 8, 40), False, "spattn"),   # UNet self-attention, 512²
    ((8, 1024, 8, 80), False, "spattn"),
    ((8, 4096, 1, 512), False, "flash"),   # VAE mid block
    ((64, 1024, 8, 40), True, "flash"),    # training, 256²
    ((8, 4096, 8, 40), True, "flash"),
    ((8, 1024, 8, 80), True, "flash"),
    ((8, 256, 8, 160), False, None),       # psd_tpu routes S = 256 to no kernel
])
def test_model_attention_shapes_still_route(shape, training, route):
    q = torch.empty(shape, device="meta")
    assert attention.kernel_route(q, q, training) == route


@pytest.mark.parametrize("shape,training", [
    ((1, 512, 8, 36), False),   # D % 8: the forward kernels refuse it
    ((1, 512, 1, 520), False),  # above the wide kernel's 512
    ((1, 512, 8, 192), True),   # training: no backward kernel above D = 160
])
def test_refused_attention_shapes_take_the_plain_path(psd_tpu_dispatch, shape, training):
    """psd_tpu routes these shapes to a kernel; the port's route sends them
    to the plain path."""
    B, S, H, D = shape
    assert psd_tpu_dispatch(S, S, D, training) is not None
    q = torch.empty(shape, device="meta")
    assert attention.kernel_route(q, q, training) is None


def test_split3_route_is_psd_tpu_gate_and_admission():
    """Over H = 1..16, D = 1..200 and bank lengths 1..20 (each bank alone
    and all three together), at S = 128, 256, 384 and 4096: split3_kernel_ok
    equals psd_tpu's gate (S >= 256, S % 128 == 0;
    psd_tpu/models/layers.py:449) ∧ split3_shape_error's admission."""
    lens_grid = sorted({lens for n in range(1, 21)
                        for lens in ((n, 16, 16), (16, n, 16), (16, 16, n), (n, n, n))})
    routed = refused = 0
    for S in (128, 256, 384, 4096):
        gate = S >= 256 and S % 128 == 0
        for H in range(1, 17):
            for D in range(1, 201):
                for lens in lens_grid:
                    admitted = split3.split3_shape_error(2, S, H, D, lens) is None
                    ok = split3_kernel_ok(2, S, H, D, lens)
                    assert ok == (gate and admitted), (S, H, D, lens)
                    routed += ok
                    refused += gate and not ok
    assert routed > 0 and refused > 0


@pytest.mark.parametrize("B,S,D", [(8, 4096, 40), (8, 1024, 80), (8, 256, 160),
                                   (64, 1024, 40), (64, 256, 80), (1, 4096, 40)])
def test_model_split3_shapes_still_route(B, S, D):
    """The UNet's cross-attention sites (8 heads, 16-token banks) at 512²
    serving and 256² training batches."""
    assert split3_kernel_ok(B, S, 8, D, (16, 16, 16))


@pytest.mark.parametrize("H,D,lens", [
    (8, 120, (16, 16, 16)),   # the banks do not fit beside the ring at H = 8
    (8, 40, (16, 17, 16)),    # a 17-token bank
    (8, 36, (16, 16, 16)),    # D % 8
    (2, 200, (16, 16, 16)),   # above D = 160
])
def test_refused_split3_shapes_take_the_plain_path(H, D, lens):
    assert not split3_kernel_ok(2, 256, H, D, lens)


def _split3_site(dim, tokens):
    """One split3 cross-attention site of `dim` channels, 8 heads, banks of
    `tokens` tokens each, fp32."""
    mode = layers.CrossAttnMode("split3", num_aoe_tokens=tokens, num_image_tokens=tokens,
                                num_delta_tokens=tokens)
    torch.manual_seed(0)
    return layers.Attention(dim, 8, context_dim=32, mode=mode, dtype=torch.float32)


@pytest.mark.parametrize("dim,tokens,kernel", [
    (320, 16, True),    # D = 40: the kernel
    (960, 16, False),   # D = 120 at H = 8: refused, plain
    (320, 17, False),   # 17-token banks: refused, plain
])
def test_split3_site_routes_by_admission(monkeypatch, dim, tokens, kernel):
    """The call site passes B, H, D and the bank lengths to the gate: the
    kernel entry is called where the kernel admits the site's shapes, the
    three plain attentions otherwise, and both give the plain function."""
    calls = []
    real = layers.split3_attention

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(layers, "split3_attention", spy)
    site = _split3_site(dim, tokens)
    rng = np.random.default_rng(dim + tokens)
    x = torch.from_numpy(rng.standard_normal((1, 256, dim)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((1, 3 * tokens, 32)).astype(np.float32))
    with torch.no_grad():
        out = site(x, ctx, 1.0)
    assert (len(calls) == 1) == kernel
    assert out.shape == (1, 256, dim) and torch.isfinite(out).all()


@pytest.mark.parametrize("D,kernel", [(40, True), (36, False)])
def test_attention_site_routes_by_admission(monkeypatch, D, kernel):
    """dot_product_attention calls the kernel wrapper only for an admitted
    shape; a refused one (D = 36) takes attention_reference."""
    calls = []
    real = attention.attention_fwd

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(attention, "attention_fwd", spy)
    rng = np.random.default_rng(D)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 512, 2, D)).astype(np.float32))
               for _ in range(3))
    out = attention.dot_product_attention(q, k, v)
    assert (len(calls) == 1) == kernel
    torch.testing.assert_close(out, attention.attention_reference(q, k, v))
