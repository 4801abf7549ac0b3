"""`scripts/torch_port_weights.py` (published checkpoints → psd_tpu's npz
without JAX) against `scripts/port_weights.py`, and the port's
`orthogonal_loss` against psd_tpu's, on the CPU.

  * At SD-VAE scale (84 M parameters, the diffusers-named mirror's surface
    drawn from a seed) as .safetensors, and at a tiny width as a torch .bin:
    the npz the port's script writes with `--no-verify` equals psd_tpu's
    byte for byte (one clock for both zip files' timestamps); so does a
    tiny CLIP `model.safetensors` that carries the int64 `position_ids`.
  * A tiny VAE file converts; psd_tpu's `load_params_npz` reads what the
    port wrote as the tree the port's converter gives.
  * A wrong surface (a dropped tensor, a mis-shaped one) raises at the
    shape gate and at `--verify`'s manifest, and writes nothing.
  * `--verify`'s forward parity runs and passes for unet, vae and clip with
    the published configurations shrunk to tiny widths (the full widths
    take minutes on the CPU); without transformers, `--verify --kind clip`
    raises an ImportError that names it.
  * The port's package, `chip_smoke.py` and `scripts/torch_*.py` import
    nothing of JAX or psd_tpu; the package nothing of safetensors,
    transformers or tests; the script the mirrors and transformers only
    inside `--verify`.
"""

import ast
import importlib.util
import os
import re
import sys
import zipfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.torch_cli_parity import few_threads
from tests.torch_ref.vae import TorchAutoencoderKL

REPO = Path(__file__).resolve().parent.parent
# transformers imports TensorFlow and flax where they are installed; these
# tests take its PyTorch CLIP only
os.environ.setdefault("USE_TF", "0")
os.environ.setdefault("USE_FLAX", "0")
TINY_UNET = dict(block_out_channels=(32, 64), layers_per_block=1, heads=2, cross_attention_dim=32)
TINY_VAE = dict(block_out_channels=(32, 64), layers_per_block=2)
TINY_CLIP = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                 intermediate_size=64, patch_size=8, image_size=32, projection_dim=16)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    with few_threads():
        yield


def _script(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port():
    return _script("torch_port_weights")


def _seeded(module, seed: int):
    """`module`'s state_dict surface (built on the meta device) drawn from
    `seed` as float32 numpy."""
    rng = np.random.default_rng(seed)
    return {k: rng.random(v.shape, np.float32) - 0.5 for k, v in module.state_dict().items()}


def _on_meta(ctor, **kw):
    with torch.device("meta"):
        return ctor(**kw)


def _save(state, path: Path) -> Path:
    if path.suffix == ".safetensors":
        from safetensors.numpy import save_file

        save_file(state, str(path), metadata={"format": "pt"})
    else:
        torch.save({k: torch.from_numpy(v) for k, v in state.items()}, path)
    return path


@pytest.fixture(scope="module")
def sd_vae():
    """The SD VAE's surface, 84 M parameters drawn from a seed."""
    return _seeded(_on_meta(TorchAutoencoderKL), seed=0)


@pytest.mark.parametrize("width,suffix", [("sd", ".safetensors"), ("tiny", ".bin")])
def test_the_npz_is_psd_tpus_byte_for_byte(tmp_path, monkeypatch, port, sd_vae, width, suffix):
    state = sd_vae if width == "sd" else _seeded(_on_meta(TorchAutoencoderKL, **TINY_VAE), 2)
    src = _save(state, tmp_path / f"vae{suffix}")
    # zip entries carry the clock's second: one clock for both files
    monkeypatch.setattr(zipfile, "time", SimpleNamespace(time=lambda: 1.7e9,
                                                         localtime=__import__("time").localtime))
    port.main(["--kind", "vae", "--src", str(src), "--no-verify", "--out", str(tmp_path / "port.npz")])
    _script("port_weights").main(["--kind", "vae", "--src", str(src), "--no-verify",
                                  "--out", str(tmp_path / "jax.npz")])
    got, want = (tmp_path / "port.npz").read_bytes(), (tmp_path / "jax.npz").read_bytes()
    assert len(got) > sum(v.nbytes for v in state.values())
    assert got == want


def test_a_clip_safetensors_with_position_ids_is_psd_tpus_byte_for_byte(tmp_path, monkeypatch,
                                                                        port):
    """A CLIP `model.safetensors` that carries the int64
    `vision_model.embeddings.position_ids` buffer (older transformers saved
    it) converts by `--kind clip` to the npz `scripts/port_weights.py`
    writes, byte for byte: both readers pass the I64 entry on and the
    converters leave it out."""
    from transformers import CLIPVisionConfig, CLIPVisionModelWithProjection

    state = _seeded(_on_meta(lambda: CLIPVisionModelWithProjection(
        CLIPVisionConfig(**TINY_CLIP))), seed=3)
    n_pos = (TINY_CLIP["image_size"] // TINY_CLIP["patch_size"]) ** 2 + 1
    state["vision_model.embeddings.position_ids"] = np.arange(n_pos, dtype=np.int64)[None]
    src = _save(state, tmp_path / "model.safetensors")
    monkeypatch.setattr(zipfile, "time", SimpleNamespace(time=lambda: 1.7e9,
                                                         localtime=__import__("time").localtime))
    argv = ["--kind", "clip", "--src", str(src), "--no-verify", "--out"]
    port.main(argv + [str(tmp_path / "port.npz")])
    _script("port_weights").main(argv + [str(tmp_path / "jax.npz")])
    assert (tmp_path / "port.npz").read_bytes() == (tmp_path / "jax.npz").read_bytes()


def test_a_tiny_file_converts(tmp_path, port, capsys):
    from psd_tpu.convert.io import load_params_npz
    from psd_tpu_torch.convert.from_jax import _leaves
    from psd_tpu_torch.convert.sd import convert_sd_vae

    state = _seeded(_on_meta(TorchAutoencoderKL, **TINY_VAE), seed=1)
    src = _save(state, tmp_path / "tiny.safetensors")
    port.main(["--kind", "vae", "--src", str(src), "--no-verify", "--out", str(tmp_path / "v.npz")])
    assert "saved →" in capsys.readouterr().out
    got = dict(_leaves(load_params_npz(tmp_path / "v.npz")))
    want = dict(_leaves(convert_sd_vae(state)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w)


@pytest.mark.parametrize("flags,error", [(["--verify"], (KeyError, ValueError)),
                                         (["--verify", "--no-verify"], AssertionError)])
def test_a_wrong_surface_raises(tmp_path, port, sd_vae, flags, error):
    state = dict(sd_vae)
    state.pop("decoder.conv_out.bias")
    state["encoder.conv_in.weight"] = np.zeros((16, 3, 3, 3), np.float32)
    src = _save(state, tmp_path / "vae_bad.bin")
    out = tmp_path / "vae_bad.npz"
    with pytest.raises(error):
        port.main(["--kind", "vae", "--src", str(src), *flags, "--out", str(out)])
    assert not out.exists()


def _tiny_checkpoint(kind: str, path: Path) -> Path:
    torch.manual_seed(0)
    if kind == "unet":
        from tests.torch_ref.unet import TorchUNet2DConditionModel

        module = TorchUNet2DConditionModel(**TINY_UNET)
    elif kind == "vae":
        module = TorchAutoencoderKL(**TINY_VAE)
    else:
        from transformers import CLIPVisionConfig, CLIPVisionModelWithProjection

        module = CLIPVisionModelWithProjection(CLIPVisionConfig(**TINY_CLIP))
    torch.save(module.state_dict(), path)
    return path


@pytest.mark.parametrize("kind", ["unet", "vae", "clip"])
def test_verify_passes_at_tiny_width(tmp_path, monkeypatch, port, capsys, kind):
    monkeypatch.setattr(port, "SD_UNET", TINY_UNET)
    monkeypatch.setattr(port, "SD_VAE", TINY_VAE)
    monkeypatch.setattr(port, "CLIP_L14", TINY_CLIP)
    src = _tiny_checkpoint(kind, tmp_path / f"{kind}.bin")
    # --no-verify: the shape gate holds the published width, not this one
    port.main(["--kind", kind, "--src", str(src), "--verify", "--no-verify"])
    word = {"unet": "forward", "vae": "decode", "clip": "image_embeds"}[kind]
    assert f"verify: {kind} fp32 {word} parity OK" in capsys.readouterr().out


def test_verify_clip_names_transformers_where_it_is_missing(tmp_path, monkeypatch, port):
    from psd_tpu_torch.convert import manifest

    monkeypatch.setattr(port, "CLIP_L14", TINY_CLIP)
    m = manifest.clip_vision_manifest(hidden=32, layers=2, heads=2, mlp=64, patch=8,
                                      image_size=32, projection_dim=16)
    src = _save({k: np.zeros(s, np.float32) for k, s in m.items()}, tmp_path / "clip.bin")
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        port.main(["--kind", "clip", "--src", str(src), "--verify", "--no-verify"])


FORBIDDEN = re.compile(r"^\s*(import|from) (jax|flax|optax|psd_tpu\b)")
FORBIDDEN_IN_PACKAGE = re.compile(r"^\s*(import|from) (safetensors|transformers|tests)\b")


def test_the_port_imports_no_jax_and_the_script_the_mirrors_only_to_verify():
    files = [*sorted((REPO / "psd_tpu_torch").rglob("*.py")), REPO / "chip_smoke.py",
             *sorted((REPO / "scripts").glob("torch_*.py"))]
    for path in files:
        for n, line in enumerate(path.read_text().splitlines(), 1):
            assert not FORBIDDEN.match(line), f"{path}:{n}: {line}"
            if "psd_tpu_torch" in path.parts:
                assert not FORBIDDEN_IN_PACKAGE.match(line), f"{path}:{n}: {line}"
    def imports(node):
        """The modules imported under `node`, `_deep_verify` left out."""
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.FunctionDef) and child.name == "_deep_verify":
                continue
            if isinstance(child, ast.ImportFrom):
                yield child.module.split(".")[0]
            elif isinstance(child, ast.Import):
                yield from (a.name.split(".")[0] for a in child.names)
            else:
                yield from imports(child)

    outside = set(imports(ast.parse((REPO / "scripts" / "torch_port_weights.py").read_text())))
    assert "psd_tpu_torch" in outside
    assert not outside & {"tests", "transformers", "jax", "psd_tpu", "safetensors"}


def test_orthogonal_loss_is_psd_tpus():
    import jax.numpy as jnp

    from psd_tpu.diffusion.losses import orthogonal_loss as jax_loss
    from psd_tpu_torch.diffusion.losses import orthogonal_loss

    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 5, 16), np.float32)
    b = rng.standard_normal((3, 7, 16), np.float32) + 0.3
    a[1] = 0.0  # a zero-norm pooled row: the eps floor
    got = orthogonal_loss(torch.from_numpy(a), torch.from_numpy(b))
    want = jax_loss(jnp.asarray(a), jnp.asarray(b))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    assert 0.0 < float(got) < 1.0
