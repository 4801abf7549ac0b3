"""`scripts/torch_compute_leace_projection.py` (the LEACE fit without JAX)
against `scripts/compute_leace_projection.py`, on the CPU.

Both scripts run on one seeded class-per-directory tree with the tiny
config: psd_tpu's with the port's seeded tiny weights in psd_tpu's layout
(`tests/torch_cli_parity.py::seeded_load_params`, not JAX's eager init), the
port's with `--device cpu` on the same seed, so both fit on the same
weights. Their npz agree within 1e-5 (the fp32 band of
`tests/test_torch_infer.py`'s image-projection parity: the embeddings come
from two fp32 implementations), the integer entries exactly; their four
printed statistics are the same text; and the port's infer CLI takes the
port's file with `--leace`.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from psd_tpu_torch.conditioning.leace import load_leace
from psd_tpu_torch.core.config import load_config
from psd_tpu_torch.pipelines import infer
from psd_tpu_torch.pipelines.common import build_model
from tests.torch_cli_parity import TINY, few_threads, make_class_tree, seeded_load_params

REPO = Path(__file__).resolve().parent.parent
SEED = 42


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    with few_threads():
        yield


def _script(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stats(text: str):
    """The printed lines but the path of the saved file."""
    return [line for line in text.splitlines() if not line.startswith("Saved →")]


def test_the_port_script_fits_psd_tpus_projection(tmp_path, monkeypatch, capsys):
    tree = make_class_tree(tmp_path / "data", counts=(("train", 5),), size=(48, 40))
    jscript = _script("compute_leace_projection")
    stand_in, _ = seeded_load_params(build_model(load_config(TINY), "fp32", device="cpu",
                                                 seed=SEED))
    monkeypatch.setattr(jscript, "load_params", stand_in)
    argv = ["--config", TINY, "--data-dir", str(tree), "--rank", "2", "--max-images", "18",
            "--batch-size", "8", "--seed", str(SEED), "--output"]
    ref = jscript.main(argv + [str(tmp_path / "jax.npz")])
    printed_jax = capsys.readouterr().out
    out = _script("torch_compute_leace_projection").main(
        argv + [str(tmp_path / "port.npz"), "--device", "cpu"])
    printed_port = capsys.readouterr().out

    assert _stats(printed_port) == _stats(printed_jax)
    assert len(_stats(printed_port)) == 4 and "[5, 5, 5, 3]" in printed_port
    for k, v in ref["stats"].items():
        assert out["stats"][k] == pytest.approx(v, rel=1e-5, abs=1e-6)
    got, want = load_leace(tmp_path / "port.npz"), load_leace(tmp_path / "jax.npz")
    assert set(got) == set(want) == {"P_null", "mu", "mayo_dir", "rank", "num_tokens",
                                     "token_dim"}
    for k in ("rank", "num_tokens", "token_dim"):
        assert got[k] == want[k]
    assert (got["rank"], got["P_null"].shape) == (2, (4 * 32, 4 * 32))
    for k in ("P_null", "mu", "mayo_dir"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5)

    png = tmp_path / "structure.png"
    Image.fromarray(np.random.default_rng(1).integers(0, 255, (40, 48, 3), dtype=np.uint8)).save(
        png)
    run = infer.main(["--config", TINY, "--structure-image", str(png), "--mes-steps", "2",
                      "--sampling-steps", "2", "--leace", str(tmp_path / "port.npz"),
                      "--output-dir", str(tmp_path / "prog"), "--device", "cpu"])
    assert run["images"].shape[0] == 2 and np.isfinite(run["images"]).all()
