"""The port's evaluation and classification metrics against psd_tpu's, on the
CPU, on features drawn from a seed with numpy.

  * FID (numpy, copied): equal to psd_tpu's within rtol 1e-12 (the same
    float64 arithmetic).
  * CMMD and improved precision / recall in torch float32 against psd_tpu's
    in JAX float32: CMMD within 1e-5 absolute (its three kernel means are
    O(1) each and cancel to O(1e-2); the squared distances come from
    float32 dot products of up to 768 terms summed in another order, about
    1e-6 relative); precision and recall the same shares (within 1e-6, the
    float32 means' rounding), including
    on sets with duplicated rows, where the k-th neighbour distance ties
    (`torch.topk` and `jax.lax.top_k` may order ties apart, but the value at
    rank k is the same).
  * The classification battery (numpy, copied): every key equal.
  * The comparison table: the same text.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psd_tpu.metrics import classification as jcls
from psd_tpu.metrics import cmmd as jcmmd
from psd_tpu.metrics import comparison as jcomp
from psd_tpu.metrics import fid as jfid
from psd_tpu.metrics import prdc as jprdc
from psd_tpu_torch.metrics import classification, cmmd, comparison, fid, prdc
from tests.torch_cli_parity import few_threads


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    with few_threads():
        yield


def _feats(seed, n, d, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((n, d)) * scale).astype(np.float32)


@pytest.mark.parametrize("n,m,d", [(16, 24, 8), (40, 12, 64), (5, 5, 2048)])
def test_fid_matches_psd_tpu(n, m, d):
    a, b = _feats(n, n, d), _feats(m + 100, m, d, 1.3) + 0.2
    got, want = fid.fid_from_features(a, b), jfid.fid_from_features(a, b)
    assert got == pytest.approx(want, rel=1e-12)
    assert got > 0


def test_fid_of_a_set_with_itself_is_zero():
    a = _feats(3, 32, 16)
    assert fid.fid_from_features(a, a) == pytest.approx(0.0, abs=1e-9)


@pytest.mark.parametrize("n,m,d", [(16, 24, 8), (40, 12, 768), (2, 2, 4)])
def test_cmmd_matches_psd_tpu(n, m, d):
    a = np.array(jcmmd.l2_normalize(jnp.asarray(_feats(n, n, d))))
    b = np.array(jcmmd.l2_normalize(jnp.asarray(_feats(m + 7, m, d) + 0.3)))
    want = jcmmd.compute_cmmd(a, b)
    got = cmmd.compute_cmmd(cmmd.l2_normalize(torch.from_numpy(_feats(n, n, d))),
                            torch.from_numpy(b))
    assert got == pytest.approx(want, abs=1e-5)
    assert cmmd.compute_cmmd(a, b) == pytest.approx(want, abs=1e-5)


def test_cmmd_refuses_fewer_than_two():
    assert cmmd.compute_cmmd(_feats(0, 1, 8), _feats(1, 5, 8)) == -1.0
    assert float(jcmmd.mmd2_rbf(jnp.zeros((1, 8)), jnp.zeros((5, 8)))) == -1.0


def test_l2_normalize_matches_psd_tpu():
    x = _feats(4, 6, 32)
    x[0] = 0.0  # the eps floor
    np.testing.assert_allclose(cmmd.l2_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jcmmd.l2_normalize(jnp.asarray(x))), atol=1e-7)


@pytest.mark.parametrize("dupes", [False, True])
@pytest.mark.parametrize("n,m,d,k", [(20, 30, 16, 3), (12, 12, 4096, 3), (9, 7, 8, 5)])
def test_improved_precision_recall_matches_psd_tpu(n, m, d, k, dupes):
    real, fake = _feats(n, n, d), _feats(m + 1, m, d, 1.1) + 0.1
    if dupes:  # duplicated rows: tied k-th neighbour distances (0 among the copies)
        real[1::3] = real[0]
        fake[: m // 2] = fake[m // 2: 2 * (m // 2)]
        fake[-1] = real[2]
    got = prdc.improved_precision_recall(torch.from_numpy(real), torch.from_numpy(fake), k=k)
    want = jprdc.improved_precision_recall(real, fake, k=k)
    # shares of at most 30 samples: equal counts, whatever the float32 mean's rounding
    assert got == pytest.approx(want, abs=1e-6)


def test_knn_radii_value_under_ties():
    """Rows with many equal distances: the k-th value, not the order."""
    x = np.zeros((6, 3), np.float32)
    x[3:] = 1.0
    got = prdc.knn_radii(torch.from_numpy(x), 2).numpy()
    want = np.asarray(jprdc._knn_radii(jnp.asarray(x), 2))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.zeros(6, np.float32))


def test_precision_recall_refuses_small_sets():
    assert prdc.improved_precision_recall(_feats(0, 3, 4), _feats(1, 10, 4)) == (-1.0, -1.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_classification_report_matches_psd_tpu(seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 4, 50)
    logits = rng.standard_normal((50, 4)) + np.eye(4)[y] * seed
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    got = classification.classification_report(y, probs.argmax(1), probs, 4)
    want = jcls.classification_report(y, probs.argmax(1), probs, 4)
    assert got == want
    np.testing.assert_array_equal(classification.confusion_matrix(y, probs.argmax(1), 4),
                                  jcls.confusion_matrix(y, probs.argmax(1), 4))
    pred = rng.standard_normal(50) + y
    assert classification.regression_report(y, pred, 4) == jcls.regression_report(y, pred, 4)


def test_comparison_table_matches_psd_tpu():
    runs = [{"checkpoint": "runs/ckpt_a", "scale": 1.0, "throughput_img_s": 3.5,
             "num_generated": 12, "overall": {"fid": 1.5, "fid_std": 0.25, "cmmd": 0.1}},
            {"checkpoint": "None", "scale": 2.0, "overall": {}}]
    assert comparison.comparison_table(runs) == jcomp.comparison_table(runs)
