"""The port's packed ensemble and K5's plain version against the JAX
package: pack arrays equal bit for bit; the plain packed walk equal to
``repro.kernels.ref.gbdt_margins_packed_ref``, to the Pallas kernel in
interpret mode and to the dense walk (K4's plain version) within 1e-5 (a
tree-order float32 sum against the JAX oracles' pairwise ones); the
base score carried over; P(Long) equal through both layouts.
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ensemble_pack import pack_ensemble as jpack
from repro.core.gbdt import GBDTModel as JModel
from repro.core.gbdt import GBDTParams as JParams
from repro.core.gbdt import train_gbdt as jtrain
from repro.core.predictor import Predictor as JPredictor
from repro.data.corpus import sample_dataset as jsample
from repro.kernels import ref as jref
from repro.kernels.gbdt_infer import gbdt_margins_packed_kernel
from repro_torch.core.ensemble_pack import pack_ensemble
from repro_torch.core.gbdt import GBDTModel, GBDTParams, train_gbdt
from repro_torch.core.predictor import Predictor
from repro_torch.kernels import ops
from repro_torch.kernels.gbdt_infer import (gbdt_margins_packed_cuda,
                                            gbdt_margins_packed_plain)

SHAPES = [
    dict(num_rounds=12, max_depth=6, n_classes=3),
    dict(num_rounds=8, max_depth=3, n_classes=2),
    dict(num_rounds=5, max_depth=4, n_classes=4),
    dict(num_rounds=6, max_depth=2, n_classes=3, subsample=0.8),
    dict(num_rounds=3, max_depth=1, n_classes=2),
]
IDS = [f"r{p['num_rounds']}d{p['max_depth']}k{p['n_classes']}"
       for p in SHAPES]
ATOL = 1e-5


def _problem(n_classes, n=700, f=11, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, n)
    X = rng.normal(0, 1, (n, f)).astype(np.float32)
    X[:, 0] += y * 1.3
    X[:, f // 2] += (y == n_classes - 1) * 1.7
    return X, y


def _models(params, base_score=0.0, **kw):
    """The JAX model and the port's copy of its trees."""
    X, y = _problem(params["n_classes"], **kw)
    jm = jtrain(X, y, JParams(**params))
    jm.base_score = base_score
    pm = GBDTModel(jm.feature, jm.threshold, jm.value, jm.n_classes,
                   jm.max_depth, base_score)
    return jm, pm, X


@pytest.mark.parametrize("params", SHAPES, ids=IDS)
def test_pack_arrays_equal_jax_bitwise(params):
    """Trained by each package's own trainer, packed by each package's
    own pack: every array of both layouts is the same."""
    X, y = _problem(params["n_classes"])
    got = pack_ensemble(train_gbdt(X, y, GBDTParams(**params)))
    want = jpack(jtrain(X, y, JParams(**params)))
    for name in ("feat", "thr_bin", "child", "value", "roots", "pfeat",
                 "pthr", "pchild", "pvalue"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert len(got.bin_edges) == len(want.bin_edges)
    for a, b in zip(got.bin_edges, want.bin_edges):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (got.n_classes, got.n_features, got.depth, got.base_score) == \
        (want.n_classes, want.n_features, want.depth, want.base_score)


def _plain(packed, X):
    return gbdt_margins_packed_plain(
        torch.as_tensor(X), *packed.tensors("cpu"), depth=packed.depth,
        n_classes=packed.n_classes).numpy()


@pytest.mark.parametrize("B", [0, 1, 7, 64])
@pytest.mark.parametrize("params", SHAPES[:3], ids=IDS[:3])
def test_plain_k5_matches_jax_ref_pallas_and_dense(params, B):
    jm, pm, X = _models(params)
    X = X[:B]
    packed = pm.packed()
    got = _plain(packed, X)
    assert got.shape == (B, pm.n_classes) and got.dtype == np.float32
    jp = jpack(jm)
    args = (jnp.asarray(X), jnp.asarray(jp.pfeat), jnp.asarray(jp.pthr),
            jnp.asarray(jp.pchild), jnp.asarray(jp.pvalue))
    kw = dict(depth=jp.depth, n_classes=jp.n_classes)
    np.testing.assert_allclose(
        got, np.asarray(jref.gbdt_margins_packed_ref(*args, **kw)),
        atol=ATOL)
    if B:                   # the Pallas grid needs one batch row at least
        np.testing.assert_allclose(
            got, np.asarray(gbdt_margins_packed_kernel(
                *args, **kw, block_b=128, block_t=2 * jp.n_classes,
                interpret=True)), atol=ATOL)
    np.testing.assert_allclose(got, pm.predict_margin_dense(X, "cpu"),
                               atol=ATOL)
    np.testing.assert_allclose(got, jm.predict_margin_dense(X), atol=ATOL)


def test_base_score_carried_from_jax_model():
    """A JAX model with base_score 0.5 scores the same in the port through
    both layouts (the port's model used to drop the base score)."""
    jm, pm, X = _models(SHAPES[0], base_score=0.5)
    assert pm.packed().base_score == jpack(jm).base_score == 0.5
    want = jm.predict_margin_dense(X[:40])
    np.testing.assert_allclose(pm.predict_margin_dense(X[:40], "cpu"), want,
                               atol=ATOL)
    np.testing.assert_allclose(jm.predict_margin(X[:40]), want, atol=ATOL)
    for i in range(5):                      # one row: the packed layout
        np.testing.assert_allclose(pm.predict_margin(X[i:i + 1], "cpu"),
                                   want[i:i + 1], atol=ATOL)
    zero = JModel(jm.feature, jm.threshold, jm.value, jm.n_classes,
                  jm.max_depth)
    np.testing.assert_allclose(want - zero.predict_margin_dense(X[:40]),
                               0.5, atol=ATOL)


def test_p_long_equal_through_both_layouts():
    """One prompt at a time (packed, K5's plain version) and the burst
    (dense, K4's) give the JAX predictor's P(Long)."""
    ds = jsample("sharegpt", n=500, seed=42, balanced=True)
    jpred = JPredictor.train(ds.prompts, ds.lengths, JParams(num_rounds=12))
    m = jpred.model
    pred = Predictor(GBDTModel(m.feature, m.threshold, m.value, m.n_classes,
                               m.max_depth), device="cpu")
    prompts = ds.prompts[:40]
    single = np.array([pred.p_long(p) for p in prompts])
    burst = pred.p_long_batch(prompts)
    np.testing.assert_allclose(single, burst, atol=1e-6)
    np.testing.assert_allclose(single, [jpred.p_long(p) for p in prompts],
                               atol=1e-6)
    np.testing.assert_allclose(pred.proba(prompts[0]),
                               pred.proba_batch(prompts[:1])[0], atol=0)


def test_packed_cache_and_device_tensors():
    _, pm, _ = _models(SHAPES[1])
    p1 = pm.packed()
    assert pm.packed() is p1
    assert pm.packed(rebuild=True) is not p1
    p2 = pm.packed()
    t = p2.tensors("cpu")
    assert p2.tensors(torch.device("cpu")) is t
    assert [a.dtype for a in t] == [torch.int32, torch.float32, torch.int32,
                                    torch.float32]
    np.testing.assert_array_equal(t[0].numpy(), p2.pfeat)


def test_ops_dispatch_on_the_cpu():
    """A CPU tensor takes the plain versions; the CUDA wrapper refuses
    host tensors instead of falling back."""
    _, pm, X = _models(SHAPES[0], base_score=0.25)
    x = torch.as_tensor(X[:9])
    packed = pm.packed()
    got = ops.gbdt_margins_packed_from(packed, x)
    np.testing.assert_allclose(got.numpy(), _plain(packed, X[:9]) + 0.25,
                               atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        gbdt_margins_packed_cuda(x, *packed.tensors("cpu"),
                                 depth=packed.depth)
    with pytest.raises(ValueError, match="features"):
        ops.gbdt_margins_packed_from(packed, x[:, :3])


def test_single_row_scores_through_packed_layout(monkeypatch):
    """``predict_margin`` sends every batch, one row, 5, 16 and 512, to the
    packed walk, as the JAX model always scores packed; the dense walk is
    reached only through ``predict_margin_dense``."""
    _, pm, X = _models(SHAPES[0])
    calls = []
    packed_fn, dense_fn = ops.gbdt_margins_packed, ops.gbdt_margins
    monkeypatch.setattr(ops, "gbdt_margins_packed", lambda *a, **k: (
        calls.append("packed"), packed_fn(*a, **k))[1])

    def no_dense(*a, **k):
        raise AssertionError("predict_margin reached the dense walk")
    monkeypatch.setattr(ops, "gbdt_margins", no_dense)
    rows = np.resize(X, (512, X.shape[1]))      # 512 rows from X's
    one = pm.predict_margin(X[:1], "cpu")
    many = pm.predict_margin(X[:5], "cpu")
    batch = pm.predict_margin(rows[:16], "cpu")
    burst = pm.predict_margin(rows, "cpu")
    assert calls == ["packed"] * 4
    assert batch.shape == (16, pm.n_classes) and burst.shape == (512,
                                                                 pm.n_classes)
    np.testing.assert_allclose(one, many[:1], atol=ATOL)
    np.testing.assert_allclose(burst[:16], batch, atol=ATOL)
    monkeypatch.setattr(ops, "gbdt_margins", dense_fn)
    np.testing.assert_allclose(burst, pm.predict_margin_dense(rows, "cpu"),
                               atol=ATOL)
