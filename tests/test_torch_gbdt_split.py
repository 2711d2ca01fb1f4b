"""K4/K5's tree split (``repro_torch.kernels.gbdt_infer``), held on the
CPU: the cluster of ``tree_split_plan(T, K)`` blocks the trees are
split over, the tree range each block takes, and the order in which the
kernels sum the leaf values (``tree_fold``).

The card kernels (csrc/gbdt_infer.cu) compute the same ranges in the
same integer arithmetic and add the same float32 values in the same
order.  Here the plan must cover every tree exactly once, in order, in
ranges that start on a multiple of K, on at most 8 blocks, from (T, K)
alone; a row's folded margins must not depend on the rows beside it;
and the fold of the plain walks' leaf values is held to the JAX
package's oracles and its Pallas kernels in interpret mode at 1e-5
(float32 sums of up to 600 leaves a class, added in another order;
the margins at T 1800 reach ~40, so there the tolerance is relative,
1e-6, over an absolute 1e-5).
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ensemble_pack import pack_ensemble as jpack
from repro.core.gbdt import GBDTParams as JParams
from repro.core.gbdt import train_gbdt as jtrain
from repro.kernels import ref as jref
from repro.kernels.gbdt_infer import (gbdt_margins_kernel,
                                      gbdt_margins_packed_kernel)
from repro_torch.core.gbdt import GBDTModel
from repro_torch.kernels import ref
from repro_torch.kernels.gbdt_infer import (MAX_SLICES, _check_fits,
                                            tree_fold, tree_ranges,
                                            tree_split_plan)

TREES = [3, 60, 180, 900, 1800]
CLASSES = [1, 3]


@pytest.mark.parametrize("K", CLASSES)
@pytest.mark.parametrize("T", TREES)
def test_tree_ranges_cover_every_tree_once_in_order(T, K):
    n = tree_split_plan(T, K)
    assert 1 <= n <= MAX_SLICES and n <= T // K
    ranges = tree_ranges(T, K)
    assert ranges.shape == (n, 2) and ranges.dtype == torch.int64
    trees = [t for lo, hi in ranges.tolist() for t in range(lo, hi)]
    assert trees == list(range(T))
    lo, hi = ranges[:, 0], ranges[:, 1]
    assert bool((lo % K == 0).all()) and bool((hi % K == 0).all())
    assert bool((hi > lo).all()) and bool((hi[:-1] == lo[1:]).all())
    sizes = hi - lo
    assert int(sizes.max() - sizes.min()) <= K


@pytest.mark.parametrize("K", CLASSES)
@pytest.mark.parametrize("T", TREES)
def test_tree_plan_does_not_depend_on_batch(T, K):
    """The plan is a function of (T, K) alone, and a row folded alone
    equals its row of a batch of 16 or 512 bit for bit."""
    rng = np.random.default_rng(T * 10 + K)
    leaves = torch.from_numpy(rng.normal(size=(T, 512)).astype(np.float32))
    for B in (16, 512):
        batch = tree_fold(leaves[:, :B], K)
        assert batch.shape == (B, K) and batch.dtype == torch.float32
        for b in (0, 1, B // 2, B - 1):
            assert torch.equal(batch[b], tree_fold(leaves[:, b:b + 1], K)[0])
        assert torch.equal(batch, tree_fold(leaves, K)[:B])


def _leaves_dense(X, f, t, v):
    """(T, B) leaf values of the dense walk: K4's plain version with one
    class per tree sums one value each."""
    return ref.gbdt_margins_ref(X, f, t, v, n_classes=f.shape[0]).T


def _leaves_packed(X, f, t, c, v, depth):
    return ref.gbdt_margins_packed_ref(X, f, t, c, v, depth=depth,
                                       n_classes=f.shape[0]).T


def _ensemble(n_classes, rounds, repeat=1, n=600, seed=0):
    """A JAX-trained ensemble (trees repeated ``repeat`` times along T,
    which keeps every tree's class) and features to score."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, n)
    X = rng.normal(0, 1, (n, 19)).astype(np.float32)
    X[:, 0] += y * 1.2
    X[:, 7] += (y == n_classes - 1) * 1.5
    jm = jtrain(X, y, JParams(num_rounds=rounds, n_classes=n_classes))
    jm.feature = np.tile(jm.feature, (repeat, 1))
    jm.threshold = np.tile(jm.threshold, (repeat, 1))
    jm.value = np.tile(jm.value, (repeat, 1))
    return jm, X


@pytest.mark.parametrize("K,rounds,repeat,B", [
    (3, 20, 1, 1), (3, 20, 1, 64), (3, 60, 1, 16), (2, 30, 1, 7),
    (3, 60, 10, 16)])
def test_tree_fold_matches_jax_ref_and_pallas(K, rounds, repeat, B):
    """The fold of the plain walks' leaves against the JAX dense and packed
    oracles and Pallas kernels (interpret mode); the dense and packed
    walks give the same leaves, so their folds agree bit for bit (K5 ==
    K4 + base score on the card)."""
    jm, X = _ensemble(K, rounds, repeat)
    X = X[:B]
    jp = jpack(jm)
    T = jm.feature.shape[0]
    assert T == K * rounds * repeat
    dense = [torch.as_tensor(np.ascontiguousarray(a)) for a in (
        jm.feature.astype(np.int32), jm.threshold, jm.value)]
    packed = [torch.as_tensor(a) for a in (jp.pfeat, jp.pthr, jp.pchild,
                                           jp.pvalue)]
    x = torch.as_tensor(X)
    ld = _leaves_dense(x, *dense)
    lp = _leaves_packed(x, *packed, jp.depth)
    assert torch.equal(ld, lp)
    got = tree_fold(lp, K)
    assert torch.equal(got, tree_fold(ld, K))
    tol = dict(atol=1e-5, rtol=1e-6 if repeat > 1 else 0)
    jd = tuple(jnp.asarray(a.numpy()) for a in dense)
    jpk = tuple(jnp.asarray(a.numpy()) for a in packed)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.gbdt_margins_ref(
            jnp.asarray(X), *jd, n_classes=K)), **tol)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.gbdt_margins_packed_ref(
            jnp.asarray(X), *jpk, depth=jp.depth, n_classes=K)), **tol)
    if repeat == 1:             # the interpreted grid is slow at T 1800
        np.testing.assert_allclose(got.numpy(), np.asarray(
            gbdt_margins_kernel(jnp.asarray(X), *jd, n_classes=K,
                                interpret=True)), **tol)
        np.testing.assert_allclose(got.numpy(), np.asarray(
            gbdt_margins_packed_kernel(jnp.asarray(X), *jpk, depth=jp.depth,
                                       n_classes=K, interpret=True)), **tol)
    pm = GBDTModel(jm.feature, jm.threshold, jm.value, K, jm.max_depth)
    np.testing.assert_allclose(got.numpy(), pm.predict_margin_dense(X, "cpu"),
                               **tol)


def test_empty_chunk_lanes_fold_in_as_identity():
    """Zero-padded lanes of a chunk leave the butterfly's sum unchanged:
    a slice of one group folds to that group's values, and three trees of
    one class fold as (a + c) + b (lanes a, b, c, 0; offsets 2, then 1)."""
    a, b, c = np.float32(1.0), np.float32(2.0 ** -24), np.float32(-1.0)
    leaves = torch.tensor([[a], [b], [c]], dtype=torch.float32)
    assert torch.equal(tree_fold(leaves, 3), leaves.T)
    got = tree_fold(leaves, 1)
    assert float(got) == (a + c) + b != (a + b) + c
    assert torch.equal(tree_fold(torch.ones(180, 2), 3),
                       torch.full((2, 3), 60.0))


@pytest.mark.parametrize("F,T,K,fits", [
    (19, 180, 3, True), (19, 1800, 3, True), (19, 3 * 100_000, 3, True),
    (19, 8 * 60_000, 1, False), (60_000, 3, 3, False)])
def test_capacity_check_is_what_the_kernel_needs(F, T, K, fits):
    """The trees themselves never limit the ensemble (a slice that does
    not fit is streamed); one row's features, the largest slice's leaf
    values and the partials must fit a block's shared memory."""
    if fits:
        _check_fits(F, T, K)
    else:
        with pytest.raises(ValueError):
            _check_fits(F, T, K)
