"""The public API the port copies from the JAX package, held to it on the
same seeded numpy inputs:

* ``core.features``: ``FEATURE_GROUPS``, ``leading_verb`` and the
  seed-style ``extract_reference`` equal JAX's on the feature tests'
  prompts and on 500 sampled prompts; the port's ``extract_reference``
  equals its ``extract`` bit for bit.
* ``core.gbdt``: ``train_gbdt_reference`` grows the JAX trees bit for
  bit; ``save``/``load`` round-trip within each package and across them;
  ``num_trees``; ``predict_p_long`` within 1e-5 of JAX's.
* ``core.ensemble_pack``: ``bin_input`` bit for bit, ``predict_margin``,
  ``predict_proba`` and ``predict_p_long`` (K5's plain version on the
  CPU) within 1e-5 of the JAX host scorers.
* ``HashTokenizer.encode_batch`` bit for bit; ``SimEngine.execute``'s
  tuple and clock; ``RealEngine.generate_batch`` equal to per-request
  ``generate`` and to JAX's ``generate_batch`` on carried weights
  (float32, TF32 off).
* ``LM.param_count_actual`` equals ``cfg.param_count()`` for all eleven
  archs, reduced on the CPU and full on the ``meta`` device.
* No public name of the JAX package is missing from the port except
  those listed in ``UNCOPIED``, each with its reason.
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import ast
import importlib
import pickle
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jconfig
from repro.core import ensemble_pack as jpack
from repro.core import features as jfeatures
from repro.core import gbdt as jgbdt
from repro.data.corpus import sample_dataset as jsample
from repro.data.tokenizer import HashTokenizer as JTokenizer
from repro.serving.engine import RealEngine as JEngine
from repro.serving.engine import SimEngine as JSimEngine
from repro.serving.service_time import ServiceTimeModel as JServiceModel
from repro_torch.configs import ALL_ARCH_NAMES, get_config
from repro_torch.core import ensemble_pack, features, gbdt
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.models.bridge import params_from_jax
from repro_torch.models.model import LM
from repro_torch.serving.engine import RealEngine, SimEngine
from repro_torch.serving.service_time import ServiceTimeModel

ROOT = Path(__file__).resolve().parents[1]
_MISSING = object()
SCORE_TOL = dict(atol=1e-5, rtol=0)


def _feature_prompts():
    """The feature tests' prompts and a seeded sample of 500 corpus
    prompts."""
    spec = importlib.util.spec_from_file_location(
        "jax_feature_tests", ROOT / "tests" / "test_features.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._random_corpus() + list(
        jsample("sharegpt", n=500, seed=7).prompts)


# ------------------------------------------------------------- features
def test_feature_groups_equal_jax():
    assert features.FEATURE_GROUPS == jfeatures.FEATURE_GROUPS


def test_leading_verb_and_extract_reference_equal_jax():
    prompts = _feature_prompts()
    assert len(prompts) > 3000
    for p in prompts:
        assert features.leading_verb(p) == jfeatures.leading_verb(p), p
        got = features.extract_reference(p)
        assert got.dtype == np.float32
        assert np.array_equal(got, jfeatures.extract_reference(p)), p
        assert np.array_equal(got, features.extract(p)), p


# ----------------------------------------------------------------- GBDT
def _problem(n=900, seed=5):
    """tests/test_gbdt.py's separable problem."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, n)
    X = rng.normal(0, 1, (n, 19)).astype(np.float32)
    X[:, 0] += y * 1.5
    X[:, 4] += (y == 2) * 2.0
    return X, y


def _fields(m):
    return (m.feature, m.threshold, m.value, m.n_classes, m.max_depth,
            m.base_score)


def _assert_same_model(a, b):
    fa, fb = _fields(a), _fields(b)
    for x, y in zip(fa[:3], fb[:3]):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert fa[3:] == fb[3:]


@pytest.mark.parametrize("params", [
    dict(num_rounds=25), dict(num_rounds=15, subsample=0.7)])
def test_train_gbdt_reference_grows_the_jax_trees(params):
    """The seed trainer on tests/test_gbdt.py's data and parameters."""
    X, y = _problem()
    want = jgbdt.train_gbdt_reference(X, y, jgbdt.GBDTParams(**params))
    got = gbdt.train_gbdt_reference(X, y, gbdt.GBDTParams(**params))
    _assert_same_model(got, want)
    assert got.num_trees == want.num_trees == 3 * params["num_rounds"]


@pytest.fixture(scope="module")
def models():
    """A JAX model trained by the fast trainer and the port's copy of it
    (same trees), with a nonzero base score."""
    X, y = _problem(1200, seed=0)
    jm = jgbdt.train_gbdt(X, y, jgbdt.GBDTParams(num_rounds=30))
    jm.base_score = 0.25
    pm = gbdt.GBDTModel(jm.feature, jm.threshold, jm.value, jm.n_classes,
                        jm.max_depth, jm.base_score)
    rng = np.random.default_rng(3)
    Xs = {"burst": rng.normal(0, 1.5, (257, 19)).astype(np.float32),
          "small": rng.normal(0, 1.5, (7, 19)).astype(np.float32),
          "one": X[:1]}
    return jm, pm, Xs


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("reader", ["jax", "port"])
def test_save_load_round_trips_within_and_across_packages(models, tmp_path,
                                                          writer, reader):
    jm, pm, Xs = models
    pm.predict_margin(Xs["small"], "cpu")          # fills the port caches
    path = str(tmp_path / "model.pkl")
    (jm if writer == "jax" else pm).save(path)
    with open(path, "rb") as f:
        fields = pickle.load(f)
    assert sorted(fields) == ["base_score", "feature", "max_depth",
                              "n_classes", "threshold", "value"]
    loaded = (jgbdt.GBDTModel if reader == "jax"
              else gbdt.GBDTModel).load(path)
    _assert_same_model(loaded, jm)
    assert type(loaded).__module__ == \
        ("repro.core.gbdt" if reader == "jax" else "repro_torch.core.gbdt")


def test_num_trees_and_predict_p_long_match_jax(models):
    jm, pm, Xs = models
    assert pm.num_trees == jm.num_trees == 90
    for X in Xs.values():
        np.testing.assert_allclose(pm.predict_p_long(X, device="cpu"),
                                   jm.predict_p_long(X), **SCORE_TOL)
        np.testing.assert_allclose(pm.predict_p_long(X, 1, "cpu"),
                                   jm.predict_p_long(X, 1), **SCORE_TOL)


def test_predict_margin_is_the_packed_ensembles(models):
    """``GBDTModel.predict_margin`` is ``packed().predict_margin``, bit for
    bit, and needs a device or a card."""
    _, pm, Xs = models
    for X in Xs.values():
        assert np.array_equal(pm.predict_margin(X, "cpu"),
                              pm.packed().predict_margin(X, "cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pm.packed().predict_proba(Xs["one"])


def test_packed_ensemble_scorers_match_jax(models):
    jm, pm, Xs = models
    jp, pp = jpack.pack_ensemble(jm), ensemble_pack.pack_ensemble(pm)
    nan = Xs["small"].copy()
    nan[2, 0] = np.nan                 # the searchsorted path
    for X in list(Xs.values()) + [nan]:
        got = pp.bin_input(X)
        assert got.dtype == np.uint16
        assert np.array_equal(got, jp.bin_input(X))
    for X in Xs.values():
        np.testing.assert_allclose(pp.predict_margin(X, "cpu"),
                                   jp.predict_margin(X), **SCORE_TOL)
        np.testing.assert_allclose(pp.predict_proba(X, "cpu"),
                                   jp.predict_proba(X), **SCORE_TOL)
        np.testing.assert_allclose(pp.predict_p_long(X, device="cpu"),
                                   jp.predict_p_long(X), **SCORE_TOL)
        np.testing.assert_allclose(pp.predict_p_long(X, 0, "cpu"),
                                   jp.predict_p_long(X, 0), **SCORE_TOL)
    empty = np.zeros((0, 19), np.float32)
    assert pp.predict_margin(empty, "cpu").shape == (0, 3)
    assert np.array_equal(pp.predict_margin(empty, "cpu"),
                          jp.predict_margin(empty))


# -------------------------------------------------------- tokenizer, sim
def test_encode_batch_equals_jax():
    texts = list(jsample("sharegpt", n=64, seed=3).prompts) + ["", "a b"]
    for vocab, pad in ((512, 8), (49152, 64), (32000, 300)):
        got = HashTokenizer(vocab).encode_batch(texts, pad)
        want = JTokenizer(vocab).encode_batch(texts, pad)
        assert got.dtype == want.dtype == np.int32
        assert np.array_equal(got, want)


def test_sim_engine_execute_equals_jax():
    kw = dict(prefill_tok_per_s=8000.0, decode_tok_per_s=60.0,
              overhead_s=0.05)
    eng, jeng = (SimEngine(ServiceTimeModel(**kw), replica_id=2),
                 JSimEngine(JServiceModel(**kw), replica_id=2))
    rng = np.random.default_rng(0)
    start = 0.0
    for _ in range(20):
        p, o = int(rng.integers(1, 2000)), int(rng.integers(1, 3000))
        got, want = eng.execute(start, p, o), jeng.execute(start, p, o)
        assert got == want
        assert (eng.busy_until, eng.served) == (jeng.busy_until,
                                                jeng.served)
        start = eng.busy_until + float(rng.uniform(0, 1))
    assert eng.engine_stats() == jeng.engine_stats()


# ------------------------------------------------------- generate_batch
@pytest.fixture(scope="module")
def serial_engines():
    """The JAX serial engine on reduced smollm (float32, seed 0) and the
    port's on its weights."""
    torch.backends.cuda.matmul.allow_tf32 = False
    jeng = JEngine(jconfig("smollm-360m").reduced(), max_len=64,
                   segment_len=4, seed=0)
    cfg = get_config("smollm-360m").reduced()
    eng = RealEngine(cfg, max_len=64, segment_len=4, device="cpu",
                     state_dict=params_from_jax(
                         jax.tree.map(np.asarray, jeng.params), cfg))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 11, 23, 7, 3)]
    return jeng, eng, prompts


@pytest.mark.parametrize("budget", ["scalar", "per-request"])
def test_real_engine_generate_batch_equals_generate_and_jax(serial_engines,
                                                            budget):
    jeng, eng, prompts = serial_engines
    maxes = 9 if budget == "scalar" else [10, 25, 6, 18, 4]
    got = eng.generate_batch(prompts, max_new_tokens=maxes)
    per = [maxes] * len(prompts) if budget == "scalar" else maxes
    assert len(got) == len(prompts)
    for out, ids, m in zip(got, prompts, per):
        assert out["tokens"] == eng.generate(ids, max_new_tokens=m)["tokens"]
        assert len(out["tokens"]) == m and not out["cancelled"]
    want = jeng.generate_batch(prompts, max_new_tokens=maxes)
    assert [o["tokens"] for o in got] == [list(w["tokens"]) for w in want]


def test_per_request_budgets_shared_by_the_lane_engines():
    from repro_torch.serving.engine import BatchedRealEngine
    assert RealEngine._per_request_budgets([1, 2, 3], 7) == [7, 7, 7]
    assert RealEngine._per_request_budgets([1, 2], np.array([3, 4])) == \
        [3, 4]
    assert BatchedRealEngine._per_request_budgets is \
        RealEngine._per_request_budgets


# ------------------------------------------------------ parameter counts
@pytest.mark.parametrize("name", ALL_ARCH_NAMES)
def test_param_count_actual_equals_the_config(name):
    cfg = get_config(name)
    reduced = cfg.reduced()
    assert LM(reduced, device="cpu").param_count_actual() == \
        reduced.param_count()
    assert LM(cfg, device="meta").param_count_actual() == cfg.param_count()


# ---------------------------------------------------- the API comparison
#: public names of ``src/repro`` the port leaves out, by module, each
#: with its reason (also in ROADMAP.md)
_PALLAS = "a Pallas kernel body: the port's kernel is CUDA C++ in csrc/"
_FUNCTIONAL = ("a JAX functional helper: the port's nn.Module layers and "
               "meta tensors do its work")
_SHARDING = "a JAX sharding helper: DTensor placements do its work"
UNCOPIED = {
    "core/_native.py": {
        "native_scorer": "the host C scorer of the packed layout: the port "
                         "scores it with K5 on the card, K5's plain "
                         "version on the CPU"},
    "core/sim_jax.py": {
        "simulate_grid_jax": "its counterpart is core/sim_torch.py "
                             "simulate_grid_torch"},
    "kernels/decode_attention.py": {
        "NEG_INF": _PALLAS, "decode_attention_kernel": _PALLAS,
        "paged_decode_attention_kernel": _PALLAS},
    "kernels/flash_attention.py": {
        "NEG_INF": _PALLAS, "flash_attention_kernel": _PALLAS},
    "kernels/gbdt_infer.py": {
        "gbdt_margins_kernel": _PALLAS,
        "gbdt_margins_packed_kernel": _PALLAS},
    "kernels/ops.py": {
        n: "the GBDT layout chooser that the port removed: every batch "
           "scores packed (K5)"
        for n in ("gbdt_margins_best", "gbdt_proba",
                  "preferred_gbdt_layout")},
    "launch/dryrun.py": {
        "MAX_UNROLL_LAYERS": "the JAX dry run's unroll limit for its cost "
                             "graph: the port counts FLOPs on meta tensors "
                             "in one pass"},
    "launch/roofline.py": {
        "ICI_BW": "the TPU interconnect's rate: the port's roofline has "
                  "the H100's NVLink instead"},
    "models/attention.py": {
        **{n: _FUNCTIONAL for n in (
            "NEG_INF", "attn_block", "decode_attention", "flash_attention",
            "init_attention", "verify_attention", "xattn_block")},
        "PERF": "a JAX experiment flag (the decode cache's f32 cast)"},
    "models/layers.py": {
        **{n: _FUNCTIONAL for n in (
            "apply_mlp", "init_expert_mlp", "init_mlp", "init_rmsnorm")},
        "PERF": "a JAX experiment flag (bf16 gradient matmuls)"},
    "models/model.py": {n: _FUNCTIONAL for n in (
        "LM.abstract_params", "LM.init", "init_model")},
    "models/moe.py": {n: _FUNCTIONAL for n in ("apply_moe", "init_moe")},
    "models/ssm.py": {n: _FUNCTIONAL for n in (
        "init_mamba", "mamba_block", "mamba_mix")},
    "models/transformer.py": {
        **{n: _FUNCTIONAL for n in (
            "apply_block", "init_block", "run_stack")},
        "SCAN_UNROLL": "the unroll factor of the JAX layer scan: the port "
                       "runs its layers in a Python loop"},
    "models/xlstm.py": {n: _FUNCTIONAL for n in (
        "init_mlstm", "init_slstm", "mlstm_block", "slstm_block")},
    "serving/generate.py": {
        "LaneDecoder.insert_lane": "the JAX single-lane insert, a jit "
                                   "cache helper: the port inserts any "
                                   "number of rows with insert_lanes"},
    "sharding/compat.py": {n: _SHARDING for n in (
        "shard_map_fn", "shard_map_unchecked")},
    "sharding/partition.py": {"tree_shardings": _SHARDING},
    "sharding/rules.py": {"sharding_for": _SHARDING},
}


def _public_names(path: Path) -> set:
    """Module-level functions, classes (and their methods) and constants
    whose names do not start with an underscore."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef):
            out.add(node.name)
            out.update(f"{node.name}.{b.name}" for b in node.body
                       if isinstance(b, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)))
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return {n for n in out if not any(p.startswith("_")
                                      for p in n.split("."))}


def test_no_public_name_of_the_jax_package_is_missing_from_the_port():
    src = ROOT / "src" / "repro"
    missing, listed = {}, set()
    for path in sorted(src.rglob("*.py")):
        rel = path.relative_to(src).as_posix()
        mod_path = rel[:-3].replace("/", ".").replace(".__init__", "")
        mod_path = mod_path.replace("sim_jax", "sim_torch")
        port = importlib.import_module(
            "repro_torch" + ("." + mod_path if mod_path != "__init__"
                             else ""))
        skip = UNCOPIED.get(rel, {})
        for name in sorted(_public_names(path)):
            if name in skip:
                listed.add((rel, name))
                continue
            obj = port
            for part in name.split("."):
                obj = getattr(obj, part, _MISSING)
                if obj is _MISSING:
                    break
            if obj is _MISSING:
                missing.setdefault(rel, []).append(name)
    assert missing == {}
    # every listed name is still a name of the JAX package
    assert listed == {(r, n) for r, names in UNCOPIED.items()
                      for n in names}
