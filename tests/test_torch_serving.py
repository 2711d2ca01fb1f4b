"""The port's admission layer and front end against the JAX package's:
features, GBDT training and scoring, the SJF queue, the corpus and the
tokenizer, and the end-to-end burst of benchmarks/serve_bench.py served by
both servers on the same weights.

Exact equality wherever the port copies numpy code (features, trees,
queue decisions, corpus, token ids).  P(Long) is held at atol 1e-6: the
JAX predictor scores through its packed host path, the port through the
K4 walk (its plain version here), and the margins agree to the 1e-4 of
tests/test_kernels.py or better.
"""

import jax
import numpy as np
import pytest

from repro.configs import get_config
from repro.core import features as jfeatures
from repro.core.gbdt import GBDTParams as JParams
from repro.core.gbdt import train_gbdt as jtrain
from repro.core.predictor import Predictor as JPredictor
from repro.core.scheduler import Request as JRequest
from repro.core.scheduler import SJFQueue as JQueue
from repro.data.corpus import sample_dataset as jsample
from repro.data.tokenizer import HashTokenizer as JTokenizer
from repro.serving.engine import RealEngine as JEngine
from repro.serving.openai_api import CompletionRequest as JCompletion
from repro.serving.server import ClairvoyantServer as JServer
from repro_torch.configs import get_config as port_config
from repro_torch.core import features
from repro_torch.core.gbdt import GBDTModel, GBDTParams, train_gbdt
from repro_torch.core.predictor import Predictor, class_labels
from repro_torch.core.scheduler import Request, SJFQueue
from repro_torch.data.corpus import sample_dataset
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.models.bridge import params_from_jax
from repro_torch.serving.engine import RealEngine
from repro_torch.serving.openai_api import CompletionRequest
from repro_torch.serving.server import ClairvoyantServer

EDGE_PROMPTS = [
    "", "?", "   ", "What is a binary search tree?  \n",
    "  explain, briefly: tl;dr", "Write a Python function that sorts",
    "so that such that which whom", "résumé naïve — write an essay?",
    "Summarise THE roman empire as a table.", "short.answer in one sentence",
]


@pytest.fixture(scope="module")
def dataset():
    ds = jsample("sharegpt", n=600, seed=42, balanced=True)
    port = sample_dataset("sharegpt", n=600, seed=42, balanced=True)
    assert port.prompts == ds.prompts
    np.testing.assert_array_equal(port.lengths, ds.lengths)
    np.testing.assert_array_equal(port.classes, ds.classes)
    return ds


# -------------------------------------------------------------- features
def test_extract_batch_equals_jax(dataset):
    prompts = dataset.prompts + EDGE_PROMPTS
    got = features.extract_batch(prompts)
    np.testing.assert_array_equal(got, jfeatures.extract_batch(prompts))
    for p in EDGE_PROMPTS + dataset.prompts[:50]:
        np.testing.assert_array_equal(features.extract(p),
                                      jfeatures.extract(p))


# ------------------------------------------------------------------ GBDT
@pytest.mark.parametrize("subsample", [1.0, 0.7])
def test_train_gbdt_trees_equal_jax(dataset, subsample):
    X = features.extract_batch(dataset.prompts[:300])
    y = class_labels(dataset.lengths[:300])
    kw = dict(num_rounds=4, subsample=subsample)
    got = train_gbdt(X, y, GBDTParams(**kw))
    want = jtrain(X, y, JParams(**kw))
    for name in ("feature", "threshold", "value"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert (got.n_classes, got.max_depth) == (want.n_classes, want.max_depth)


def test_p_long_matches_jax(dataset):
    """Same prompts, same data: the port's predictor (trained by the port)
    and the JAX predictor give the same P(Long)."""
    params = dict(num_rounds=15)
    jpred = JPredictor.train(dataset.prompts, dataset.lengths,
                             JParams(**params))
    pred = Predictor.train(dataset.prompts, dataset.lengths,
                           GBDTParams(**params), device="cpu")
    prompts = dataset.prompts[:200] + EDGE_PROMPTS
    np.testing.assert_allclose(pred.proba_batch(prompts),
                               jpred.proba_batch(prompts), atol=1e-6)
    np.testing.assert_allclose(pred.p_long_batch(prompts),
                               jpred.p_long_batch(prompts), atol=1e-6)


# ----------------------------------------------------------------- queue
@pytest.mark.parametrize("policy", ["fcfs", "sjf", "sjf_oracle"])
def test_sjf_queue_matches_jax(policy):
    """A seeded push/pop/cancel/remove sequence with a finite tau: the
    same pops, promotions and stats in both packages."""
    rng = np.random.default_rng(5)
    port, jq = SJFQueue(policy, tau=0.5), JQueue(policy, tau=0.5)
    now, next_id, trace = 0.0, 0, []
    for _ in range(400):
        now += float(rng.exponential(0.05))
        op = rng.random()
        if op < 0.5:
            kw = dict(req_id=next_id, arrival=now,
                      p_long=float(rng.integers(0, 5)) / 4,
                      true_service=float(rng.exponential(1.0)))
            port.push(Request(**kw))
            jq.push(JRequest(**kw))
            next_id += 1
        elif op < 0.85:
            a, b = port.pop(now), jq.pop(now)
            trace.append(a.req_id if a else None)
            assert (a is None) == (b is None)
            if a is not None:
                assert (a.req_id, a.promoted) == (b.req_id, b.promoted)
        elif op < 0.95:
            victim = int(rng.integers(0, max(next_id, 1)))
            assert port.cancel(victim) == jq.cancel(victim)
        else:
            victim = int(rng.integers(0, max(next_id, 1)))
            a, b = port.remove(victim), jq.remove(victim)
            assert (a is None) == (b is None)
        top_a, top_b = port.peek(), jq.peek()
        assert (top_a is None) == (top_b is None)
        if top_a is not None:
            assert (top_a[0], top_a[1].req_id) == (top_b[0],
                                                   top_b[1].req_id)
        assert len(port) == len(jq)
    for k in ("promotions", "cancellations", "dispatched"):
        assert port.stats[k] == jq.stats[k]
    assert port.stats["promotions"] > 0 and len(set(trace)) > 50


# ------------------------------------------------------------- tokenizer
def test_tokenizer_matches_jax(dataset):
    for vocab in (512, 49152):
        tok, jtok = HashTokenizer(vocab), JTokenizer(vocab)
        for p in dataset.prompts[:100] + EDGE_PROMPTS:
            np.testing.assert_array_equal(tok.encode(p), jtok.encode(p))


# ------------------------------------------------------------ end to end
@pytest.fixture(scope="module")
def burst():
    """The serve_bench burst: 6 long prompts arriving first, then 10 short
    ones, with a predictor trained on a small balanced draw."""
    ds = jsample("sharegpt", n=600, seed=42, balanced=True)
    jpred = JPredictor.train(ds.prompts, ds.lengths, JParams(num_rounds=20))
    m = jpred.model
    pred = Predictor(GBDTModel(m.feature, m.threshold, m.value, m.n_classes,
                               m.max_depth), device="cpu")
    pool = jsample("sharegpt", n=4000, seed=1)
    assert sample_dataset("sharegpt", n=4000, seed=1).prompts == pool.prompts
    shorts = [i for i in range(len(pool)) if pool.lengths[i] < 120][:10]
    longs = [i for i in range(len(pool)) if pool.lengths[i] >= 1000][:6]
    order = longs + shorts
    return {
        "jpred": jpred, "pred": pred,
        "prompts": [pool.prompts[i] for i in order],
        "arrivals": [j * 1e-4 for j in range(len(order))],
        "true_output_tokens": [64 if i in longs else 8 for i in order],
        "klasses": ["long" if i in longs else "short" for i in order]}


@pytest.fixture(scope="module")
def serve_engines():
    jax_eng = JEngine(get_config("smollm-360m").reduced(), max_len=160,
                      segment_len=16, seed=0)
    cfg = port_config("smollm-360m").reduced()
    eng = RealEngine(cfg, max_len=160, segment_len=16, device="cpu",
                     state_dict=params_from_jax(
                         jax.tree.map(np.asarray, jax_eng.params), cfg))
    return jax_eng, eng


@pytest.mark.parametrize("policy", ["fcfs", "sjf"])
def test_burst_dispatch_order_and_tokens_match_jax(burst, serve_engines,
                                                   policy, monkeypatch):
    jax_eng, eng = serve_engines
    jax_tokens = []
    generate = jax_eng.generate

    def recording_generate(ids, **kw):
        out = generate(ids, **kw)
        jax_tokens.append(out["tokens"])
        return out

    monkeypatch.setattr(jax_eng, "generate", recording_generate)
    jax_eng.busy_until = eng.busy_until = 0.0
    kw = {k: burst[k] for k in ("arrivals", "true_output_tokens", "klasses")}
    jserver = JServer(policy=policy, tau=None, engines=[jax_eng],
                      predictor=burst["jpred"] if policy == "sjf" else None)
    jserver.submit_many([JCompletion(prompt=p) for p in burst["prompts"]],
                        **kw)
    jserver.drain(max_new_tokens=64)
    server = ClairvoyantServer(policy=policy, tau=None, engines=[eng],
                               predictor=burst["pred"] if policy == "sjf"
                               else None)
    server.submit_many([CompletionRequest(prompt=p)
                        for p in burst["prompts"]], **kw)
    resp = server.drain(max_new_tokens=64)

    assert [r.request_id for r in resp] == \
        [r.request_id for r in jserver.responses]
    assert [r.token_ids for r in resp] == jax_tokens
    assert all(r.ok for r in resp) and len(resp) == 16
    np.testing.assert_allclose([r.p_long for r in resp],
                               [r.p_long for r in jserver.responses],
                               atol=1e-6)
    assert [r.tokens_generated for r in resp] == \
        [r.tokens_generated for r in jserver.responses]
    if policy == "fcfs":
        assert [r.request_id for r in resp] == list(range(1, 17))
    else:       # SJF serves the predicted-short requests first
        assert resp[0].p_long <= min(r.p_long for r in resp)
        assert server.percentile(50, "short") < server.percentile(50, "long")
