"""KV-budgeted micro-batching demo: a 4-lane drain with real decode.

    PYTHONPATH=src python examples_torch/batched_serve.py                # the card
    PYTHONPATH=src python examples_torch/batched_serve.py --device cpu

A reduced smollm backbone decodes 10 requests through 4 concurrent lanes
under an explicit KV-memory budget (``BatchedRealEngine``): admission is
policy-ordered (sjf_oracle here — no predictor training, to keep the
demo fast), finished lanes retire at fused-decode segment boundaries and
the vacant cache slot is back-filled from the queue by a fresh prefill.
Every token sequence is bitwise-identical to a serial greedy run — the
lanes change throughput, never output.  A second pass with a budget of
~1.5 lanes shows memory-aware admission serializing the same workload.
On the card each prefill runs K3 and each lane step K1, once a layer.
"""

import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models.model import resolve_device
from repro_torch.serving.batching import kv_bytes_per_token
from repro_torch.serving.engine import BatchedRealEngine
from repro_torch.serving.openai_api import CompletionRequest
from repro_torch.serving.server import ClairvoyantServer

#: the lane engines' shape (both passes)
LANES = dict(max_len=96, segment_len=8, n_lanes=4)


def drain(engine, n=10):
    server = ClairvoyantServer(policy="sjf_oracle", tau=None,
                               engines=[engine])
    rng = np.random.default_rng(0)
    lengths = rng.integers(4, 28, n)
    server.submit_many(
        [CompletionRequest(prompt=f"request number {i} "
                           + "lorem ipsum " * int(rng.integers(1, 6)))
         for i in range(n)],
        true_output_tokens=[int(x) for x in lengths],
        klasses=["short" if x < 16 else "long" for x in lengths])
    t0 = time.perf_counter()
    server.drain(max_new_tokens=28)
    wall = time.perf_counter() - t0
    return server, wall


def warm(engine, cfg):
    """One small batch first, so the printed walls show steady-state
    serving rather than first-call set-up."""
    engine.generate_batch([np.arange(p) % cfg.vocab_size
                           for p in (8, 16, 24, 40)], max_new_tokens=4)


def serve(cfg, eng4, tight_engine):
    """Both passes: ``eng4`` at its full budget, then the engine that
    ``tight_engine(budget_bytes)`` builds on the same weights at ~55% of
    the first pass's peak KV.  Returns both servers and whether every
    request's token count agrees across them."""
    warm(eng4, cfg)
    server, wall4 = drain(eng4)
    toks = sum(r.tokens_generated for r in server.responses)
    st = eng4.lane_manager.stats
    print(f"\n4 lanes, budget {eng4.budget_bytes} B: {toks} tokens in "
          f"{wall4*1e3:.0f} ms ({toks/wall4:.0f} tok/s aggregate)")
    print(f"  admitted {st['admitted']} (back-fills {st['backfills']}), "
          f"peak KV {eng4.lane_manager.budget.peak_bytes} B")
    for r in sorted(server.responses, key=lambda r: r.queue_wait_s)[:4]:
        print(f"  req {r.request_id}: wait {r.queue_wait_s*1e3:6.0f} ms, "
              f"service {r.service_s*1e3:6.0f} ms, "
              f"{r.tokens_generated} tokens [{r.klass}]")

    # same weights, just over half the observed peak KV: admission must
    # block — memory pressure serializes part of the same workload
    tight = tight_engine(int(0.55 * eng4.lane_manager.budget.peak_bytes))
    warm(tight, cfg)
    server_t, wall_t = drain(tight)
    st = tight.lane_manager.stats
    toks_t = sum(r.tokens_generated for r in server_t.responses)
    print(f"\nsame 4 lanes, budget {tight.budget_bytes} B "
          f"(~55% of the 4-lane peak): {toks_t} tokens in "
          f"{wall_t*1e3:.0f} ms ({toks_t/wall_t:.0f} tok/s)")
    print(f"  admission blocked on budget {st['blocked_on_budget']} times "
          f"— memory pressure serializes, outputs stay identical")

    same = all(a.tokens_generated == b.tokens_generated
               for a, b in zip(sorted(server.responses,
                                      key=lambda r: r.request_id),
                               sorted(server_t.responses,
                                      key=lambda r: r.request_id)))
    print(f"\ntoken counts identical across budgets: {same}")
    return {"servers": (server, server_t), "engines": (eng4, tight),
            "same": same}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("smollm-360m").reduced()
    bpt = kv_bytes_per_token(cfg)
    print(f"model: {cfg.name}, KV bytes/token across the stack: {bpt}")
    eng4 = BatchedRealEngine(cfg, device=device, **LANES)
    return serve(cfg, eng4, lambda budget: BatchedRealEngine(
        cfg, state_dict=eng4.lm.state_dict(), budget_bytes=budget,
        device=device, **LANES))


if __name__ == "__main__":
    main()
