"""Speculative decoding lanes demo: draft-verify decode, bitwise-safe.

    PYTHONPATH=src python examples_torch/speculative_serve.py                # the card
    PYTHONPATH=src python examples_torch/speculative_serve.py --device cpu

A reduced smollm backbone decodes 7 requests through 3 lanes twice, with
a draft model proposing K=3 tokens per round and the target verifying
all of them in ONE forward (``SpeculativeLaneDecoder``).  Accepted
tokens are the target's own argmaxes, so the output is bitwise-identical
to plain fused decode no matter how good the draft is — the draft moves
throughput, never content:

* draft = the target's own weights -> near-100% acceptance (each
  verify round commits K+1 tokens);
* draft = an independently-initialised model -> ~0% acceptance (every
  round still makes 1 token of progress: the bonus token).

Per-request acceptance rates feed the scheduler (``Request.accept_rate``,
policy ``sjf_effective``) and the wasted draft positions fold into the
engine's ``dead_steps`` accounting.  On the card the verify forward runs
K1 once a layer for each of its K+1 positions.
"""

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models.model import resolve_device
from repro_torch.serving.engine import BatchedRealEngine

#: the lane engines' shape, and the draft's proposals a round
LANES = dict(max_len=64, segment_len=4, n_lanes=3)
DRAFT_K = 3


def workload(cfg):
    """The 7 seeded prompts and their token budgets."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in (5, 11, 23, 7, 3, 15, 9)]
    maxes = [10, 25, 6, 18, 4, 12, 9]
    return prompts, maxes


def compare(ref, engines, prompts, maxes):
    """Serial fused decode on ``ref``, then each draft-verify engine of
    ``engines`` ({name: engine}) on the same requests.  Returns
    {name: {"equal", "outs"}}."""
    want = [ref.generate_reference(p, max_new_tokens=m)["tokens"]
            for p, m in zip(prompts, maxes)]
    print(f"reference: {sum(len(w) for w in want)} tokens over "
          f"{len(prompts)} requests (serial fused decode)")
    out = {}
    for name, eng in engines.items():
        outs = eng.generate_batch(prompts, max_new_tokens=maxes)
        ok = all(list(o["tokens"]) == list(w) for o, w in zip(outs, want))
        st = eng.lane_manager.stats
        print(f"\n{name}:")
        print(f"  bitwise-equal to fused reference: {ok}")
        print(f"  accept_rate={eng.accept_rate:.3f} "
              f"(drafted {eng.drafted_total}, accepted "
              f"{eng.accepted_total}), dead_steps={eng.dead_steps}")
        print(f"  admitted {st['admitted']} (back-fills "
              f"{st['backfills']}), retired {st['retired']}")
        for o in outs[:3]:
            print(f"    req accept_rate={o['accept_rate']}")
        out[name] = {"equal": ok, "outs": outs}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("smollm-360m").reduced()
    prompts, maxes = workload(cfg)
    ref = BatchedRealEngine(cfg, seed=0, device=device, **LANES)
    sd = ref.lm.state_dict()
    engines = {
        "agreeing draft (target params)": BatchedRealEngine(
            cfg, seed=0, state_dict=sd, draft_cfg=cfg,
            draft_state_dict=sd, draft_k=DRAFT_K, device=device, **LANES),
        "independent draft (seed 7)": BatchedRealEngine(
            cfg, seed=0, state_dict=sd, draft_cfg=cfg, draft_k=DRAFT_K,
            draft_seed=7, device=device, **LANES),
    }
    return compare(ref, engines, prompts, maxes)


if __name__ == "__main__":
    main()
