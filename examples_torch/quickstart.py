"""Quickstart: train the Clairvoyant predictor and schedule a mixed burst.

    PYTHONPATH=src python examples_torch/quickstart.py                # the card
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu

Walks the paper end-to-end in miniature: synthesize a ShareGPT-profile
corpus -> extract the 19 lexical features -> train the GBDT -> check ranking
accuracy -> run FCFS vs SJF on a burst and print the short-request speedup.
Prompts are scored through the packed ensemble (K5 on the card, its plain
PyTorch version with ``--device cpu``); without a card and without
``--device`` the script raises.
"""

import argparse

import numpy as np

from repro_torch.core.gbdt import GBDTParams
from repro_torch.core.predictor import Predictor
from repro_torch.core.ranking import ranking_accuracy
from repro_torch.core.scheduler import Request
from repro_torch.core.simulation import simulate
from repro_torch.data.corpus import sample_dataset
from repro_torch.models.model import resolve_device
from repro_torch.serving.service_time import PAPER_4090_LONG, PAPER_4090_SHORT


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. data + predictor ---------------------------------------------------
    train = sample_dataset("sharegpt", n=3000, seed=0, balanced=True)
    test = sample_dataset("sharegpt", n=900, seed=1, balanced=True)
    print(f"training on {len(train)} prompts...")
    pred = Predictor.train(train.prompts, train.lengths,
                           GBDTParams(num_rounds=100), device=device)
    scores = pred.p_long_batch(test.prompts)
    ra = ranking_accuracy(test.lengths, scores)
    print(f"ranking accuracy: {100*ra:.1f}%  (paper band 62-96%)")

    # 2. one prediction, the admission path ---------------------------------
    prompt = "Write a detailed essay about the roman empire"
    print(f"P(Long) for {prompt!r}: {pred.p_long(prompt):.3f}")
    prompt2 = "What is photosynthesis? briefly"
    print(f"P(Long) for {prompt2!r}: {pred.p_long(prompt2):.3f}")

    # 3. burst: FCFS vs SJF -------------------------------------------------
    rng = np.random.default_rng(2)
    ds = sample_dataset("sharegpt", n=3000, seed=3)
    shorts = [i for i in range(len(ds)) if ds.lengths[i] < 200][:50]
    longs = [i for i in range(len(ds)) if ds.lengths[i] >= 800][:50]
    scores = pred.p_long_batch([ds.prompts[i] for i in shorts + longs])
    # fixed service draws + random arrival order (fair FCFS baseline)
    services = [float((PAPER_4090_SHORT if j < 50 else PAPER_4090_LONG)
                      .sample(rng)) for j in range(100)]
    arrivals = rng.permutation(100) * 1e-4

    def reqs():
        return [Request(req_id=j, arrival=float(arrivals[j]),
                        p_long=float(scores[j]), true_service=services[j],
                        klass="short" if j < 50 else "long")
                for j in range(100)]

    fcfs = simulate(reqs(), policy="fcfs")
    sjf = simulate(reqs(), policy="sjf")
    f50 = fcfs.percentile(50, "short")
    s50 = sjf.percentile(50, "short")
    print(f"burst of 100: short P50 FCFS={f50:.0f}s SJF={s50:.0f}s "
          f"(-{100*(1-s50/f50):.0f}%)")
    return {"ranking_accuracy": ra, "fcfs_short_p50": f50,
            "sjf_short_p50": s50}


if __name__ == "__main__":
    main()
