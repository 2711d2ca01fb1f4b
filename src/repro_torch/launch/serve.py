"""End-to-end serving run: the paper's deployment, as a CLI (port of
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --policy sjf \
        --requests 100 --replicas 1 --rho 0.74

Trains the predictor on the sharegpt-profile corpus, calibrates tau =
3 x mu_short on the target service-time model, then serves a mixed workload
under the chosen policy and prints the per-class latency percentiles — the
one-command version of the paper's §5.4 experiment.  The replicas are
virtual-time ``SimEngine``s; the predictor scores the admission burst on
``--device`` (the card by default, through K5; ``--device cpu`` runs its
plain version).
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.calibration import calibrate_tau
from repro_torch.core.gbdt import GBDTParams
from repro_torch.core.policy import get_policy, registered_names
from repro_torch.core.predictor import Predictor
from repro_torch.core.simulation import ServiceDist
from repro_torch.data.corpus import CLASS_NAMES, sample_dataset
from repro_torch.models.model import resolve_device
from repro_torch.serving.openai_api import CompletionRequest
from repro_torch.serving.server import ClairvoyantServer
from repro_torch.serving.service_time import (ServiceTimeModel,
                                              expected_speedup)


def build_predictor(dataset: str = "sharegpt", rounds: int = 120,
                    seed: int = 42, device=None) -> Predictor:
    ds = sample_dataset(dataset, n=6000, seed=seed, balanced=True)
    return Predictor.train(ds.prompts, ds.lengths,
                           GBDTParams(num_rounds=rounds), device=device)


def tau_for(model: ServiceTimeModel, multiplier: float) -> float:
    """tau = multiplier x mu_short, measured under mixed queueing
    conditions (§3.4): the DES over a burst of 60- and 1400-token
    responses priced by ``model``."""
    short_dist = ServiceDist(model.service(64, 60),
                             0.3 * model.service(64, 60))
    long_dist = ServiceDist(model.service(64, 1400),
                            0.3 * model.service(64, 1400))
    return calibrate_tau(short_dist, long_dist, multiplier=multiplier)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", default="sjf",
                    choices=sorted(registered_names()))
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--arch", default="gemma3-4b-edge",
                    help="backend arch for the service-time model")
    ap.add_argument("--chips", type=int, default=1)
    ap.add_argument("--rho", type=float, default=0.0,
                    help=">0: Poisson arrivals at this utilisation; "
                         "0: concurrent burst")
    ap.add_argument("--tau-mult", type=float, default=3.0)
    ap.add_argument("--dataset", default="sharegpt")
    ap.add_argument("--speculative", action="store_true",
                    help="mirror draft-verify decode in the service-time "
                         "model: decode runs at the expected speculative "
                         "speedup of --accept-rate")
    ap.add_argument("--draft-model", default=None,
                    help="draft arch: sets the draft/target cost ratio "
                         "from the two archs' active parameter counts "
                         "(default 0.15)")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="draft tokens proposed per verify step")
    ap.add_argument("--accept-rate", type=float, default=0.7,
                    help="assumed draft acceptance rate")
    ap.add_argument("--trace-out", default=None,
                    help="enable the flight recorder and write a "
                         "Chrome/Perfetto trace_event JSON of the "
                         "drain's span timeline here (virtual time)")
    ap.add_argument("--device", default=None,
                    help="where the predictor scores (default: the CUDA "
                         "card; 'cpu' runs the plain versions)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    model = ServiceTimeModel.from_arch(cfg, chips=args.chips)
    if args.speculative:
        from dataclasses import replace as _replace
        draft_cost = 0.15
        if args.draft_model:
            dcfg = get_config(args.draft_model)
            draft_cost = (dcfg.active_param_count()
                          / cfg.active_param_count())
        rate = float(expected_speedup(args.accept_rate, args.draft_k,
                                      draft_cost))
        model = _replace(model, effective_rate=rate)
        print(f"speculative mirror: K={args.draft_k} "
              f"accept={args.accept_rate} draft_cost={draft_cost:.3f} "
              f"-> expected speedup {rate:.2f}x")
    rng = np.random.default_rng(args.seed)

    predictor = build_predictor(args.dataset, device=device) \
        if get_policy(args.policy).uses_predictor else None

    tau = tau_for(model, args.tau_mult)
    print(f"calibrated tau = {tau:.2f}s")

    server = ClairvoyantServer(policy=args.policy, tau=tau,
                               n_replicas=args.replicas,
                               predictor=predictor, service_model=model,
                               seed=args.seed)
    if args.trace_out:
        from repro_torch.serving.observability import Observability
        server.attach_observability(Observability.default(tracing=True))

    ds = sample_dataset(args.dataset, n=args.requests, seed=args.seed + 1)
    if args.rho > 0:
        es = np.mean([server.service_model.service(64, int(l))
                      for l in ds.lengths])
        lam = args.rho / es
        arrivals = np.cumsum(rng.exponential(1 / lam, args.requests))
    else:
        arrivals = rng.uniform(0, 0.05, args.requests)  # burst (<=50 ms)

    # batched admission: ONE feature-extraction + GBDT call for the burst
    server.submit_many(
        [CompletionRequest(prompt=ds.prompts[i])
         for i in range(args.requests)],
        arrivals=[float(a) for a in arrivals],
        true_output_tokens=[int(l) for l in ds.lengths],
        klasses=[CLASS_NAMES[int(c)] for c in ds.classes])
    server.drain()

    if args.trace_out:
        rec = server.obs.recorder
        rec.write_perfetto(args.trace_out)
        print(f"perfetto trace ({len(rec)} spans) -> {args.trace_out}")
    print(f"policy={args.policy} replicas={args.replicas} "
          f"promotions={server.promotions}")
    for klass in ("short", "long"):
        print(f"  {klass:6s} P50={server.percentile(50, klass):8.2f}s "
              f"P95={server.percentile(95, klass):8.2f}s "
              f"P99={server.percentile(99, klass):8.2f}s")
    return server


if __name__ == "__main__":
    main()
