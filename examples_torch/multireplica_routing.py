"""Beyond-paper: predictive routing across replicas with the PR-4 policy
registry — preemptive SRPT placement, per-tenant fair share, hedged
re-routing of overdue requests, and failover.

    PYTHONPATH=src python examples_torch/multireplica_routing.py          # the card
    PYTHONPATH=src python examples_torch/multireplica_routing.py --device cpu

The same P(Long) signal the paper uses for queue ORDERING also improves
PLACEMENT (join-shortest-predicted-work vs blind round-robin across 4
serial replicas).  Policies are first-class registry values
(``repro_torch.core.policy``): the demo flips between the paper's
``sjf``, the preemptive ``srpt`` and two-tenant ``fair_share`` by passing
a policy spec — no per-policy code paths.  Each admission burst is scored
through the packed ensemble (K5 on the card, its plain PyTorch version
with ``--device cpu``); the replicas are virtual-time backends.
"""

import argparse

import numpy as np

from repro_torch.core.gbdt import GBDTParams
from repro_torch.core.policy import WeightedFairShare, get_policy
from repro_torch.core.predictor import Predictor
from repro_torch.data.corpus import sample_dataset
from repro_torch.models.model import resolve_device
from repro_torch.serving.openai_api import CompletionRequest
from repro_torch.serving.server import ClairvoyantServer


def run(policy, pred, n=200, seed=0, jspw=True, tenants=None):
    """One 4-replica drain under a policy spec (registry name or Policy
    instance); ``jspw=False`` swaps in blind round-robin placement."""
    pol = get_policy(policy)
    server = ClairvoyantServer(policy=pol, tau=None, n_replicas=4,
                               predictor=pred if pol.uses_predictor
                               else None, seed=seed)
    if not jspw:
        def rr_route(req, proba=None, now=0.0, **kw):
            rep = server.router.replicas[req.req_id % 4]
            rep.queue.push(req)
            return rep.replica_id
        server.router.route = rr_route
    ds = sample_dataset("sharegpt", n=n, seed=seed + 1)
    rng = np.random.default_rng(seed + 2)
    arrivals = np.sort(rng.uniform(0, 5.0, n))
    for i in range(n):
        klass = ("short", "medium", "long")[int(ds.classes[i])]
        tenant = tenants[i % len(tenants)] if tenants else "default"
        server.submit(CompletionRequest(prompt=ds.prompts[i], tenant=tenant),
                      arrival=float(arrivals[i]),
                      true_output_tokens=int(ds.lengths[i]), klass=klass)
    server.drain()
    return server


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    train = sample_dataset("sharegpt", n=2400, seed=0, balanced=True)
    pred = Predictor.train(train.prompts, train.lengths,
                           GBDTParams(num_rounds=80), device=device)

    # --- policy registry sweep over the same 4-replica fleet ---------------
    print("4 replicas, 200 mixed requests (JSPW placement):")
    rr = run("sjf", pred, jspw=False)
    rows = [("sjf round-robin", rr)]
    for policy in ("sjf", "srpt", "sjf_quantile"):
        rows.append((policy + " JSPW", run(policy, pred)))
    for name, s in rows:
        print(f"  {name:16s}: short P50 {s.percentile(50, 'short'):7.2f}s "
              f"P95 {s.percentile(95, 'short'):7.2f}s | "
              f"long P95 {s.percentile(95, 'long'):7.2f}s")

    # --- per-tenant fair share: a flooding tenant only delays itself ------
    fs = WeightedFairShare(weights=(("light", 1.0), ("heavy", 1.0)))
    # 7 of 8 requests belong to "heavy"; fair share keeps "light" flowing
    tenants = ["heavy"] * 7 + ["light"]
    fair = run(fs, pred, tenants=tenants)
    plain = run("fcfs", pred, tenants=tenants)
    for name, s in (("fcfs", plain), ("fair_share", fair)):
        waits = {}
        for r in s.responses:
            req = s._inflight.get(r.request_id)
            waits.setdefault(req.tenant if req else "?", []).append(
                r.queue_wait_s)
        light = float(np.mean(waits.get("light", [0.0])))
        heavy = float(np.mean(waits.get("heavy", [0.0])))
        print(f"  {name:11s}: light-tenant mean wait {light:6.2f}s "
              f"vs heavy {heavy:6.2f}s")

    # --- hedge_overdue: re-route requests that missed their deadline ------
    server = ClairvoyantServer(policy="sjf", tau=None, n_replicas=4,
                               predictor=pred, seed=5)
    ds = sample_dataset("sharegpt", n=80, seed=6)
    for i in range(80):
        klass = ("short", "medium", "long")[int(ds.classes[i])]
        # 10 stale requests queued at t=0 (a straggling replica held them);
        # the rest arrived recently and are within deadline
        arrival = 0.0 if i < 10 else 25.0
        server.submit(CompletionRequest(prompt=ds.prompts[i]),
                      arrival=arrival,
                      true_output_tokens=int(ds.lengths[i]), klass=klass)
    moved = server.router.hedge_overdue(now=30.0, deadline=20.0)
    print(f"hedged dispatch: {len(moved)} of 80 queued requests exceeded "
          f"the 20 s queue-wait deadline at t=30 and were re-routed to the "
          f"least-loaded other replica "
          f"(hedged={server.router.stats['hedged']})")
    server.drain()
    print(f"  drained {len(server.responses)} of 80 after hedging")
    hedged = server

    # --- failover: kill a replica with a loaded queue ----------------------
    server = ClairvoyantServer(policy="sjf", tau=None, n_replicas=4,
                               predictor=pred, seed=9)
    ds = sample_dataset("sharegpt", n=100, seed=10)
    for i in range(100):
        klass = ("short", "medium", "long")[int(ds.classes[i])]
        server.submit(CompletionRequest(prompt=ds.prompts[i]),
                      true_output_tokens=int(ds.lengths[i]), klass=klass)
    victim = max(server.router.queue_lengths(),
                 key=server.router.queue_lengths().get)
    moved = server.router.fail_replica(victim, now=0.0)
    server.drain()
    print(f"failed replica {victim}: {len(moved)} requests requeued, "
          f"{len(server.responses)} of 100 served "
          f"(failed_over={server.router.stats['failed_over']})")
    return {"hedge_drained": len(hedged.responses),
            "failover_served": len(server.responses)}


if __name__ == "__main__":
    main()
