"""Launch the HTTP/SSE sidecar: Clairvoyant behind a real socket (port of
``repro.launch.sidecar``).

    PYTHONPATH=src python -m repro_torch.launch.sidecar --port 8080 \
        --backend real --policy sjf

then talk OpenAI chat-completions to it:

    curl -s localhost:8080/v1/chat/completions -d '{
        "messages": [{"role": "user", "content": "hello"}],
        "max_tokens": 32}'

Backends (one per replica):

* ``sim``  — virtual service times from the arch's ``ServiceTimeModel``,
  slept on the event loop and streamed as synthetic text
  (``--time-scale`` compresses wall time; the default for demos).
* ``real`` — an actual fused decode per request (``RealEngine`` on
  smollm-360m at full width -- all 32 layers, bf16, seeded weights --
  off the event loop via a worker thread), on ``--device``: the CUDA card
  unless ``--device cpu``.  ``--reduced`` serves the tiny same-family
  config (the CPU tests).  Each replica's engine is built once, before
  the listener opens.
* ``http`` — proxy to external OpenAI-compatible upstreams
  (``--upstream host:port``, repeatable), with connect/read timeouts
  feeding the retry policy and per-replica circuit breakers.

The predictor scores each admission on ``--device`` (K5 on the card).
``--port 0`` binds an ephemeral port; the listening line prints the
bound address.  SIGINT/SIGTERM trigger a graceful drain: the listener
closes, in-flight work gets ``--drain-s`` seconds to finish, stragglers
are cancelled at the next segment boundary — every admitted request
still leaves with exactly one terminal status; the report ends with
``drained: N terminals (K ok)`` and a line of the kernel launches the
process made (``kernel launches: {...}``, JSON).

Observability: the main port always serves Prometheus text on
``GET /metrics``; ``--metrics-port`` additionally exposes it on a
dedicated scrape port.  ``--trace-out FILE`` enables the flight recorder
and writes a Chrome/Perfetto ``trace_event`` JSON of every request's
span timeline at shutdown; ``--log-json FILE`` writes the same spans as
structured JSONL.

``--speculative`` mirrors draft-verify decode in the service-time model
(the sim backend and the tau calibration); with ``--backend real`` each
replica's engine also decodes draft-verify: a draft model proposes
``--draft-k`` tokens a round and the target verifies them in one
forward.  The draft is ``--draft-model`` at full width (``--reduced``
reduces it with the target), by default the target's own config, seeded
with ``--seed``.  Every draft must share the target's vocabulary (the
decoder raises otherwise).  Responses and ``/metrics``
(``clairvoyant_speculative_accept_rate``) report the accept rate.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import signal

from repro_torch.configs import get_config
from repro_torch.core.policy import get_policy, registered_names
from repro_torch.kernels import ops
from repro_torch.launch.serve import build_predictor, tau_for
from repro_torch.models.model import resolve_device
from repro_torch.serving.faults import CircuitBreaker, FaultPlan, RetryPolicy
from repro_torch.serving.http_sidecar import Sidecar
from repro_torch.serving.server import ClairvoyantServer
from repro_torch.serving.service_time import (ServiceTimeModel,
                                              expected_speedup)


def build_sidecar(args) -> Sidecar:
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    model = ServiceTimeModel.from_arch(cfg, chips=args.chips)
    if args.speculative:
        # mirror draft-verify decode in the cost model (and therefore in
        # the tau calibration below): decode runs at the expected
        # speculative speedup of the assumed acceptance rate
        from dataclasses import replace as _replace
        model = _replace(model, effective_rate=float(
            expected_speedup(args.accept_rate, args.draft_k)))
    predictor = build_predictor(args.dataset, device=device) \
        if get_policy(args.policy).uses_predictor and not args.no_predictor \
        else None
    tau = tau_for(model, args.tau_mult)
    if predictor is not None:
        # pay the scorer's first-call set-up (the device context, the
        # kernel library) here, before the listener opens, and not in
        # the first admission, which blocks the event loop
        predictor.proba("warm-up")

    if args.backend == "sim":
        from repro_torch.serving.backends import SimTextBackend
        backends = [SimTextBackend(model, replica_id=i,
                                   time_scale=args.time_scale)
                    for i in range(args.replicas)]
    elif args.backend == "real":
        from repro_torch.serving.backends import InProcessBackend
        from repro_torch.serving.engine import RealEngine
        rcfg = get_config("smollm-360m")
        if args.reduced:
            rcfg = rcfg.reduced()
        spec_kw = {}
        if args.speculative:
            dcfg = rcfg
            if args.draft_model:
                dcfg = get_config(args.draft_model)
                if args.reduced:
                    dcfg = dcfg.reduced()
            spec_kw = dict(draft_cfg=dcfg, draft_k=args.draft_k,
                           draft_seed=args.seed)
        # a 512-slot ring (the JAX CLI's 96 slots were sized for the
        # reduced model on a CPU): prompt + 64 new tokens fit untruncated.
        # Each replica's engine (and draft) is built here, before the
        # listener opens
        backends = [InProcessBackend(RealEngine(rcfg, replica_id=i,
                                                seed=args.seed, max_len=512,
                                                device=device, **spec_kw))
                    for i in range(args.replicas)]
    else:                                    # http: proxy to upstreams
        from repro_torch.serving.backends import HTTPBackend
        if not args.upstream:
            raise SystemExit("--backend http requires --upstream host:port")
        backends = []
        for i, up in enumerate(args.upstream):
            host, _, port = up.partition(":")
            backends.append(HTTPBackend(host, int(port or 80),
                                        replica_id=i, model=args.model))

    fault_plan = FaultPlan.random(
        seed=args.seed, horizon=3600.0, n_replicas=len(backends),
        crash_mtbf=args.chaos_crash_mtbf or None,
        transient_rate=args.chaos_transient_rate or None) \
        if args.chaos_crash_mtbf or args.chaos_transient_rate else None

    server = ClairvoyantServer(
        policy=args.policy, tau=tau, predictor=predictor,
        service_model=model, engines=backends, seed=args.seed,
        fault_plan=fault_plan, retry=RetryPolicy(seed=args.seed),
        deadline_s=args.deadline_s, deadline_mode="sojourn",
        max_queue_depth=args.max_queue_depth,
        breaker=CircuitBreaker(recovery_s=args.breaker_recovery_s))
    if getattr(args, "trace_out", None) or getattr(args, "log_json", None):
        # tracing requested: attach a full bundle (recorder + metrics +
        # ranking) before the Sidecar builds its metrics-only default
        from repro_torch.serving.observability import Observability
        server.attach_observability(Observability.default(tracing=True))
    return Sidecar(server, host=args.host, port=args.port,
                   model=args.model, max_inflight=args.max_inflight,
                   tenant_rate=args.tenant_rate,
                   tenant_burst=args.tenant_burst,
                   drain_s=args.drain_s,
                   max_new_tokens=args.max_new_tokens)


async def serve(args) -> None:
    sidecar = build_sidecar(args)
    await sidecar.start()
    print(f"sidecar listening on {sidecar.address} "
          f"(policy={args.policy}, backend={args.backend}, "
          f"replicas={len(sidecar.backends)})", flush=True)
    metrics_srv = None
    if getattr(args, "metrics_port", None) is not None:
        from repro_torch.serving.metrics_http import MetricsServer
        metrics_srv = MetricsServer(sidecar.obs, host=args.host,
                                    port=args.metrics_port)
        await metrics_srv.start()
        print(f"metrics on http://{args.host}:{metrics_srv.port}/metrics",
              flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:          # non-unix
            pass
    await stop.wait()
    print("draining...", flush=True)
    await sidecar.shutdown()
    if metrics_srv is not None:
        await metrics_srv.stop()
    rec = sidecar.obs.recorder
    if rec is not None:
        if getattr(args, "trace_out", None):
            rec.write_perfetto(args.trace_out)
            print(f"perfetto trace ({len(rec)} spans) -> {args.trace_out}",
                  flush=True)
        if getattr(args, "log_json", None):
            rec.write_jsonl(args.log_json)
            print(f"span JSONL -> {args.log_json}", flush=True)
    srv = sidecar.server
    done = len(srv.responses)
    ok = sum(1 for r in srv.responses if r.ok)
    print(f"drained: {done} terminals ({ok} ok), "
          f"fault_stats={srv.fault_stats}, "
          f"wire_stats={sidecar.wire_stats}", flush=True)
    # what ran on the card: each kernel wrapper counts its launches
    print(f"kernel launches: {json.dumps(ops.LAUNCHES)}", flush=True)


def build_parser() -> argparse.ArgumentParser:
    """The CLI's flags (the JAX CLI's, plus ``--device`` and
    ``--reduced``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--policy", default="sjf",
                    choices=sorted(registered_names()))
    ap.add_argument("--backend", default="sim",
                    choices=("sim", "real", "http"))
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--upstream", action="append", default=[],
                    help="host:port of an OpenAI-compatible upstream "
                         "(repeat for multiple replicas; --backend http)")
    ap.add_argument("--model", default="clairvoyant-sim")
    ap.add_argument("--arch", default="gemma3-4b-edge")
    ap.add_argument("--chips", type=int, default=1)
    ap.add_argument("--dataset", default="sharegpt")
    ap.add_argument("--no-predictor", action="store_true")
    ap.add_argument("--tau-mult", type=float, default=3.0)
    ap.add_argument("--time-scale", type=float, default=0.02,
                    help="sim backend: wall seconds per virtual second")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="server-wide sojourn deadline (per-request "
                         "X-Deadline-S overrides)")
    ap.add_argument("--max-queue-depth", type=int, default=None)
    ap.add_argument("--max-inflight", type=int, default=256)
    ap.add_argument("--max-new-tokens", type=int, default=64)
    ap.add_argument("--tenant-rate", type=float, default=None,
                    help="per-tenant token-bucket rate (req/s); "
                         "unset = no rate limiting")
    ap.add_argument("--tenant-burst", type=float, default=10.0)
    ap.add_argument("--drain-s", type=float, default=30.0)
    ap.add_argument("--breaker-recovery-s", type=float, default=5.0)
    ap.add_argument("--speculative", action="store_true",
                    help="draft-verify decode on the real backend; the "
                         "sim backend (and the tau calibration) apply the "
                         "expected speculative speedup to the service-"
                         "time model")
    ap.add_argument("--draft-model", default=None,
                    help="draft arch name for the real backend's "
                         "draft-verify decode (default: the target's "
                         "own config, seeded with --seed)")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="draft tokens proposed per verify step")
    ap.add_argument("--accept-rate", type=float, default=0.7,
                    help="assumed draft acceptance rate for the "
                         "service-time mirror (sim backend/calibration)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="also serve Prometheus /metrics on this "
                         "dedicated port (0 = ephemeral); the main port "
                         "serves /metrics regardless")
    ap.add_argument("--trace-out", default=None,
                    help="enable the flight recorder and write a "
                         "Chrome/Perfetto trace_event JSON of every "
                         "request's span timeline here at shutdown")
    ap.add_argument("--log-json", default=None,
                    help="enable the flight recorder and write the span "
                         "log as structured JSONL here at shutdown")
    ap.add_argument("--chaos-crash-mtbf", type=float, default=0.0,
                    help=">0: inject engine crashes at this MTBF (s)")
    ap.add_argument("--chaos-transient-rate", type=float, default=0.0,
                    help=">0: injected transient errors per second")
    ap.add_argument("--device", default=None,
                    help="where the predictor scores and a real backend "
                         "decodes (default: the CUDA card; 'cpu' runs the "
                         "plain versions)")
    ap.add_argument("--reduced", action="store_true",
                    help="real backend: the tiny same-family config of "
                         "the CPU tests instead of the full-width model")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None):
    asyncio.run(serve(build_parser().parse_args(argv)))


if __name__ == "__main__":
    main()
