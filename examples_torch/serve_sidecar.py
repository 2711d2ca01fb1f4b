"""End to end: serve requests through the Clairvoyant sidecar.

Two modes:

    PYTHONPATH=src python examples_torch/serve_sidecar.py            # in-process
    PYTHONPATH=src python examples_torch/serve_sidecar.py --http     # over the wire
    PYTHONPATH=src python examples_torch/serve_sidecar.py --device cpu

Both modes run on the card unless given ``--device`` (``cpu`` for the
plain PyTorch paths); without a card and without ``--device`` they raise.

**In-process** (default): a reduced smollm backbone actually decodes each
request (``RealEngine``: K3 a prefill and K1 a decode step, once a layer,
on the card); admission ordering comes from the trained predictor (K5) +
SJF queue.  Shows the paper's n=8 dispatch-order result with real token
generation, then a larger simulated-time batch for the latency stats.

**HTTP** (``--http``): boots the asyncio HTTP/SSE sidecar on a loopback
port, fires an asyncio client pool of streaming chat-completion requests
at it (predictor-scored SJF admission, virtual-time sim backends), and
reports *client-observed* wire TTFT and per-class P50 sojourn for SJF vs
FCFS — the paper's HoL-mitigation win measured end to end through a real
socket.
"""

import argparse
import asyncio
import json
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.gbdt import GBDTParams
from repro_torch.core.predictor import Predictor
from repro_torch.core.scheduler import Request, SJFQueue
from repro_torch.data.corpus import sample_dataset
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.models.model import resolve_device
from repro_torch.serving.engine import RealEngine
from repro_torch.serving.openai_api import CompletionRequest
from repro_torch.serving.server import ClairvoyantServer

#: the serial engine's ring length
MAX_LEN = 96


def train_predictor(rounds, device):
    print("training predictor...")
    train = sample_dataset("sharegpt", n=2400, seed=0, balanced=True)
    return Predictor.train(train.prompts, train.lengths,
                           GBDTParams(num_rounds=rounds), device=device)


def dispatch(engine, pred):
    """Real decode through the SJF queue (n=8, 4 short + 4 long, the
    longs arriving first) on ``engine``.  Returns one (klass, p_long,
    tokens) a dispatch, in dispatch order."""
    tok = HashTokenizer(engine.cfg.vocab_size)
    ds = sample_dataset("sharegpt", n=4000, seed=1)
    shorts = [i for i in range(len(ds)) if ds.lengths[i] < 120][:4]
    longs = [i for i in range(len(ds)) if ds.lengths[i] >= 1000][:4]

    q = SJFQueue(policy="sjf")
    for j, i in enumerate(longs + shorts):  # adversarial: longs arrive first
        klass = "short" if i in shorts else "long"
        q.push(Request(req_id=j, prompt=ds.prompts[i],
                       p_long=pred.p_long(ds.prompts[i]), klass=klass))

    print("dispatch order (longs arrived first; SJF should flip them):")
    order, served = [], []
    while True:
        r = q.pop(now=0.0)
        if r is None:
            break
        n_new = 4 if r.klass == "short" else 16
        out = engine.generate(tok.encode(r.prompt)[:24], max_new_tokens=n_new)
        order.append(r.klass)
        served.append((r.klass, r.p_long, list(out["tokens"])))
        print(f"  {r.klass:5s} p_long={r.p_long:.2f} "
              f"generated {len(out['tokens'])} tokens "
              f"in {out['service_s']*1e3:.0f} ms (ttft {out['ttft_s']*1e3:.0f} ms)")
    n_short_first = order[:4].count("short")
    print(f"shorts in the first 4 dispatches: {n_short_first}/4")
    return served


def latency(pred):
    """Batched latency stats on the simulated clock (100 requests, one
    predictor call for the burst).  Returns {policy: short P50 s}."""
    server_args = dict(n_replicas=1, predictor=pred, seed=0)
    results = {}
    for policy in ("fcfs", "sjf"):
        server = ClairvoyantServer(policy=policy, tau=None, **server_args)
        ds2 = sample_dataset("sharegpt", n=100, seed=2)
        rng = np.random.default_rng(3)
        # batched admission: one predictor call for the whole burst
        server.submit_many(
            [CompletionRequest(prompt=p) for p in ds2.prompts],
            arrivals=rng.uniform(0, 0.05, 100),
            true_output_tokens=[int(l) for l in ds2.lengths],
            klasses=[("short", "medium", "long")[int(c)]
                     for c in ds2.classes])
        server.drain()
        results[policy] = server.percentile(50, "short")
        print(f"{policy}: short P50 sojourn {results[policy]:.1f}s")
    print(f"SJF short-P50 reduction: "
          f"{100*(1-results['sjf']/results['fcfs']):.0f}%")
    return results


def main_inprocess(args, device):
    pred = train_predictor(args.rounds, device)
    cfg = get_config("smollm-360m").reduced()
    served = dispatch(RealEngine(cfg, max_len=MAX_LEN, device=device), pred)
    return {"dispatch": served, "short_p50": latency(pred)}


# ------------------------------------------------------------ HTTP mode
async def _stream_request(port, body):
    """One raw streaming chat completion; returns (wire_ttft_s, sojourn_s)
    measured from just before connect."""
    t0 = time.monotonic()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode()
    writer.write((
        "POST /v1/chat/completions HTTP/1.1\r\nHost: example\r\n"
        "Content-Type: application/json\r\n"
        f"Content-Length: {len(payload)}\r\nConnection: close\r\n\r\n"
    ).encode() + payload)
    await writer.drain()
    ttft, buf = None, b""
    while b"data: [DONE]" not in buf:
        chunk = await reader.read(4096)
        if not chunk:
            break
        buf += chunk
        if ttft is None and b'"content"' in buf:
            ttft = time.monotonic() - t0
    writer.close()
    try:
        await writer.wait_closed()
    except (ConnectionError, OSError):
        pass
    return ttft, time.monotonic() - t0


async def _wire_burst(policy, pred, ds, time_scale, n_replicas):
    from repro_torch.serving.backends import SimTextBackend
    from repro_torch.serving.http_sidecar import Sidecar
    from repro_torch.serving.service_time import ServiceTimeModel
    model = ServiceTimeModel(prefill_tok_per_s=8000.0,
                             decode_tok_per_s=60.0)
    backends = [SimTextBackend(model, replica_id=i, time_scale=time_scale)
                for i in range(n_replicas)]
    server = ClairvoyantServer(policy=policy, tau=None, predictor=pred,
                               engines=backends, service_model=model,
                               deadline_mode="sojourn", seed=0)
    sc = Sidecar(server, port=0)
    await sc.start()
    rng = np.random.default_rng(4)
    klasses = [("short", "medium", "long")[int(c)] for c in ds.classes]

    async def one(i):
        await asyncio.sleep(float(rng.uniform(0, 0.02)))
        return await _stream_request(sc.port, {
            "prompt": ds.prompts[i], "max_tokens": 2048,
            "output_tokens": int(ds.lengths[i]), "stream": True})

    try:
        out = await asyncio.gather(*[one(i) for i in range(len(ds))])
    finally:
        await sc.shutdown(drain_s=10.0)
    assert len(sc.server._terminal) == len(ds), "lost requests on the wire"
    ttft = np.array([t for t, _ in out])
    sojourn = np.array([s for _, s in out])
    return {"ttft": ttft, "sojourn": sojourn,
            "short": np.array([k == "short" for k in klasses])}


def main_http(args, device):
    pred = train_predictor(args.rounds, device)
    ds = sample_dataset("sharegpt", n=args.requests, seed=2)
    print(f"firing {args.requests} streaming requests over loopback HTTP "
          f"({args.replicas} replica(s), time_scale={args.time_scale})...")
    results = {}
    for policy in ("fcfs", "sjf"):
        r = asyncio.run(_wire_burst(policy, pred, ds, args.time_scale,
                                    args.replicas))
        short, soj = r["short"], r["sojourn"]
        results[policy] = np.percentile(soj[short], 50)
        print(f"{policy}: wire TTFT P50 "
              f"{np.percentile(r['ttft'], 50)*1e3:.0f} ms | "
              f"short P50 {np.percentile(soj[short], 50)*1e3:.0f} ms "
              f"P95 {np.percentile(soj[short], 95)*1e3:.0f} ms | "
              f"long P50 {np.percentile(soj[~short], 50)*1e3:.0f} ms")
    print(f"SJF short-P50 reduction over the wire: "
          f"{100*(1-results['sjf']/results['fcfs']):.0f}%")
    return {"short_p50": results}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--http", action="store_true",
                    help="serve over loopback HTTP/SSE instead of "
                         "in-process")
    ap.add_argument("--requests", type=int, default=80)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--rounds", type=int, default=80)
    ap.add_argument("--time-scale", type=float, default=0.004)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.http:
        return main_http(args, device)
    return main_inprocess(args, device)


if __name__ == "__main__":
    main()
