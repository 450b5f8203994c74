"""Serving benchmark: continuous batching vs static batching under load.

The port of ``ddlbench_tpu/tools/servebench.py`` for a plain row. It drives
the continuous-batching engine (serve/engine.py) with a seeded open- or
closed-loop workload (serve/workload.py) and prints one JSON line per
policy with TTFT and inter-token-latency p50/p95/p99 and **goodput under
SLO** (telemetry/stats.serve_summary), under the same keys as the
reference's plain row; the reference's JAX provenance keys are replaced by
the port's device fields (device.provenance).

Time is VIRTUAL: one unit = one model pass (a [max_batch, 1] decode step or
one prefill chunk), so every virtual-time number is reproducible under a
fixed seed and equal to the reference's for the same traffic.
``--wall-clock`` adds real seconds: the run's wall time, wall-clock output
tokens per second, and the mean decode-step and prefill-chunk times.

The model runs on the card unless ``--device cpu`` is given; with no card
and no ``--device cpu`` the tool raises.

Usage:
    python -m ddlbench_tpu_torch.tools.servebench [-m transformer_s]
        [-b synthtext] [--arrival poisson|bursty|closed] [--rate 0.5]
        [--requests 64] [--max-batch 8] [--pool-pages 64] [--page 16]
        [--max-len 256] [--slo-ttft 16] [--slo-itl 2.0] [--wall-clock]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Tuple

import torch

from ddlbench_tpu_torch.config import DATASETS, ServeConfig
from ddlbench_tpu_torch.device import provenance, resolve_device
from ddlbench_tpu_torch.models.layers import LayerModel
from ddlbench_tpu_torch.models.zoo import get_model
from ddlbench_tpu_torch.serve.engine import ReplicatedServer, make_server
from ddlbench_tpu_torch.serve.workload import ServeRequest, make_workload
from ddlbench_tpu_torch.telemetry.stats import serve_summary


def run_open_loop(server, reqs) -> float:
    """Release requests at their arrival times; returns the final clock."""
    clock, i = 0.0, 0
    sub = _Submitter(server)
    pend = sorted(reqs, key=lambda r: (r.arrival, r.rid))
    while i < len(pend) or server.has_work():
        while i < len(pend) and pend[i].arrival <= clock:
            sub.offer(pend[i], clock)
            i += 1
        if not server.has_work():
            # idle: jump to the next arrival
            if i >= len(pend):
                break
            clock = max(clock, pend[i].arrival)
            continue
        rep = server.step(clock)
        clock += rep.cost
    return clock


def run_closed_loop(server, reqs, concurrency: int) -> float:
    """Keep ``concurrency`` requests in flight; each completion releases
    the next. Returns the final clock."""
    clock, nxt, done = 0.0, 0, 0
    sub = _Submitter(server)
    n = len(reqs)
    outstanding = 0

    def top_up():
        nonlocal nxt, outstanding
        while nxt < n and outstanding < concurrency:
            sub.offer(reqs[nxt], clock)
            nxt += 1
            outstanding += 1

    top_up()
    while done < n:
        if not server.has_work():
            break  # everything released went terminal
        rep = server.step(clock)
        clock += rep.cost
        done += len(rep.completed)
        outstanding -= len(rep.completed)
        top_up()
    return clock


class _Submitter:
    """Driver-side admission: stamps a closed-loop request's arrival at
    release and submits it. (The reference's retry-with-backoff for shed
    requests needs deadlines, which the port does not have yet.)"""

    def __init__(self, server):
        self.server = server

    def offer(self, req, clock: float) -> None:
        if req.arrival is None:
            req.arrival = clock  # closed loop stamps at release
        if not self.server.submit(req, now=clock):
            raise RuntimeError(f"request {req.rid} was refused")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-m", "--model", default="transformer_s")
    p.add_argument("-b", "--benchmark", default="synthtext")
    p.add_argument("--policies", default="continuous,static",
                   help="comma list among continuous,static — each runs "
                        "the same workload at the same pool size")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--pool-pages", type=int, default=64)
    p.add_argument("--page", type=int, default=16)
    p.add_argument("--max-len", type=int, default=256)
    p.add_argument("--prefill-chunk", type=int, default=None,
                   help="tokens per prefill call (page multiple; default: "
                        "one page; 0 = whole prompt in one padded call)")
    p.add_argument("--token-budget", type=int, default=0,
                   help="tokens one step may pack (0 = max_batch + 2 "
                        "prefill chunks)")
    p.add_argument("--arrival", default="poisson",
                   choices=("poisson", "bursty", "closed"))
    p.add_argument("--rate", type=float, default=0.5,
                   help="open-loop arrival rate (requests per model pass)")
    p.add_argument("--burst-size", type=int, default=8)
    p.add_argument("--burst-factor", type=float, default=4.0)
    p.add_argument("--concurrency", type=int, default=16,
                   help="closed-loop in-flight request count")
    p.add_argument("--requests", type=int, default=64)
    p.add_argument("--prompt-lens", default="4,16,64",
                   help="lo,typical,hi of the heavy-tail prompt mixture")
    p.add_argument("--out-lens", default="2,16,64",
                   help="lo,typical,hi of the heavy-tail output mixture")
    p.add_argument("--tail-frac", type=float, default=0.25)
    p.add_argument("--slo-ttft", type=float, default=16.0,
                   help="TTFT SLO in time units (model passes)")
    p.add_argument("--slo-itl", type=float, default=2.0,
                   help="mean inter-token-latency SLO in time units")
    p.add_argument("--seed", type=int, default=0,
                   help="seeds the traffic and the random weights")
    p.add_argument("--wall-clock", action="store_true",
                   help="also report real elapsed seconds, wall-clock "
                        "tokens/s and mean decode-step / prefill-chunk ms")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; no card and no --device "
                        "cpu raises")
    return p


def run(args: argparse.Namespace, model: LayerModel,
        device: torch.device
        ) -> List[Tuple[dict, ReplicatedServer, List[ServeRequest]]]:
    """Serve the workload under each policy with ``model`` (already on
    ``device``). Returns one (JSON row, server, requests) per policy."""
    spec = DATASETS[args.benchmark]
    plo, ptyp, phi = (int(x) for x in args.prompt_lens.split(","))
    olo, otyp, ohi = (int(x) for x in args.out_lens.split(","))
    policies = [s.strip() for s in args.policies.split(",") if s.strip()]
    base = ServeConfig(
        max_batch=args.max_batch, pool_pages=args.pool_pages,
        page=args.page, max_len=min(args.max_len, spec.seq_len),
        token_budget=args.token_budget,
        prefill_chunk=(args.page if args.prefill_chunk is None
                       else args.prefill_chunk),
        slo_ttft=args.slo_ttft, slo_itl=args.slo_itl)
    prov = provenance(device)
    out = []
    for policy in policies:
        cfg = base.replace(policy=policy)
        cfg.validate()
        # fresh workload per policy: the closed-loop driver stamps
        # arrivals, and both policies must see identical traffic
        reqs = make_workload(
            seed=args.seed, n_requests=args.requests,
            vocab=spec.num_classes, arrival=args.arrival, rate=args.rate,
            burst_size=args.burst_size, burst_factor=args.burst_factor,
            prompt_lo=plo, prompt_typical=ptyp, prompt_hi=phi,
            out_lo=olo, out_typical=otyp, out_hi=ohi,
            tail_frac=args.tail_frac, max_len=cfg.max_len)
        server = make_server(model, cfg, device)
        t0 = time.perf_counter()
        if args.arrival == "closed":
            duration = run_closed_loop(server, reqs, args.concurrency)
        else:
            duration = run_open_loop(server, reqs)
        wall = time.perf_counter() - t0
        fin = server.finished
        summary = serve_summary(fin, duration=duration,
                                slo_ttft=args.slo_ttft,
                                slo_itl=args.slo_itl)
        eng_stats = server.stats_summary()
        rec = {
            "tool": "servebench",
            "model": args.model,
            "benchmark": args.benchmark,
            "policy": policy,
            "arrival": args.arrival,
            "rate": args.rate if args.arrival != "closed" else None,
            "concurrency": (args.concurrency if args.arrival == "closed"
                            else None),
            "requests": args.requests,
            "seed": args.seed,
            "max_batch": cfg.max_batch,
            "pool_pages": cfg.pool_pages,
            "page": cfg.page,
            "max_len": cfg.max_len,
            "prefill_chunk": cfg.resolved_prefill_chunk(),
            "token_budget": cfg.resolved_token_budget(),
            "replicas": cfg.replicas,
            "prefix_cache": cfg.prefix_cache,
            "shared_prefix": None,
            "sample": None,
            "time_unit": "model_pass",
            **{k: (round(v, 6) if isinstance(v, float) else v)
               for k, v in summary.items()},
            # serve_summary already reports completed
            **{k: (round(v, 6) if isinstance(v, float) else v)
               for k, v in eng_stats.items() if k != "completed"},
            **prov,
        }
        if args.wall_clock:
            eng = server.engines[0]
            st = eng.stats
            rec["wall_s"] = round(wall, 3)
            rec["wall_tokens_per_s"] = round(
                summary["output_tokens"] / wall, 3) if wall > 0 else 0.0
            rec["decode_step_ms"] = round(
                1e3 * eng.wall["decode_s"] / st["decode_calls"], 4) \
                if st["decode_calls"] else 0.0
            rec["prefill_chunk_ms"] = round(
                1e3 * eng.wall["prefill_s"] / st["prefill_calls"], 4) \
                if st["prefill_calls"] else 0.0
        out.append((rec, server, reqs))
    return out


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    spec = DATASETS.get(args.benchmark)
    if spec is None or spec.kind != "tokens":
        p.error(f"-b {args.benchmark!r} is not a causal-LM token workload; "
                "the serving engine serves causal LMs (e.g. synthtext)")
    device = resolve_device(args.device)
    model = get_model(args.model, spec, seed=args.seed).to(device)
    for rec, _, _ in run(args, model, device):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
