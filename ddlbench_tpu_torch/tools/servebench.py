"""Serving benchmark: continuous batching vs static batching under load.

The port of ``ddlbench_tpu/tools/servebench.py`` for the plain row and the
reference's raw-speed levers. It drives the continuous-batching engine
(serve/engine.py) with a seeded open- or closed-loop workload
(serve/workload.py) and prints one JSON line per policy with TTFT and
inter-token-latency p50/p95/p99 and **goodput under SLO**
(telemetry/stats.serve_summary), under the reference's keys; the
reference's JAX provenance keys are replaced by the port's device fields
(device.provenance).

The levers, as in the reference: ``--kv-dtype`` stores the KV pool in
bfloat16 or int8 (a quarter of the float32 bytes, quantised at the write,
dequantised inside the attention kernels; the row gains ``kv_dtype``);
``--shared-prefix G:P`` makes G groups of requests that share a P-token
prompt head, and ``--prefix-cache`` serves cached heads from resident pages
on the continuous policy (compare ``prefill_tokens``, ``ttft_p50`` and the
``prefix_*`` fields with and without it); ``--speculative ngram:N:K`` turns
the decode step into a drafted verify pass (token streams those of plain
decoding; the row gains ``speculative``, the ``spec_*`` counters,
``spec_accept_rate`` and ``tokens_per_pass``).

Time is VIRTUAL: one unit = one model pass (a [max_batch, 1] decode step or
one prefill chunk), so every virtual-time number is reproducible under a
fixed seed and equal to the reference's for the same traffic.
``--wall-clock`` adds real seconds: the run's wall time, wall-clock output
tokens per second, and the mean decode-step and prefill-chunk times (and
with ``--speculative`` the mean verify-pass time).

The model runs on the card unless ``--device cpu`` is given; with no card
and no ``--device cpu`` the tool raises. Each row carries
``plain_launches``: the paged attention calls of the run that took the
plain path on CUDA tensors the kernels refuse (a head dim other than 64; 0
on the CPU).

Usage:
    python -m ddlbench_tpu_torch.tools.servebench [-m transformer_s]
        [-b synthtext] [--arrival poisson|bursty|closed] [--rate 0.5]
        [--requests 64] [--max-batch 8] [--pool-pages 64] [--page 16]
        [--max-len 256] [--slo-ttft 16] [--slo-itl 2.0]
        [--shared-prefix 4:64] [--prefix-cache] [--kv-dtype int8]
        [--speculative ngram:3:4] [--wall-clock] [--device cpu]
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
from ddlbench_tpu_torch.ops.paged_decode import (paged_attention,
                                                 paged_chunk_attention)
from ddlbench_tpu_torch.serve.engine import ReplicatedServer, make_server
from ddlbench_tpu_torch.serve.workload import ServeRequest, make_workload
from ddlbench_tpu_torch.telemetry.stats import serve_summary

# engine stats keys that only carry signal under --speculative: left out
# of the other rows, as in the reference, so their key set is unchanged
_SPEC_FIELDS = frozenset((
    "spec_passes", "spec_drafted", "spec_accepted", "decode_tokens",
    "spec_accept_rate", "tokens_per_pass"))


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
    p.add_argument("--shared-prefix", default=None, metavar="G:P",
                   help="shared-prefix traffic: G prefix groups of P "
                        "tokens each; every prompt = one group's prefix + "
                        "a unique heavy-tail tail")
    p.add_argument("--prefix-cache", action="store_true",
                   help="the cross-request prefix cache on the continuous "
                        "policy (the static baseline always runs without "
                        "it and reports the cache counters as 0)")
    p.add_argument("--kv-dtype", default=None,
                   choices=("float32", "bfloat16", "int8"),
                   help="KV-pool storage dtype: bfloat16 halves the pool "
                        "bytes, int8 quarters them; the row gains a "
                        "kv_dtype field")
    p.add_argument("--speculative", default=None, metavar="ngram:N:K",
                   help="self-drafting speculative decoding: an N-gram "
                        "drafter proposes up to K tokens per decode row, "
                        "verified in one K+1-wide pass priced as one model "
                        "pass; the row gains speculative/spec_*/"
                        "tokens_per_pass fields")
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


def plain_launches() -> int:
    """Paged attention calls so far that took the plain path on CUDA
    tensors the kernels refuse."""
    return (paged_attention.plain_launches
            + paged_chunk_attention.plain_launches)


def run(args: argparse.Namespace, model: LayerModel,
        device: torch.device
        ) -> List[Tuple[dict, ReplicatedServer, List[ServeRequest]]]:
    """Serve the workload under each policy with ``model`` (already on
    ``device``). Returns one (JSON row, server, requests) per policy."""
    spec = DATASETS[args.benchmark]
    plo, ptyp, phi = (int(x) for x in args.prompt_lens.split(","))
    olo, otyp, ohi = (int(x) for x in args.out_lens.split(","))
    policies = [s.strip() for s in args.policies.split(",") if s.strip()]
    groups = prefix_len = 0
    if args.shared_prefix:
        try:
            groups, prefix_len = (int(x)
                                  for x in args.shared_prefix.split(":"))
        except ValueError:
            raise ValueError("--shared-prefix wants G:P (groups:prefix_"
                             f"tokens), got {args.shared_prefix!r}") from None
    base = ServeConfig(
        max_batch=args.max_batch, pool_pages=args.pool_pages,
        page=args.page, max_len=min(args.max_len, spec.seq_len),
        token_budget=args.token_budget,
        prefill_chunk=(args.page if args.prefill_chunk is None
                       else args.prefill_chunk),
        slo_ttft=args.slo_ttft, slo_itl=args.slo_itl,
        kv_dtype=args.kv_dtype or "float32",
        speculative=args.speculative or "none")
    prov = provenance(device)
    out = []
    for policy in policies:
        # the static baseline is cache-off by definition; its row still
        # carries the prefix counters, as zeros
        cfg = base.replace(
            policy=policy,
            prefix_cache=args.prefix_cache and policy == "continuous")
        cfg.validate()
        # fresh workload per policy: the closed-loop driver stamps
        # arrivals, and both policies must see identical traffic
        reqs = make_workload(
            seed=args.seed, n_requests=args.requests,
            vocab=spec.num_classes, arrival=args.arrival, rate=args.rate,
            burst_size=args.burst_size, burst_factor=args.burst_factor,
            prompt_lo=plo, prompt_typical=ptyp, prompt_hi=phi,
            out_lo=olo, out_typical=otyp, out_hi=ohi,
            tail_frac=args.tail_frac, prefix_groups=groups,
            prefix_len=prefix_len, max_len=cfg.max_len)
        server = make_server(model, cfg, device)
        plain0 = plain_launches()
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
            "shared_prefix": args.shared_prefix,
            "sample": None,
            "time_unit": "model_pass",
            **{k: (round(v, 6) if isinstance(v, float) else v)
               for k, v in summary.items()},
            # serve_summary already reports completed; the speculative
            # counters only show under --speculative
            **{k: (round(v, 6) if isinstance(v, float) else v)
               for k, v in eng_stats.items()
               if k != "completed"
               and (args.speculative or k not in _SPEC_FIELDS)},
            **({"kv_dtype": cfg.kv_dtype} if args.kv_dtype else {}),
            **({"speculative": cfg.speculative}
               if args.speculative else {}),
            "plain_launches": plain_launches() - plain0,
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
            if args.speculative:
                rec["verify_step_ms"] = round(
                    1e3 * eng.wall["verify_s"] / st["spec_passes"], 4) \
                    if st["spec_passes"] else 0.0
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
