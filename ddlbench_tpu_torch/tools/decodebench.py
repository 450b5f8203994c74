"""Inference (decode) throughput microbenchmark (PyTorch port).

The port of ``ddlbench_tpu/tools/decodebench.py``: tokens/s of greedy and
beam decoding on a seq2seq model (or a causal LM), the paged and the dense
KV-cached paths (models/decode.py) against the full-forward loop
(models/seq2seq.py), one JSON line per configuration:

    {"tool": "decodebench", "mode": "greedy", "variant": "paged",
     "tokens_per_sec": N, "ms_per_token": M, ...}

The six rows are greedy and beam x ``paged`` (the copy-on-write page
tables, the decode kernel over the live pages), ``cached`` (the dense
cache, gathered along the parent beams) and ``full``. A causal LM
(``transformer_*``, ``transformer_moe_*`` on a token benchmark) decodes
from half the stream and skips the ``full`` rows (the full-forward loop
is seq2seq's); a model without the decode protocol
(``seq2seq_lstm_*``) skips the ``paged`` and ``cached`` rows. ``--chunk-prefill``
adds the serving chunk attention, kernel against its plain version
(``chunk-kernel``, ``chunk-xla``) over a synthetic serving pool, and
``--kv-dtype`` the pool-dtype sweep of the decode and chunk attention
(kernel and plain) over a pool filled by the real quantising write.
"xla" names the plain PyTorch version, the reference's XLA path.

The same flags and row keys as the reference, except: ``--device`` (cuda
by default; with no card the tool raises unless ``--device cpu`` is given)
in place of ``--platform``, and ``device.provenance()`` in place of the
JAX backend record on every row; ``--paged-kernel`` (the Pallas kernels'
two formulations) is refused, naming ROADMAP A.8; an int8
``--cache-dtype`` is refused, naming ROADMAP C.10 (the reference's beam
cache has no scales and would truncate). Kernel rows on the CPU are
``skipped``. A row whose run fails is recorded as ``error`` and the sweep
goes on, as in the reference, but the tool then exits 1. Each run is
timed after one warm call, best of ``--repeats``, each ended by a CUDA
synchronisation. Decode rows carry ``plain_launches``: attention calls on
CUDA tensors the kernels refuse (0 on the CPU and on the main path).

Usage:
    python -m ddlbench_tpu_torch.tools.decodebench [-m seq2seq_s]
        [-b synthmt] [--batch 8] [--beam 4] [--repeats 3] [--skip-uncached]
        [--cache-dtype bfloat16] [--chunk-prefill]
        [--kv-dtype float32,bfloat16,int8] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ddlbench_tpu_torch.config import DATASETS
from ddlbench_tpu_torch.device import provenance, resolve_device
from ddlbench_tpu_torch.models import decode as dec
from ddlbench_tpu_torch.models import seq2seq as s2s
from ddlbench_tpu_torch.models.zoo import get_model
from ddlbench_tpu_torch.ops import paged_decode as pd
from ddlbench_tpu_torch.ops.flash_attention import flash_attention

KV_DTYPES = ("float32", "bfloat16", "int8")


class _Refused(argparse.Action):
    """A reference flag or value the port refuses, naming its ROADMAP
    item (the action's ``const``)."""

    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not ported to the PyTorch path "
                     f"(ROADMAP {self.const})")


def _cache_dtype(name: str) -> str:
    if name not in ("float32", "bfloat16"):
        raise argparse.ArgumentTypeError(
            f"{name!r}: the beam cache is float32 or bfloat16; an int8 "
            "cache would truncate K/V, having no scales (ROADMAP C.10)")
    return name


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-m", "--model", default="seq2seq_s")
    p.add_argument("-b", "--benchmark", default="synthmt")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--beam", type=int, default=4)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--total-len", type=int, default=None,
                   help="decode out to this stream length (default: the "
                        "benchmark's full seq_len)")
    p.add_argument("--cache-dtype", default="float32", type=_cache_dtype,
                   help="KV-cache storage dtype of the paged rows: float32 "
                        "or bfloat16 (halves the cache's bytes)")
    p.add_argument("--skip-uncached", action="store_true",
                   help="skip the full-forward reference rows")
    p.add_argument("--chunk-prefill", action="store_true",
                   help="also time the serving chunk attention, kernel "
                        "against plain, over --chunk-sizes x "
                        "--chunk-pages")
    p.add_argument("--chunk-sizes", default="64,128")
    p.add_argument("--chunk-pages", default="4,16")
    p.add_argument("--chunk-heads", type=int, default=8)
    p.add_argument("--chunk-dh", type=int, default=64)
    p.add_argument("--chunk-page-size", type=int, default=64)
    p.add_argument("--kv-dtype", default=None,
                   help="comma list among float32,bfloat16,int8: the "
                        "serving pool's dtype sweep of the decode and "
                        "chunk attention, kernel against plain")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; without a card the tool "
                        "raises unless cpu is asked for")
    p.add_argument("--paged-kernel", action=_Refused, nargs="?",
                   const="A.8: the Pallas kernels' math formulations; the "
                         "CUDA kernels have one",
                   help=argparse.SUPPRESS)
    return p


def _bench(fn, sync, repeats: int) -> float:
    """Best wall seconds of ``repeats`` calls after one warm call, each
    closed by ``sync``."""
    fn()
    sync()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def _syncer(device: torch.device):
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def _error(e: Exception) -> str:
    return f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"


def _plain_calls() -> int:
    return (flash_attention.plain_launches + pd.paged_attention.plain_launches
            + pd.paged_chunk_attention.plain_launches)


def decode_rows(args, model, spec, device, prov):
    """The six decode rows (greedy and beam x paged, cached, full)."""
    causal = spec.kind == "tokens"
    T = min(args.total_len or spec.seq_len, spec.seq_len)
    S = T // 2 if causal else spec.src_len
    rng = np.random.default_rng(1)
    src = torch.from_numpy(rng.integers(0, spec.num_classes,
                                        (args.batch, S))).to(device)
    new_tokens = (T - S) * args.batch
    sync = _syncer(device)
    runs = [("greedy", "paged"), ("beam", "paged"),
            ("greedy", "cached"), ("beam", "cached")]
    if not args.skip_uncached:
        runs += [("greedy", "full"), ("beam", "full")]
    for mode, variant in runs:
        base = {"tool": "decodebench", "mode": mode, "variant": variant,
                **prov}
        if variant == "paged" and not dec.supports_paged(model):
            yield {**base, "skipped": f"{args.model} lacks paged support"}
            continue
        if variant == "cached" and not dec.supports_cache(model):
            # the reference records this row as an error (its cached
            # decoder raises); the port skips it, as the paged rows
            yield {**base, "skipped": f"{args.model} lacks cached support"}
            continue
        if causal and variant == "full":
            # the full-forward loop is seq2seq's; tests pin the causal
            # cached path against a full-forward greedy instead
            yield {**base, "skipped": "full-forward loop is seq2seq-only"}
            continue
        cdt = args.cache_dtype if variant == "paged" else "float32"
        if variant == "paged" or causal:
            kw = dict(dtype=getattr(torch, cdt), paged=variant == "paged")
            if mode == "greedy":
                fn = lambda: dec.greedy_decode(model, src, T, **kw)  # noqa
            else:
                fn = lambda: dec.beam_search_decode(  # noqa: E731
                    model, src, T, beam=args.beam, **kw)
        else:
            cached = variant == "cached"
            if mode == "greedy":
                fn = lambda: s2s.greedy_decode(  # noqa: E731
                    model, src, T, use_cache=cached)
            else:
                fn = lambda: s2s.beam_search_decode(  # noqa: E731
                    model, src, T, beam=args.beam, use_cache=cached)
        plain0 = _plain_calls()
        try:
            dt = _bench(fn, sync, args.repeats)
        except Exception as e:  # recorded; the tool exits 1 at the end
            yield {**base, "error": _error(e)}
            continue
        yield {
            **base,
            "model": args.model,
            "benchmark": args.benchmark,
            "cache_dtype": cdt,
            "cached": variant != "full",
            "batch": args.batch,
            "prompt_len": S,
            "total_len": T,
            "beam": args.beam if mode == "beam" else 1,
            "new_tokens": new_tokens,
            "tokens_per_sec": round(new_tokens / dt, 2),
            "ms_per_token": round(1000.0 * dt / max(1, T - S), 3),
            "plain_launches": _plain_calls() - plain0,
        }


def _serving_table(npl: int, device) -> torch.Tensor:
    """One row's table over ``npl`` shuffled slots of an (npl + 2)-slot
    pool, slot 0 the scratch: the layout the serving free list gives."""
    perm = np.random.default_rng(0).permutation(np.arange(1, npl + 2))[:npl]
    return torch.as_tensor(perm[None, :], dtype=torch.int32, device=device)


def _kernel_rows(args, base, fn_kernel, fn_plain, tokens, device, unit):
    """Kernel and plain rows of one op (the kernel row skipped off the
    card)."""
    sync = _syncer(device)
    for variant, fn in (("kernel", fn_kernel), ("xla", fn_plain)):
        row = base(variant)
        if variant == "kernel" and device.type != "cuda":
            yield {**row, "skipped": "the CUDA kernel needs a card (the "
                                     "xla row, the plain version, is the "
                                     "CPU path)"}
            continue
        try:
            dt = _bench(fn, sync, args.repeats)
        except Exception as e:  # recorded; the tool exits 1 at the end
            yield {**row, "error": _error(e)}
            continue
        yield {**row, "tokens_per_sec": round(tokens / dt, 2),
               unit: round(1e6 * dt, 2)}


def chunk_prefill_rows(args, device, prov):
    """Chunk kernel against its plain version over a synthetic serving
    pool, one pair per (chunk size C, live pages), the chunk starting on
    the last live page (the serving frontier)."""
    H, dh, page = args.chunk_heads, args.chunk_dh, args.chunk_page_size
    gen = torch.Generator().manual_seed(10)
    for C in (int(x) for x in args.chunk_sizes.split(",")):
        for npl in (int(x) for x in args.chunk_pages.split(",")):
            shape = (npl + 2, page, H, dh)
            cache = {"pool_k": torch.randn(*shape, generator=gen).to(device),
                     "pool_v": torch.randn(*shape, generator=gen).to(device),
                     "table": _serving_table(npl, device)}
            q = torch.randn(1, H, C, dh, generator=gen).to(device)
            start = (npl - 1) * page

            def base(variant):
                return {"tool": "decodebench", "variant": f"chunk-{variant}",
                        "chunk": C, "pages": npl, "page": page, "heads": H,
                        "dh": dh, **prov}

            yield from _kernel_rows(
                args, base,
                lambda: pd.paged_chunk_attention(q, cache, start, npl, page),
                lambda: pd._paged_chunk_attention_ref(q, cache, start, npl,
                                                      page),
                C, device, "us_per_chunk")


def kv_dtype_rows(args, device, prov):
    """The serving pool's dtype sweep: for each dtype, the decode and the
    chunk attention, kernel against plain, over a pool whose live pages
    were filled by the real table write (an int8 pool quantised with its
    scale sidecars), at the ``--chunk-*`` shapes."""
    H, dh, page = args.chunk_heads, args.chunk_dh, args.chunk_page_size
    C = int(args.chunk_sizes.split(",")[0])
    npl = max(int(x) for x in args.chunk_pages.split(","))
    for name in (s.strip() for s in args.kv_dtype.split(",") if s.strip()):
        if name not in KV_DTYPES:
            yield {"tool": "decodebench", "variant": "kv-dtype",
                   "kv_dtype": name,
                   "error": "unknown dtype (float32|bfloat16|int8)", **prov}
            continue
        gen = torch.Generator().manual_seed(20)
        pool = pd.serve_pool_init(npl + 2, page, H, dh, getattr(torch, name),
                                  device)
        cache = {**pool, "table": _serving_table(npl, device)}
        kk = torch.randn(1, npl * page, H, dh, generator=gen).to(device)
        vv = torch.randn(1, npl * page, H, dh, generator=gen).to(device)
        pd.paged_table_chunk_write(cache, kk, vv, 0, page)
        q1 = torch.randn(1, H, dh, generator=gen).to(device)
        qC = torch.randn(1, H, C, dh, generator=gen).to(device)
        pos, start = npl * page - 1, (npl - 1) * page
        ops = (
            ("decode", 1,
             lambda: pd.paged_attention(q1, cache, pos, npl, page),
             lambda: pd._paged_attention_ref(q1, cache, pos, npl, page)),
            ("chunk", C,
             lambda: pd.paged_chunk_attention(qC, cache, start, npl, page),
             lambda: pd._paged_chunk_attention_ref(qC, cache, start, npl,
                                                   page)))
        for op, tokens, kernel, plain in ops:
            def base(variant, op=op):
                return {"tool": "decodebench", "variant": "kv-dtype",
                        "op": op, "kv_dtype": name,
                        "kernel": variant == "kernel", "chunk": C,
                        "pages": npl, "page": page, "heads": H, "dh": dh,
                        **prov}

            yield from _kernel_rows(args, base, kernel, plain, tokens, device,
                                    "us_per_call")


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if args.benchmark not in DATASETS or DATASETS[args.benchmark].kind == \
            "image":
        p.error(f"-b {args.benchmark!r} is not a token or seq2seq workload")
    device = resolve_device(args.device)
    prov = provenance(device)
    spec = DATASETS[args.benchmark]
    model = get_model(args.model, spec, seed=0).to(device)
    sweeps = [decode_rows(args, model, spec, device, prov)]
    if args.chunk_prefill:
        sweeps.append(chunk_prefill_rows(args, device, prov))
    if args.kv_dtype:
        sweeps.append(kv_dtype_rows(args, device, prov))
    failed = 0
    for sweep in sweeps:
        for row in sweep:
            print(json.dumps(row), flush=True)
            failed += "error" in row
    if failed:
        print(f"decodebench: {failed} row(s) failed", file=sys.stderr,
              flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
