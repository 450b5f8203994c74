"""Translation-accuracy gate: seq2seq trains to SEQUENCE accuracy, then
decodes it through every decoder (PyTorch port).

The port of ``ddlbench_tpu/tools/mtacc.py``. A deterministic synthetic
language, target = the vocabulary-permuted source in REVERSED order (the
reversal forces attention across positions, the permutation the whole
vocabulary mapping), trained in-process on ``seq2seq_t`` (d 32, 2 layers,
4 heads) with the ``single`` strategy and Adam, then decoded on held-out
sources through greedy, beam, the PAGED beam (models/decode.py's
copy-on-write cache) and the full-forward greedy loop, each scored by
exact-match sequence accuracy: where cache, mask or position faults that
random-weight token-identity tests can miss would show on trained
weights.

One JSON document:
    {"seq_accuracy": {"greedy": 1.0, "beam": 1.0, "paged_beam": 1.0, ...},
     "token_accuracy": ..., "pass": true}

The deterministic task is a GATE (exact match is reachable, so it catches
outright decode breakage): every path's sequence accuracy at least 0.95,
and the cached greedy stream equal to the full-forward one. ``--noise e`` is the graded
variant: each source token is replaced by a uniform random one with
probability e AFTER the clean target is formed, so the best per-token
accuracy is the Bayes ceiling (1 - e) + e / (V - 4) < 1, and the gate is
each path's token accuracy within ``--noise-margin`` of it.

The same flags and document as the reference, except ``--device`` (cuda
by default; with no card the tool raises unless ``--device cpu`` is
given) in place of ``--platform``, and ``device.provenance()`` in the
document. The weights come from a torch generator (seed 0), not from
``jax.random``, so the trained model is not the reference's.

Usage:
    python -m ddlbench_tpu_torch.tools.mtacc [--steps 400] [--src-len 12]
        [--vocab 64] [--batch 64] [--threshold 0.95] [--noise 0.1]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ddlbench_tpu_torch.config import RunConfig
from ddlbench_tpu_torch.data.synthetic import mask_source_labels
from ddlbench_tpu_torch.device import provenance, resolve_device
from ddlbench_tpu_torch.models import decode as dec
from ddlbench_tpu_torch.models import seq2seq as s2s
from ddlbench_tpu_torch.parallel.single import SingleStrategy

BOS, EOS = 1, 2  # ids 0..3 reserved (pad, bos, eos, unk)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--src-len", type=int, default=12)
    p.add_argument("--vocab", type=int, default=64)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--eval-size", type=int, default=64)
    p.add_argument("--beam", type=int, default=4)
    p.add_argument("--threshold", type=float, default=0.95,
                   help="minimum held-out exact-match sequence accuracy "
                        "(noise == 0)")
    p.add_argument("--noise", type=float, default=0.0,
                   help="source-corruption probability: > 0 switches to the "
                        "graded noisy-channel variant gated on token "
                        "accuracy against the Bayes ceiling")
    p.add_argument("--noise-margin", type=float, default=0.05,
                   help="allowed gap below the Bayes token-accuracy "
                        "ceiling (noise > 0)")
    p.add_argument("--arch", default="seq2seq_t")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; without a card the tool "
                        "raises unless cpu is asked for")
    return p


def make_rows(n: int, seed: int, S: int, V: int, perm: np.ndarray,
              noise: float) -> np.ndarray:
    """``n`` streams [n, 2S + 3]: source S | BOS | target S | EOS, the
    target formed from the clean source, then (noise > 0) the source
    corrupted."""
    r = np.random.default_rng(seed)
    src = r.integers(4, V, (n, S))
    tgt = perm[src - 4][:, ::-1]
    if noise > 0.0:
        corrupt = r.random((n, S)) < noise
        src = np.where(corrupt, r.integers(4, V, (n, S)), src)
    rows = np.zeros((n, 2 * S + 3), np.int64)
    rows[:, :S] = src
    rows[:, S] = BOS
    rows[:, S + 1:2 * S + 1] = tgt
    rows[:, 2 * S + 1] = EOS
    return rows


def run(args: argparse.Namespace, device: torch.device) -> dict:
    # the reference tests' size, registered as the reference's mtacc does
    s2s._VARIANTS.setdefault("seq2seq_t", dict(d_model=32, n_layers=2,
                                               n_heads=4))
    V, S = args.vocab, args.src_len
    T = 2 * S + 2  # the model's stream: src S | BOS | tgt S | EOS
    perm = np.random.default_rng(0).permutation(np.arange(4, V))
    model = s2s.build_seq2seq(args.arch, (T,), V, S, seed=0).to(device)
    cfg = RunConfig(benchmark="synthmt", strategy="single", arch=args.arch,
                    batch_size=args.batch, compute_dtype="float32",
                    optimizer="adam", label_smoothing=0.0)
    strat = SingleStrategy(model, cfg)
    strat.init()
    for step in range(args.steps):
        rows = torch.from_numpy(make_rows(args.batch, 10_000 + step, S, V,
                                          perm, args.noise)).to(device)
        x, lab = rows[:, :-1], mask_source_labels(rows[:, 1:], S)
        m = strat.train_step(x, lab, args.lr)
    final_loss = float(m["loss"])

    # held-out evaluation (a seed outside the training range)
    test = make_rows(args.eval_size, 7, S, V, perm, args.noise)
    src = torch.from_numpy(test[:, :S]).to(device)
    gold = test[:, S + 1:2 * S + 1]
    model.eval()
    outs = {
        "greedy": dec.greedy_decode(model, src, T),
        "beam": dec.beam_search_decode(model, src, T, beam=args.beam)[0],
        "paged_beam": dec.beam_search_decode(model, src, T, beam=args.beam,
                                             paged=True)[0],
        "full_forward_greedy": s2s.greedy_decode(model, src, T,
                                                 use_cache=False),
    }
    seq_acc, tok_acc = {}, {}
    for name, out in outs.items():
        pred = out.cpu().numpy()[:, S + 1:2 * S + 1]
        seq_acc[name] = float((pred == gold).all(1).mean())
        tok_acc[name] = float((pred == gold).mean())
    doc = {"tool": "mtacc", "arch": args.arch, "train_steps": args.steps,
           "final_loss": round(final_loss, 5), "eval_size": args.eval_size,
           "seq_accuracy": seq_acc, "token_accuracy": tok_acc,
           "greedy_equals_full_forward": bool(torch.equal(
               outs["greedy"], outs["full_forward_greedy"])),
           **provenance(device)}
    if args.noise > 0.0:
        # a corrupted position (prob e) is unrecoverable: the best
        # predictor maps the OBSERVED token, right with prob 1 / (V - 4)
        ceiling = (1.0 - args.noise) + args.noise / (V - 4)
        ok = all(v >= ceiling - args.noise_margin for v in tok_acc.values())
        doc.update({
            "task": f"noisy-channel variant: source corrupted with prob "
                    f"{args.noise} after the clean target is formed "
                    f"(S={S}, vocab={V}); graded, not a 100%-reachable "
                    "gate",
            "noise": args.noise, "token_ceiling": round(ceiling, 5),
            "noise_margin": args.noise_margin, "pass": ok})
    else:
        ok = (all(v >= args.threshold for v in seq_acc.values())
              and doc["greedy_equals_full_forward"])
        doc.update({
            "task": f"target = vocabulary-permuted source, reversed "
                    f"(S={S}, vocab={V}; deterministic: exact match is the "
                    "correctness bar)",
            "threshold": args.threshold, "pass": ok})
    return doc


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if args.steps < 1:
        p.error("--steps must be >= 1 (the gate measures TRAINED accuracy)")
    doc = run(args, resolve_device(args.device))
    print(json.dumps(doc), flush=True)
    return 0 if doc["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
