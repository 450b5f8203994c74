"""The port's event engine (parallel/pipeline_rt.py) held to the reference's
``ScheduledPipelineStrategy`` on the CPU.

Each event schedule (1f1b, interleaved, zero-bubble, zero-bubble-h2,
searched) over two steps from the same weights (convert.py) and numpy
batches, on a stateless MLP and on the tiny transformer through the
fused LM head (and zero-bubble on the tiny MoE LM, whose router losses
seed each chunk's backward): each step's loss and accuracy and every
updated parameter (the packed chunk rows), then the eval step's sums;
at S 1, 2 and 4, M 4, V 1 and 2. Tolerances as tests/test_torch_gpipe.py: losses
rtol 1e-5, parameters rtol 1e-4 and atol 1e-6 in float32 (both sides
sum each chunk's microbatch gradients in the table's order; the kernels'
plain versions reduce in other orders than XLA's).

The split backward keeps the fused head's two kernels apart: under
zero-bubble a B event runs the head's backward with only dh needed and a
W event with only dW (ops/fused_xent.py ``fxent_dh`` / ``fxent_dw``,
counted through a monkeypatch: each once per last-chunk microbatch, and
never both in one event); under 1f1b one backward takes both.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import numpy as np
import pytest

import torch_pipes as tp

import ddlbench_tpu_torch.ops.fused_xent as fx
import ddlbench_tpu_torch.parallel.pipeline_rt as rt

pytestmark = pytest.mark.torchport

LOSS = dict(rtol=1e-5)
PARAM = dict(rtol=1e-4, atol=1e-6)

CASES = [
    ("dense", "1f1b", dict(num_devices=2)),
    ("deep", "1f1b", dict(num_devices=4)),
    ("deep", "interleaved", dict(num_devices=2, virtual_stages=2)),
    ("dense", "zero-bubble", dict(num_devices=2)),
    ("deep", "zero-bubble", dict(num_devices=2, virtual_stages=2)),
    ("deep", "zero-bubble-h2", dict(num_devices=4)),
    ("dense", "searched", dict(num_devices=2)),
    ("transformer_t", "1f1b", dict(num_devices=2)),
    ("transformer_t", "interleaved", dict(num_devices=2,
                                          virtual_stages=2)),
    ("transformer_t", "zero-bubble", dict(num_devices=2)),
    ("transformer_t", "zero-bubble-h2", dict(num_devices=2,
                                             zb_h2_stash=2)),
    ("transformer_t", "searched", dict(num_devices=2)),
    ("moe", "zero-bubble", dict(num_devices=2)),
    # one stage: its single chunk is first and last, so B has no input
    # gradient to take and W differentiates the whole objective
    ("dense", "zero-bubble", dict(num_devices=1)),
    ("transformer_t", "zero-bubble", dict(num_devices=1)),
]


@pytest.mark.parametrize("name,schedule,kw", CASES,
                         ids=[f"{n}-{s}-S{k['num_devices']}"
                              f"V{k.get('virtual_stages', 1)}"
                              for n, s, k in CASES])
def test_event_schedule_matches_the_reference(name, schedule, kw):
    mb, M = (1 if name in tp.TOKEN_MODELS else 2), 4
    pair = tp.Pair(name, "rt", strategy="gpipe", pipe_schedule=schedule,
                   micro_batch_size=mb, num_microbatches=M, **kw)
    try:
        assert pair.strat._fused_bw == pair.jstrat._fused_bw
        data = tp.batches(name, mb * M, 3)
        for x, y in data[:2]:
            jm, pm = pair.step(x, y, 0.05)
            np.testing.assert_allclose(pm["loss"], jm["loss"], **LOSS)
            assert pm["accuracy"] == pytest.approx(jm["accuracy"], abs=1e-7)
            theirs, ours = pair.params()
            np.testing.assert_allclose(ours, theirs, **PARAM)
        je, pe = pair.evaluate(*data[2])
        assert (pe["count"], pe["correct"], pe["correct5"]) == \
            (je["count"], je["correct"], je["correct5"])
        np.testing.assert_allclose(pe["loss"], je["loss"], **LOSS)
    finally:
        pair.close()


def _counting(monkeypatch):
    """Count the fused head's backward kernels per event kind."""
    calls = []
    dh, dw = fx.fxent_dh, fx.fxent_dw

    def count_dh(*a):
        calls.append("dh")
        return dh(*a)

    def count_dw(*a):
        calls.append("dw")
        return dw(*a)

    monkeypatch.setattr(fx, "fxent_dh", count_dh)
    monkeypatch.setattr(fx, "fxent_dw", count_dw)
    events = []
    b, w = rt.ScheduledPipelineStrategy._b_event, \
        rt.ScheduledPipelineStrategy._w_event

    def b_event(self, c, m, *a):
        n = len(calls)
        out = b(self, c, m, *a)
        events.append(("B", c, m, tuple(calls[n:])))
        return out

    def w_event(self, c, m, *a):
        n = len(calls)
        out = w(self, c, m, *a)
        events.append(("W", c, m, tuple(calls[n:])))
        return out

    monkeypatch.setattr(rt.ScheduledPipelineStrategy, "_b_event", b_event)
    monkeypatch.setattr(rt.ScheduledPipelineStrategy, "_w_event", w_event)
    return calls, events


@pytest.mark.parametrize("schedule,V", [("zero-bubble", 1),
                                        ("zero-bubble", 2),
                                        ("1f1b", 1)])
def test_b_and_w_events_split_the_head_kernels(monkeypatch, schedule, V):
    calls, events = _counting(monkeypatch)
    pair = tp.Pair("transformer_t", "rt", strategy="gpipe",
                   pipe_schedule=schedule, num_devices=2, virtual_stages=V,
                   micro_batch_size=1, num_microbatches=4)
    try:
        x, y = tp.batches("transformer_t", 4, 1)[0]
        pair.strat.train_step(tp.to_port(x), tp.to_port(y), 0.05)
    finally:
        pair.close()
    last = pair.strat.num_chunks - 1
    assert calls.count("dh") == calls.count("dw") == 4
    mine = [e for e in events if e[1] == last]
    if schedule == "1f1b":
        assert not [e for e in events if e[0] == "W"]
        assert sorted(e[3] for e in mine) == [("dh", "dw")] * 4
        return
    assert sorted((e[0], e[3]) for e in mine) == \
        [("B", ("dh",))] * 4 + [("W", ("dw",))] * 4
    assert all(e[3] == () for e in events if e[1] != last)
