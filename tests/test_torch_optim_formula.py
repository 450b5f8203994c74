"""One update formula for every strategy of the port (ROADMAP C.12).

``SingleStrategy.apply_update`` (parallel/common.flat_optimizer: the
reference's ``make_optimizer`` formulas as separate ops, which dp, the
pipelines, sp, ep, fsdp, tpp and tp run too) against the reference's
update on equal float32 gradients, over three steps on the tiny LM's
parameters, for SGD with momentum and weight decay and for Adam with
weight decay; ``torch.optim``'s update (single's before the repair) on
the same gradients is measured beside it:

* SGD: the port's update equals the reference's bitwise;
* Adam: within 1e-6 relative L2 (the port's bias corrections are
  float32 scalars folded into the rate, as the reference's are, but XLA
  and torch evaluate ``sqrt`` and the division in another order);
* either way the port's update lies no farther from the reference's
  than ``torch.optim``'s (measured on this input: SGD 0 against
  1.3e-7, Adam 2.3e-7 against 7.0e-6; PERF.md).
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddlbench_tpu.config import RunConfig as JaxRunConfig
from ddlbench_tpu.models.layers import init_model
from ddlbench_tpu.parallel.common import make_optimizer as jax_optimizer
from tiny_models import tiny_transformer

from ddlbench_tpu_torch.config import RunConfig
from ddlbench_tpu_torch.convert import from_jax_params, to_port_layout
from ddlbench_tpu_torch.models.transformer import build_transformer
from ddlbench_tpu_torch.parallel.single import SingleStrategy

pytestmark = pytest.mark.torchport

CASES = {"sgd": (dict(momentum=0.9, weight_decay=5e-4), 0.1),
         "adam": (dict(weight_decay=1e-2), 1e-3)}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("name", sorted(CASES))
def test_single_update_is_the_reference_formula(name):
    kw, lr = CASES[name]
    params = jax.device_get(init_model(tiny_transformer(),
                                       jax.random.key(3))[0])
    model = from_jax_params(build_transformer("transformer_t", (32,), 64),
                            params)
    strat = SingleStrategy(model, RunConfig(
        benchmark="synthtext", optimizer=name, **kw))
    strat.init()
    init, update = jax_optimizer(JaxRunConfig(
        benchmark="synthtext", optimizer=name, **kw))
    ref, state = params, init(params)
    start = [p.detach().clone() for p in model.parameters()]
    eager = [torch.nn.Parameter(t.clone()) for t in start]
    opt = (torch.optim.SGD(eager, lr=lr, **kw) if name == "sgd" else
           torch.optim.Adam(eager, lr=lr, **kw))
    rng = np.random.default_rng(0)
    for _ in range(3):
        grads = jax.tree.map(lambda a: (1e-2 * rng.normal(size=a.shape))
                             .astype(np.float32), params)
        ref, state = update(ref, grads, state, jnp.float32(lr))
        named = {n: to_port_layout(g) for n, g in _named(grads).items()}
        port_grads = [torch.from_numpy(np.ascontiguousarray(named[n]))
                      for n in _port_names(model)]
        strat.apply_update(port_grads, lr)
        for q, g in zip(eager, port_grads):
            q.grad = g.clone()
        opt.step()
    want = _named(jax.device_get(ref))
    names = _port_names(model)
    ref_delta = np.concatenate([(to_port_layout(want[n]) - s.numpy()).ravel()
                                for n, s in zip(names, start)])
    port_delta = np.concatenate([(p.detach() - s).numpy().ravel() for p, s
                                 in zip(model.parameters(), start)])
    torch_delta = np.concatenate([(q.detach() - s).numpy().ravel()
                                  for q, s in zip(eager, start)])
    port_dist, torch_dist = (_rel(port_delta, ref_delta),
                             _rel(torch_delta, ref_delta))
    if name == "sgd":
        for n, p in zip(names, model.parameters()):
            np.testing.assert_array_equal(p.detach().numpy(),
                                          to_port_layout(want[n]),
                                          err_msg=n)
    assert port_dist <= 1e-6, port_dist
    assert port_dist <= torch_dist, (port_dist, torch_dist)


def _named(tree):
    out = {}
    for i, layer in enumerate(tree):
        def walk(d, prefix):
            for key, val in d.items():
                if isinstance(val, dict):
                    walk(val, f"{prefix}{key}.")
                else:
                    out[f"{i}.{prefix}{key}"] = np.asarray(val)
        walk(layer, "")
    return out


def _port_names(model):
    return [f"{i}.{n}" for i, layer in enumerate(model.layers)
            for n, _ in layer.named_parameters()]


@pytest.mark.parametrize("name", sorted(CASES))
def test_flat_update_is_in_place(name):
    """Every strategy leans on ``update`` writing the new parameters and
    state into the tensors it is given (no copy back): the returned
    parameters share the inputs' storage and equal a second, fresh run of
    the formula on copies; the state's tensors stay the same objects;
    the gradients are not touched."""
    from ddlbench_tpu_torch.parallel.common import flat_optimizer

    kw, lr = CASES[name]
    init, update = flat_optimizer(RunConfig(benchmark="synthtext",
                                            optimizer=name, **kw))
    gen = torch.Generator().manual_seed(0)
    params = [torch.nn.Parameter(torch.randn(s, generator=gen))
              for s in ((3, 4), (5,))]
    grads = [torch.randn(p.shape, generator=gen) for p in params]
    start, grads0 = ([t.detach().clone() for t in ts]
                     for ts in (params, grads))
    state = init(params)
    m0 = list(state["m"])
    for _ in range(2):
        new, state2 = update(params, grads, state, lr)
    assert state2 is state and all(a is b for a, b in zip(state["m"], m0))
    assert all(n.data_ptr() == p.data_ptr() and not n.requires_grad
               for n, p in zip(new, params))
    for g, g0 in zip(grads, grads0):
        assert torch.equal(g, g0)
    copies = [t.clone() for t in start]
    state_c = init(copies)
    for _ in range(2):
        update(copies, grads, state_c, lr)
    for p, c, s in zip(params, copies, start):
        assert torch.equal(p.detach(), c) and not torch.equal(c, s)
