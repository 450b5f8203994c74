"""The port's per-layer profiler (profiler/profile.py) held to the
reference's on the same models.

* ``profile_model`` in flops mode on lenet (mnist), a narrow resnet18
  (16x16x3 images) and transformer_t (T 32, vocab 64), batch 4: the same
  node count, node names, activation and parameter bytes (exactly), and
  each node's forward FLOPs within FLOPS_REL of XLA's cost analysis or,
  where XLA counts next to nothing (a pool or a global average pool it
  folds away), within FLOPS_FLOOR of the model's total; the backward is
  twice the forward in both.
* ``profile_dag`` + ``packed_chain_graph`` on inception_t and nasnet_t
  (32x32x3): node count, edges and every packed boundary's bytes equal.
* Profiling changes nothing: every parameter and BatchNorm buffer of
  the narrow resnet18 bitwise as before, in both modes, and no ``.grad``
  written; a "time" profile on the CPU gives every node a positive
  forward time and the flops profile's structure.
* The Input node and its folding as in the reference; measure_input_ms,
  profile_and_partition's stage ids, and the reference's layer names
  (``layer_names``) on the MoE and LSTM stacks.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import dataclasses

import pytest
import torch

from ddlbench_tpu.config import DatasetSpec as JaxSpec, HardwareModel as JaxHW
from ddlbench_tpu.models.branchy import get_dag as jax_get_dag
from ddlbench_tpu.models.zoo import get_model as jax_get_model
from ddlbench_tpu.profiler import profile as jprof

from ddlbench_tpu_torch.config import DatasetSpec, HardwareModel
from ddlbench_tpu_torch.models.branchy import get_dag
from ddlbench_tpu_torch.models.zoo import get_model
from ddlbench_tpu_torch.profiler import profile as tprof

pytestmark = pytest.mark.torchport

# each node's forward FLOPs against XLA's count (measured worst: 9.1 %,
# nasnet_t's 1x1 adjust convolutions, whose BatchNorm XLA fuses in fewer
# passes; transformer_t's embedding 8.6 %: jnp.take's index clamps)
FLOPS_REL = 0.10
# of the model's total: a node XLA prices at (almost) nothing, e.g. a
# global average pool over a 1x1 map it folds into a reshape
FLOPS_FLOOR = 1e-3
B = 4
# peak 1e3 FLOP/s: the graph's milliseconds are then FLOPs
COUNT = dict(peak_flops=1e3)

MODELS = {
    "lenet": ("mnist", (28, 28, 1), 10, "image"),
    "resnet18": ("narrow16", (16, 16, 3), 10, "image"),
    "transformer_t": ("tinylm", (32,), 64, "tokens"),
}


def specs(arch):
    name, shape, classes, kind = MODELS[arch]
    return (JaxSpec(name, shape, classes, 100, 10, kind=kind),
            DatasetSpec(name, shape, classes, 100, 10, kind=kind))


@pytest.fixture(scope="module", params=sorted(MODELS))
def flops_pair(request):
    arch = request.param
    jspec, tspec = specs(arch)
    want = jprof.profile_model(jax_get_model(arch, jspec), B, mode="flops",
                               hw=JaxHW(**COUNT))
    got = tprof.profile_model(get_model(arch, tspec), B, mode="flops",
                              hw=HardwareModel(**COUNT))
    return arch, want, got


def test_flops_graph_structure_matches(flops_pair):
    _, want, got = flops_pair
    w, g = want.topological_sort(), got.topological_sort()
    assert [n.node_id for n in g] == [n.node_id for n in w]
    assert [n.node_desc for n in g] == [n.node_desc for n in w]
    assert [n.activation_size for n in g] == [n.activation_size for n in w]
    assert [n.parameter_size for n in g] == [n.parameter_size for n in w]
    assert got.edges == want.edges


def test_flops_per_node_within_tolerance_of_xla(flops_pair):
    arch, want, got = flops_pair
    total = sum(n.forward_compute_time for n in want.nodes.values())
    for nid, w in want.nodes.items():
        g = got.nodes[nid]
        bar = FLOPS_REL * w.forward_compute_time + FLOPS_FLOOR * total
        assert abs(g.forward_compute_time - w.forward_compute_time) <= bar, (
            arch, w.node_desc, g.forward_compute_time, w.forward_compute_time)
        assert g.backward_compute_time == 2.0 * g.forward_compute_time


def test_flops_count_ignores_the_device_path():
    """The count runs on the meta device through the plain attention
    path: the backend setting does not change it."""
    from ddlbench_tpu_torch.models.transformer import set_attention_backend

    _, tspec = specs("transformer_t")
    model = get_model("transformer_t", tspec)
    graphs = []
    for backend in ("flash", "xla", "auto"):
        set_attention_backend(backend)
        graphs.append(str(tprof.profile_model(model, B, mode="flops")))
    assert graphs[0] == graphs[1] == graphs[2]


@pytest.mark.parametrize("arch", ["inception_t", "nasnet_t"])
def test_profile_dag_and_packed_chain_match(arch):
    want_dag = jprof.profile_dag(jax_get_dag(arch, (32, 32, 3), 10), B,
                                 mode="flops", hw=JaxHW(**COUNT))
    dag = get_dag(arch, (32, 32, 3), 10)
    got_dag, shapes = tprof.profile_dag(dag, B, mode="flops",
                                        hw=HardwareModel(**COUNT),
                                        return_shapes=True)
    assert len(got_dag.nodes) == len(want_dag.nodes)
    assert got_dag.edges == want_dag.edges
    assert shapes == [tuple(layer.out_shape) for layer in dag.layers]
    for nid, w in want_dag.nodes.items():
        g = got_dag.nodes[nid]
        assert (g.node_desc, g.activation_size, g.parameter_size) == (
            w.node_desc, w.activation_size, w.parameter_size)
    want = jprof.packed_chain_graph(want_dag,
                                    jax_get_dag(arch, (32, 32, 3), 10), B)
    got = tprof.packed_chain_graph(got_dag, dag, B)
    assert [n.activation_size for n in got.topological_sort()] == \
        [n.activation_size for n in want.topological_sort()]
    assert str(tprof.coarse_chain(got_dag, dag)).count("\n") == \
        str(jprof.coarse_chain(want_dag, jax_get_dag(
            arch, (32, 32, 3), 10))).count("\n")


def _snapshot(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("mode", ["flops", "time"])
def test_profile_changes_no_parameter_or_buffer(mode):
    _, tspec = specs("resnet18")
    model = get_model("resnet18", tspec)
    model.eval()
    before = _snapshot(model)
    graph = tprof.profile_model(model, 2, mode=mode, repeats=1)
    after = model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert any("mean" in k for k in before)  # BatchNorm's statistics
    assert all(p.grad is None for p in model.parameters())
    assert not model.training  # the mode is restored
    assert len(graph.nodes) == len(model.layers)
    if mode == "time":
        assert all(n.forward_compute_time > 0 and
                   n.backward_compute_time >= 0
                   for n in graph.nodes.values() if n.node_desc != "flatten")


def test_time_profile_has_the_flops_structure():
    _, tspec = specs("transformer_t")
    model = get_model("transformer_t", tspec)
    t = tprof.profile_model(model, 2, mode="time", repeats=1)
    f = tprof.profile_model(model, 2, mode="flops")
    assert [(n.node_desc, n.activation_size, n.parameter_size)
            for n in t.topological_sort()] == \
        [(n.node_desc, n.activation_size, n.parameter_size)
         for n in f.topological_sort()]
    assert all(n.forward_compute_time > 0 and n.backward_compute_time > 0
               for n in t.nodes.values() if n.node_desc.startswith("block"))


def test_input_node_and_its_folding_match():
    jspec, tspec = specs("lenet")
    want = jprof.profile_model(jax_get_model("lenet", jspec), B,
                               mode="flops", hw=JaxHW(**COUNT),
                               input_time_ms=2.5)
    got = tprof.profile_model(get_model("lenet", tspec), B, mode="flops",
                              hw=HardwareModel(**COUNT), input_time_ms=2.5)
    w, g = want.topological_sort()[0], got.topological_sort()[0]
    assert dataclasses.asdict(g) == dataclasses.asdict(w)
    fw, fg = jprof.fold_input_node(want), tprof.fold_input_node(got)
    assert len(fg.nodes) == len(fw.nodes) == 8
    assert fg.topological_sort()[0].forward_compute_time == pytest.approx(
        got.nodes["0"].forward_compute_time + 2.5)
    assert tprof.fold_input_node(fg) is fg


def test_measure_input_ms_times_batches():
    from ddlbench_tpu_torch.data.synthetic import make_synthetic

    _, tspec = specs("lenet")
    data = make_synthetic(tspec, 8, torch.device("cpu"), seed=0)
    assert tprof.measure_input_ms(data, batches=2) >= 0.0


def test_profile_and_partition_stamps_stages():
    _, tspec = specs("lenet")
    graph, result = tprof.profile_and_partition(
        get_model("lenet", tspec), B, 2, mode="flops")
    ids = [n.stage_id for n in graph.topological_sort()]
    assert ids[0] == 0 and ids[-1] == len(result.stages) - 1
    assert ids == sorted(ids)


def test_layer_names_are_the_references():
    for arch in ("transformer_moe_t", "seq2seq_lstm_s"):
        if arch == "transformer_moe_t":
            import tiny_models

            jm = tiny_models.tiny_moe()
            tm = get_model(arch, DatasetSpec("tinylm", (32,), 64, 100, 10,
                                             kind="tokens"))
        else:
            spec = ("tinymt", (16,), 64, 100, 10)
            jm = jax_get_model(arch, JaxSpec(*spec, kind="seq2seq",
                                             src_len=8))
            tm = get_model(arch, DatasetSpec(*spec, kind="seq2seq",
                                             src_len=8))
        assert tprof.layer_names(tm) == [layer.name for layer in jm.layers]
