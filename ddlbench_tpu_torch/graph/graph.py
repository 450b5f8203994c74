"""Profile-graph IR of the port: a text-serializable weighted DAG of model
layers (the port's own copy of ``ddlbench_tpu/graph/graph.py``).

Nodes carry per-layer forward/backward compute times (ms), activation and
parameter sizes (bytes) and an optional stage_id; the graph supports
topological sort, predecessor/successor queries, antichain-DAG
construction (the partitioner's state space), partitioning by stage_id,
branch compression, a CSV import, DOT output and a text round trip in the
reference's ``graph.txt`` format, byte for byte, so a graph written by
either package loads in the other:

    node{id} -- {desc} -- forward_compute_time={f}, backward_compute_time={b},
        activation_size={a}, parameter_size={p}[ -- stage_id={s}]
    \\tnode{src} -- node{dst}

(one line per node, one tab-prefixed line per edge).

Models are flat layer chains (models/layers.py) or, for the branchy
arches, DAGs (models/branchy.py, profiler/profile.profile_dag); the
general-DAG algorithms also serve graphs imported from elsewhere. The
plots import matplotlib only when called.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple


@dataclasses.dataclass
class Node:
    node_id: str
    node_desc: str
    forward_compute_time: float = 0.0  # ms
    backward_compute_time: float = 0.0  # ms
    activation_size: float = 0.0  # bytes (output activation)
    parameter_size: float = 0.0  # bytes
    stage_id: Optional[int] = None
    # longest-path annotations, filled by populate_depths/populate_heights
    depth: Optional[int] = None
    height: Optional[int] = None

    def __str__(self) -> str:
        s = (
            f"node{self.node_id} -- {self.node_desc} -- "
            f"forward_compute_time={self.forward_compute_time:.3f}, "
            f"backward_compute_time={self.backward_compute_time:.3f}, "
            f"activation_size={self.activation_size:.3f}, "
            f"parameter_size={self.parameter_size:.3f}"
        )
        if self.stage_id is not None:
            s += f" -- stage_id={self.stage_id}"
        return s

    # the reference's small test fixtures (graph/test_graphs/test*.txt) omit
    # the "node" id prefix; accept both spellings
    _LINE_RE = re.compile(
        r"(?:node)?(?P<id>\S+) -- (?P<desc>.*) -- "
        r"forward_compute_time=(?P<f>[-\d.e]+), "
        r"backward_compute_time=(?P<b>[-\d.e]+), "
        r"activation_size=(?P<a>[-\d.e+]+), "
        r"parameter_size=(?P<p>[-\d.e+]+?)"
        r"(?: -- stage_id=(?P<stage>\d+))?$"
    )

    @classmethod
    def from_str(cls, line: str) -> "Node":
        m = cls._LINE_RE.match(line.strip())
        if not m:
            raise ValueError(f"unparseable node line: {line!r}")
        return cls(
            node_id=m.group("id"),
            node_desc=m.group("desc"),
            forward_compute_time=float(m.group("f")),
            backward_compute_time=float(m.group("b")),
            activation_size=float(m.group("a")),
            parameter_size=float(m.group("p")),
            stage_id=int(m.group("stage")) if m.group("stage") else None,
        )


class Graph:
    def __init__(self):
        self.nodes: Dict[str, Node] = {}
        self.edges: Dict[str, List[str]] = {}  # node_id -> successor ids
        self.in_edges: Dict[str, List[str]] = {}  # node_id -> predecessor ids

    # -- construction ------------------------------------------------------

    def add_node(self, node: Node) -> None:
        self.nodes[node.node_id] = node
        self.edges.setdefault(node.node_id, [])
        self.in_edges.setdefault(node.node_id, [])

    def add_edge(self, src: str, dst: str) -> None:
        self.edges.setdefault(src, []).append(dst)
        self.in_edges.setdefault(dst, []).append(src)

    @classmethod
    def chain(cls, nodes: Sequence[Node]) -> "Graph":
        g = cls()
        for n in nodes:
            g.add_node(n)
        for a, b in zip(nodes, nodes[1:]):
            g.add_edge(a.node_id, b.node_id)
        return g

    # -- queries -----------------------------------------------------------

    def sources(self) -> List[Node]:
        return [self.nodes[i] for i in self.nodes if not self.in_edges.get(i)]

    def sinks(self) -> List[Node]:
        return [self.nodes[i] for i in self.nodes if not self.edges.get(i)]

    def topological_sort(self) -> List[Node]:
        indeg = {i: len(self.in_edges.get(i, [])) for i in self.nodes}
        # stable: seed with insertion order
        ready = [i for i in self.nodes if indeg[i] == 0]
        order: List[Node] = []
        while ready:
            i = ready.pop(0)
            order.append(self.nodes[i])
            for j in self.edges.get(i, []):
                indeg[j] -= 1
                if indeg[j] == 0:
                    ready.append(j)
        if len(order) != len(self.nodes):
            raise ValueError("graph has a cycle")
        return order

    def predecessors(self, node_id: str) -> Set[str]:
        """All transitive predecessors."""
        seen: Set[str] = set()
        stack = list(self.in_edges.get(node_id, []))
        while stack:
            i = stack.pop()
            if i not in seen:
                seen.add(i)
                stack.extend(self.in_edges.get(i, []))
        return seen

    def successors(self, node_id: str) -> Set[str]:
        seen: Set[str] = set()
        stack = list(self.edges.get(node_id, []))
        while stack:
            i = stack.pop()
            if i not in seen:
                seen.add(i)
                stack.extend(self.edges.get(i, []))
        return seen

    def is_chain(self) -> bool:
        return all(len(v) <= 1 for v in self.edges.values()) and all(
            len(v) <= 1 for v in self.in_edges.values()
        )

    # -- structure annotations / analyses ----------------------------------
    # Parity: reference graph.py populate_depths/populate_heights (:87-115),
    # is_series_parallel (:229-243), check_isomorphism (:275-289) — all
    # exercised by the reference's own graph/test.py:58-91. Re-derived here
    # over the topological order (one linear pass each) instead of the
    # reference's worklist propagation.

    def populate_depths(self) -> None:
        """node.depth = longest path length (in nodes) from a source; 1 at
        sources."""
        for n in self.topological_sort():
            preds = self.in_edges.get(n.node_id, [])
            n.depth = 1 + max(
                (self.nodes[p].depth for p in preds), default=0)

    def populate_heights(self) -> None:
        """node.height = longest path length (in nodes) to a sink; 1 at
        sinks."""
        for n in reversed(self.topological_sort()):
            succs = self.edges.get(n.node_id, [])
            n.height = 1 + max(
                (self.nodes[s].height for s in succs), default=0)

    def is_series_parallel(self) -> bool:
        """True iff the DAG reduces to a single source->sink edge under
        series-parallel reduction: repeatedly contract interior nodes with
        in-degree 1 and out-degree 1 (series step), merging the parallel
        edges that contraction creates (parallel step). Two-terminal SP
        graphs — and therefore any chain-of-blocks model profile — reduce to
        exactly 2 nodes; branchy non-SP graphs (e.g. NASNet cells) get stuck
        earlier."""
        out = {i: set(v) for i, v in self.edges.items()}
        inn = {i: set(v) for i, v in self.in_edges.items()}
        alive = set(self.nodes)
        changed = True
        while changed:
            changed = False
            for i in list(alive):
                if len(out.get(i, ())) == 1 and len(inn.get(i, ())) == 1:
                    (p,), (s,) = inn[i], out[i]
                    if p == s:  # would be a cycle; never true in a DAG
                        continue
                    alive.discard(i)
                    out[p].discard(i)
                    inn[s].discard(i)
                    out[p].add(s)  # set => duplicate edges merge
                    inn[s].add(p)
                    del out[i], inn[i]
                    changed = True
        if len(alive) != 2:
            return False
        a, b = alive
        return b in out.get(a, ()) or a in out.get(b, ())

    def _canonical_order(self) -> List[Node]:
        """Deterministic topological order keyed on (node_desc, height,
        degrees) — the alignment used by check_isomorphism. Ties among
        structurally identical nodes are harmless: any alignment of them
        satisfies the checked invariants."""
        self.populate_heights()
        import heapq

        indeg = {i: len(self.in_edges.get(i, [])) for i in self.nodes}
        key = {
            i: (n.node_desc, -(n.height or 0),
                len(self.edges.get(i, [])), len(self.in_edges.get(i, [])))
            for i, n in self.nodes.items()
        }
        heap = [(key[i], i) for i in self.nodes if indeg[i] == 0]
        heapq.heapify(heap)
        order: List[Node] = []
        while heap:
            _, i = heapq.heappop(heap)
            order.append(self.nodes[i])
            for j in self.edges.get(i, []):
                indeg[j] -= 1
                if indeg[j] == 0:
                    heapq.heappush(heap, (key[j], j))
        return order

    def check_isomorphism(self, other: "Graph") -> None:
        """Raise ValueError unless ``other`` aligns with this graph under the
        canonical order: same node count, and pairwise identical node_desc,
        out-degree and in-degree. Like the reference's check this is a
        canonical-ordering approximation (sound for profile graphs whose
        descs/heights discriminate), not a general isomorphism decision."""
        a = self._canonical_order()
        b = other._canonical_order()
        if len(a) != len(b):
            raise ValueError(
                f"node counts differ: {len(a)} vs {len(b)}")
        for na, nb in zip(a, b):
            if na.node_desc != nb.node_desc:
                raise ValueError(
                    f"desc mismatch: {na.node_id}:{na.node_desc!r} vs "
                    f"{nb.node_id}:{nb.node_desc!r}")
            da = (len(self.edges.get(na.node_id, [])),
                  len(self.in_edges.get(na.node_id, [])))
            db = (len(other.edges.get(nb.node_id, [])),
                  len(other.in_edges.get(nb.node_id, [])))
            if da != db:
                raise ValueError(
                    f"degree mismatch at {na.node_id} vs {nb.node_id}: "
                    f"{da} vs {db}")

    # -- antichain DAG (partitioner state space) ---------------------------

    def antichain_dag(self) -> Tuple[List[frozenset], Dict[frozenset, List[frozenset]]]:
        """States of the partitioning DP: each state is an antichain (a set of
        mutually incomparable nodes) representing a cut frontier; an edge moves
        the frontier forward past one node. Returns (states in topological
        order, adjacency). For chain graphs this is the chain of singletons.

        Functional analog of reference graph.py:399-449 (next_antichains /
        antichain_dag), computed as reachable frontier sets.
        """
        # An antichain A denotes the done-set D = A ∪ predecessors(A); moving to
        # the next state admits one node n ∉ D whose predecessors are all in D,
        # giving antichain {n} ∪ {a ∈ A : a ∉ predecessors(n)} (the maximal
        # elements of D ∪ {n}).
        pred_cache = {i: self.predecessors(i) for i in self.nodes}
        starts = [n.node_id for n in self.sources()]
        states: List[frozenset] = []
        adj: Dict[frozenset, List[frozenset]] = {}
        seen: Set[frozenset] = set()
        queue: List[frozenset] = []
        for s0 in starts:
            st = frozenset({s0})
            if st not in seen:
                seen.add(st)
                queue.append(st)
        while queue:
            st = queue.pop(0)
            states.append(st)
            adj[st] = []
            done = set(st)
            for i in st:
                done |= pred_cache[i]
            for n in sorted(self.nodes):
                if n in done:
                    continue
                if all(p in done for p in self.in_edges.get(n, [])):
                    nxt = frozenset({n} | {a for a in st if a not in pred_cache[n]})
                    adj[st].append(nxt)
                    if nxt not in seen:
                        seen.add(nxt)
                        queue.append(nxt)
        return states, adj

    # -- partitioning ------------------------------------------------------

    def partition(self) -> List["Graph"]:
        """Split into per-stage subgraphs by stage_id (reference graph.py:117-137)."""
        stage_ids = sorted(
            {n.stage_id for n in self.nodes.values() if n.stage_id is not None}
        )
        out = []
        for sid in stage_ids:
            sub = Graph()
            members = {i for i, n in self.nodes.items() if n.stage_id == sid}
            for i in members:
                sub.add_node(self.nodes[i])
            for i in members:
                for j in self.edges.get(i, []):
                    if j in members:
                        sub.add_edge(i, j)
            out.append(sub)
        return out

    # -- branch compression (reference graph.py:139-228 + aggregate/fidelity
    # :255-275; used by optimizer/scripts/compress_graph_branches.py to shrink
    # the antichain state space of branchy graphs before the partitioning DP).

    def aggregate(self, sum_activations: bool = False) -> List[float]:
        """[fwd_time, bwd_time, parameter_size, activation_size] totals.

        activation_size counts only source nodes unless ``sum_activations``
        (reference semantics: interior activations are transfer sizes, not
        resident memory).
        """
        f = sum(n.forward_compute_time for n in self.nodes.values())
        b = sum(n.backward_compute_time for n in self.nodes.values())
        p = sum(n.parameter_size for n in self.nodes.values())
        if sum_activations:
            a = sum(n.activation_size for n in self.nodes.values())
        else:
            a = sum(n.activation_size for n in self.sources())
        return [f, b, p, a]

    def check_fidelity(self, other: "Graph", tol: float = 1e-4) -> None:
        """Assert aggregate totals match ``other`` within ``tol`` (the
        compression-preserves-cost invariant)."""
        for mine, theirs in zip(self.aggregate(), other.aggregate()):
            if mine == theirs:
                continue
            assert theirs and abs(mine / theirs - 1.0) <= tol, (
                f"aggregate mismatch: {self.aggregate()} vs {other.aggregate()}"
            )

    def compress_branches(self) -> "Graph":
        """Merge each linear branch body hanging off a fork node into one
        aggregate node (summed compute times and parameter sizes; the last
        member's activation_size), shrinking the antichain-DAG state space of
        branchy graphs while preserving aggregate cost (check_fidelity).
        Join nodes (in-degree > 1) and pure-chain graphs come back unchanged.
        """
        new = Graph()
        mapping: Dict[str, str] = {}  # old id -> new (possibly merged) id
        counter = [0]

        def ensure(nid: str) -> str:
            if nid not in mapping:
                new.add_node(dataclasses.replace(self.nodes[nid]))
                mapping[nid] = nid
            return mapping[nid]

        def compress_from(nid: str):
            """Merge the maximal run starting at nid (1-in/1-out interior; a
            trailing sink/fork is folded in; a join ends the run before it).
            Returns (merged_new_id or None, last old id of the run)."""
            if len(self.in_edges.get(nid, [])) > 1:
                return None, nid  # join node: never merged
            run = []
            cur = nid
            while True:
                run.append(cur)
                outs = self.edges.get(cur, [])
                if len(outs) != 1:
                    break  # sink or fork terminates the run (folded in)
                if len(self.in_edges.get(outs[0], [])) > 1:
                    break  # next node is a join: run ends before it
                cur = outs[0]
            if len(run) == 1:
                return None, nid
            merged = Node(f"compressed_node{counter[0]}",
                          node_desc=f"Branch {counter[0]}")
            counter[0] += 1
            for rid in run:
                n = self.nodes[rid]
                merged.forward_compute_time += n.forward_compute_time
                merged.backward_compute_time += n.backward_compute_time
                merged.parameter_size += n.parameter_size
                merged.activation_size = n.activation_size
            if len(run) == 2:
                merged.node_desc = self.nodes[run[-1]].node_desc
            new.add_node(merged)
            for rid in run:
                mapping[rid] = merged.node_id
            return merged.node_id, run[-1]

        seen: Set[str] = set()
        queue = [n.node_id for n in self.sources()]
        while queue:
            nid = queue.pop(0)
            if nid in seen:
                continue
            seen.add(nid)
            outs = list(self.edges.get(nid, []))
            if len(outs) > 1:
                src = ensure(nid)
                for o in outs:
                    cid, last = compress_from(o)
                    if cid is None:
                        new.add_edge(src, ensure(o))
                        queue.append(o)
                    else:
                        new.add_edge(src, cid)
                        queue.append(last)
            else:
                src = ensure(nid)
                for o in outs:
                    dst = ensure(o)
                    if dst != src:
                        new.add_edge(src, dst)
                    queue.append(o)
        return new

    @classmethod
    def from_profile_csv(cls, path: str) -> "Graph":
        """Build a chain graph from a per-layer profile CSV (the import path
        of optimizer/scripts/convert_profiles_to_graphs.py + utils.py
        parse_profile_file_to_graph).

        Expected columns: "Layer Type", "Total time" (summed over the N
        minibatches named by a "Forward pass time (N)" column), "Output Size"
        and "Parameter Size (floats)" (floats, 4 bytes each). The upstream
        script passes a ``compute_time`` kwarg its own Node no longer accepts
        (py2-era bit rot); here the per-layer time lands as a 1/3 : 2/3
        forward/backward split (the standard train-step ratio), documented
        deviation.
        """
        import csv as _csv

        g = cls()
        prev: Optional[str] = None
        with open(path) as f:
            rows = list(_csv.reader(f))
        if not rows:
            raise ValueError(f"{path}: empty profile CSV (expected a header "
                             "row with 'Total time' etc.)")
        header = rows[0]
        num_minibatches = 1
        for cell in header:
            if "Forward pass time" in cell:
                if "(" not in cell:
                    raise ValueError(
                        f"{path}: 'Forward pass time' header cell must name "
                        f"the minibatch count, e.g. 'Forward pass time (100)';"
                        f" got {cell!r}")
                num_minibatches = int(cell.split("(")[1].rstrip(")"))
        def col(row, name, default=0.0):
            for i, cell in enumerate(header):
                if name in cell:
                    return float(row[i].replace(",", "")) if row[i] else default
            return default
        for k, row in enumerate(rows[1:]):
            if not row:
                continue
            total_ms = col(row, "Total time") / num_minibatches * 1000.0
            node = Node(
                node_id=str(k),
                node_desc=row[header.index("Layer Type")]
                if "Layer Type" in header else f"layer{k}",
                forward_compute_time=total_ms / 3.0,
                backward_compute_time=total_ms * 2.0 / 3.0,
                activation_size=col(row, "Output Size") * 4.0,
                parameter_size=col(row, "Parameter Size (floats)") * 4.0,
            )
            g.add_node(node)
            if prev is not None:
                g.add_edge(prev, node.node_id)
            prev = node.node_id
        return g

    # -- serialization -----------------------------------------------------

    def __str__(self) -> str:
        lines = [str(n) for n in self.topological_sort()]
        for i in self.nodes:
            for j in self.edges.get(i, []):
                lines.append(f"\tnode{i} -- node{j}")
        return "\n".join(lines)

    @classmethod
    def from_str(cls, text: str) -> "Graph":
        g = cls()
        edge_re = re.compile(r"\s+(?:node)?(\S+) -- (?:node)?(\S+)")
        for line in text.splitlines():
            if not line.strip():
                continue
            if line.startswith("\t"):
                m = edge_re.match(line)
                if not m:
                    raise ValueError(f"unparseable edge line: {line!r}")
                g.add_edge(m.group(1), m.group(2))
            else:
                g.add_node(Node.from_str(line))
        return g

    # -- visualization -----------------------------------------------------
    # Parity: reference graph.py:482-499 (to_dot via the graphviz package) and
    # :501-615 (matplotlib CDF + bar plots). DOT source is emitted directly so
    # no graphviz runtime is required; plots gate on matplotlib import.

    def to_dot(self, path: Optional[str] = None) -> str:
        """Render as Graphviz DOT source; node labels carry the profile fields.

        Returns the DOT text; if ``path`` is given, also writes it there.
        """

        def esc(s: str) -> str:
            return s.replace("\\", "\\\\").replace('"', '\\"')

        lines = ["digraph {"]
        for n in self.topological_sort():
            label = (
                f"{esc(n.node_desc)}\\n"
                f"fwd={n.forward_compute_time:.3f}ms bwd={n.backward_compute_time:.3f}ms\\n"
                f"act={n.activation_size / 1e6:.2f}MB params={n.parameter_size / 1e6:.2f}MB"
            )
            if n.stage_id is not None:
                label += f"\\nstage={n.stage_id}"
            lines.append(f'  "node{esc(n.node_id)}" [label="{label}"];')
        for i in self.nodes:
            for j in self.edges.get(i, []):
                lines.append(f'  "node{esc(i)}" -> "node{esc(j)}";')
        lines.append("}")
        text = "\n".join(lines) + "\n"
        if path:
            with open(path, "w") as f:
                f.write(text)
        return text

    def plot_cdfs(self, path: str) -> None:
        """CDFs of per-node compute time, activation size, and parameter size
        (reference graph.py:501-557 render_bar_graphs_and_cdfs)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        nodes = self.topological_sort()
        series = [
            ("compute time (ms)",
             sorted(n.forward_compute_time + n.backward_compute_time for n in nodes)),
            ("activation size (bytes)", sorted(n.activation_size for n in nodes)),
            ("parameter size (bytes)", sorted(n.parameter_size for n in nodes)),
        ]
        fig, axes = plt.subplots(1, 3, figsize=(15, 4))
        for ax, (label, xs) in zip(axes, series):
            total = sum(xs) or 1.0
            cum, ys = 0.0, []
            for v in xs:
                cum += v
                ys.append(100.0 * cum / total)
            ax.plot(range(len(xs)), ys)
            ax.set_xlabel("node index (sorted)")
            ax.set_ylabel("cumulative % of total")
            ax.set_title(label)
        fig.tight_layout()
        fig.savefig(path)
        plt.close(fig)

    def plot_bars(self, path: str) -> None:
        """Per-node bar charts in topological order (reference graph.py:559-615)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        nodes = self.topological_sort()
        idx = range(len(nodes))
        fields = [
            ("fwd+bwd time (ms)",
             [n.forward_compute_time + n.backward_compute_time for n in nodes]),
            ("activation size (MB)", [n.activation_size / 1e6 for n in nodes]),
            ("parameter size (MB)", [n.parameter_size / 1e6 for n in nodes]),
        ]
        fig, axes = plt.subplots(3, 1, figsize=(max(8, len(nodes) * 0.25), 9))
        for ax, (label, ys) in zip(axes, fields):
            ax.bar(idx, ys)
            ax.set_ylabel(label)
        axes[-1].set_xlabel("node (topological order)")
        fig.tight_layout()
        fig.savefig(path)
        plt.close(fig)

    # -- aggregates --------------------------------------------------------

    def total_compute(self) -> float:
        return sum(
            n.forward_compute_time + n.backward_compute_time
            for n in self.nodes.values()
        )

    def total_parameter_bytes(self) -> float:
        return sum(n.parameter_size for n in self.nodes.values())
