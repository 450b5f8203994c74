"""Graph-file utilities over the profile graph's text format (the
reference's ``tools/graphtool.py``), on the port's graph/graph.py:

    python -m ddlbench_tpu_torch.tools.graphtool compress graph.txt out_dir
    python -m ddlbench_tpu_torch.tools.graphtool from-csv profile.csv out_dir
    python -m ddlbench_tpu_torch.tools.graphtool dot graph.txt out_dir

Each subcommand writes ``graph.txt`` (reference-format text) and ``graph.dot``
into ``out_dir``. ``compress`` merges linear branch bodies
(Graph.compress_branches) and verifies aggregate fidelity; ``from-csv``
imports a per-layer profile CSV (Graph.from_profile_csv). No matplotlib
is imported (the graph's plots import it only when called).
"""

from __future__ import annotations

import argparse
import os
import sys

from ddlbench_tpu_torch.graph.graph import Graph


def _emit(g: Graph, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "graph.txt"), "w") as f:
        f.write(str(g))
    g.to_dot(os.path.join(out_dir, "graph.dot"))
    print(f"wrote {out_dir}/graph.txt ({len(g.nodes)} nodes) and graph.dot")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="graphtool", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("compress", "from-csv", "dot"):
        sp = sub.add_parser(name)
        sp.add_argument("input")
        sp.add_argument("out_dir")
    args = p.parse_args(argv)

    if args.cmd == "from-csv":
        g = Graph.from_profile_csv(args.input)
    else:
        with open(args.input) as f:
            g = Graph.from_str(f.read())
    if args.cmd == "compress":
        c = g.compress_branches()
        g.check_fidelity(c)
        print(f"compressed {len(g.nodes)} -> {len(c.nodes)} nodes "
              f"(aggregate cost preserved)")
        g = c
    _emit(g, args.out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
