"""Program visualization entry points of the reference's net_drawer.py
(draw_graph, parse_graph), rendered through `debugger.program_to_dot` (the
JAX package's net_drawer.py). The DOT text needs no package; the
`graphviz` package is needed only to rasterize it.

    python -m paddle_tpu_torch.net_drawer program.json --graph out.dot

reads a program that Program.to_dict wrote as JSON.
"""
from __future__ import annotations

import argparse
import json
import logging

from .debugger import program_to_dot
from .framework import Program

__all__ = ["draw_graph", "parse_graph"]

logger = logging.getLogger(__name__)


def parse_graph(program: Program, block_idx: int = 0) -> str:
    """DOT text for one block of `program` (reference parse_graph builds the
    graphviz object; the DOT string is the portable equivalent)."""
    return program_to_dot(program, block_idx=block_idx)


def draw_graph(startup_program: Program, main_program: Program,
               graph_path: str | None = None,
               startup_graph_path: str | None = None) -> str:
    """Write DOT for the main (and optionally startup) program; returns the
    main program's DOT text (reference net_drawer.py:89 draw_graph)."""
    dot = parse_graph(main_program)
    if graph_path:
        with open(graph_path, "w") as f:
            f.write(dot)
        logger.info("wrote %s", graph_path)
    if startup_graph_path:
        with open(startup_graph_path, "w") as f:
            f.write(parse_graph(startup_program))
        logger.info("wrote %s", startup_graph_path)
    return dot


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("program_json",
                        help="program serialized by Program.to_dict (JSON)")
    parser.add_argument("--graph", default=None, help="main graph DOT path")
    parser.add_argument("--startup_graph", default=None,
                        help="also treat the input as the startup program "
                             "and write its DOT here")
    args = parser.parse_args()
    with open(args.program_json) as f:
        prog = Program.from_dict(json.load(f))
    dot = draw_graph(prog, prog, graph_path=args.graph,
                     startup_graph_path=args.startup_graph)
    if not args.graph:
        print(dot)


if __name__ == "__main__":
    main()
