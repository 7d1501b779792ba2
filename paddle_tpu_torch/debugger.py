"""Program visualization: one block of a Program as Graphviz dot text (the
JAX package's debugger.py, after the reference's debugger.py
draw_block_graphviz): operators as rectangles, variables as ellipses
(parameters and highlighted vars filled in their own colours), dataflow
edges from input vars to the op to its output vars. The text is the JAX
package's for the same program; render it with any graphviz install.
"""
from __future__ import annotations

from .framework import Parameter, Program

__all__ = ["draw_block_graphviz", "program_to_dot"]


def _esc(s: str) -> str:
    return s.replace('"', r"\"")


def program_to_dot(program: Program, block_idx: int = 0,
                   highlights=None, name: str = "program") -> str:
    """Return the dot source for one block (reference draw_block_graphviz)."""
    block = program.blocks[block_idx]
    highlights = set(highlights or ())
    lines = [f'digraph "{_esc(name)}" {{', "  rankdir=TB;"]
    var_ids: dict[str, str] = {}

    def var_node(n: str) -> str:
        if n in var_ids:
            return var_ids[n]
        vid = f"var_{len(var_ids)}"
        var_ids[n] = vid
        try:
            v = block.var(n)
            label = f"{n}\\n{tuple(v.shape)} {v.dtype.value}"
            is_param = isinstance(v, Parameter)
        except KeyError:
            label, is_param = n, False
        style = ('style=filled, fillcolor="#d5e8d4"' if is_param
                 else 'style=filled, fillcolor="#f5f5f5"')
        if n in highlights:
            style = 'style=filled, fillcolor="#ffe6cc"'
        lines.append(f'  {vid} [shape=ellipse, {style}, '
                     f'label="{_esc(label)}"];')
        return vid

    for i, op in enumerate(block.ops):
        oid = f"op_{i}"
        lines.append(f'  {oid} [shape=rectangle, style=filled, '
                     f'fillcolor="#dae8fc", label="{_esc(op.type)}"];')
        for n in op.input_names:
            if n:
                lines.append(f"  {var_node(n)} -> {oid};")
        for n in op.output_names:
            if n:
                lines.append(f"  {oid} -> {var_node(n)};")
    lines.append("}")
    return "\n".join(lines)


def draw_block_graphviz(block_or_program, highlights=None, path=None,
                        name="program"):
    """Write the dot file (reference debugger.py draw_block_graphviz
    contract: (block, highlights, path)); returns the dot source."""
    if isinstance(block_or_program, Program):
        program, idx = block_or_program, 0
    else:
        program, idx = block_or_program.program, block_or_program.idx
    dot = program_to_dot(program, idx, highlights, name)
    if path:
        with open(path, "w") as f:
            f.write(dot)
    return dot
