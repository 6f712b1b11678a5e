"""Graphviz rendering of a StaticIR DAG.

Counterpart: ``gen_tpu/static_ir/render_ir.py``, all of it; the same dot
source for the same DAG."""

from __future__ import annotations

from .dag import (ArgumentNode, GenerativeFunctionCallNode, JuliaNode,
                  RandomChoiceNode, StaticIR, TrainableParameterNode)

_STYLE = {
    ArgumentNode: ("box", "lightblue"),
    TrainableParameterNode: ("box", "lightyellow"),
    JuliaNode: ("ellipse", "white"),
    RandomChoiceNode: ("circle", "lightpink"),
    GenerativeFunctionCallNode: ("doublecircle", "lightgreen"),
}


def render_ir(ir: StaticIR) -> str:
    """Return the graphviz dot source for the DAG."""
    lines = [f'digraph "{ir.name}" {{', "  rankdir=TB;"]
    for node in list(ir.arg_nodes) + list(ir.nodes):
        shape, color = _STYLE[type(node)]
        label = node.name
        if isinstance(node, RandomChoiceNode):
            label = f"{node.addr}\\n~ {node.dist!r}"
        elif isinstance(node, GenerativeFunctionCallNode):
            label = f"{node.addr}\\n= {node.gen_fn!r}"
        lines.append(
            f'  "{node.name}" [shape={shape}, style=filled, '
            f'fillcolor={color}, label="{label}"];')
    for node in ir.nodes:
        for inp in getattr(node, "inputs", ()):
            lines.append(f'  "{inp.name}" -> "{node.name}";')
    if ir.return_node is not None:
        lines.append('  "__return__" [shape=plaintext, label="return"];')
        lines.append(f'  "{ir.return_node.name}" -> "__return__";')
    lines.append("}")
    return "\n".join(lines)


def draw_graph(ir: StaticIR, path: str):
    """Write dot source to a file (render with `dot -Tpdf` if available)."""
    with open(path, "w") as f:
        f.write(render_ir(ir))
    return path
