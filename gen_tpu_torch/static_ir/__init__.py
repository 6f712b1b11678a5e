from .dag import (StaticIR, StaticIRBuilder, StaticIRNode, ArgumentNode,
                  TrainableParameterNode, JuliaNode, RandomChoiceNode,
                  GenerativeFunctionCallNode)
from .static_gen_fn import StaticGenFn, compile_ir
from .render_ir import render_ir, draw_graph

__all__ = [
    "StaticIR", "StaticIRBuilder", "StaticIRNode", "ArgumentNode",
    "TrainableParameterNode", "JuliaNode", "RandomChoiceNode",
    "GenerativeFunctionCallNode", "StaticGenFn", "compile_ir",
    "render_ir", "draw_graph",
]
