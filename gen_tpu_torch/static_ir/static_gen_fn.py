"""StaticGenFn: a generative function defined by a StaticIR DAG.

Counterpart: ``gen_tpu/static_ir/static_gen_fn.py``, all of it. The DAG
interprets onto the same handler machinery as ``@gen`` bodies: the body
walks the nodes in topological order and issues ``trace_at`` and
parameter reads (``active_handler().get_param``), so the whole GFI
(simulate/generate/update/regenerate/gradients) comes from
:class:`~gen_tpu_torch.dynamic.fn.GenFn` unchanged.
"""

from __future__ import annotations

from ..dynamic.fn import GenFn
from ..dynamic.handlers import active_handler, trace_at
from .dag import (GenerativeFunctionCallNode, JuliaNode, RandomChoiceNode,
                  StaticIR, TrainableParameterNode)


class StaticGenFn(GenFn):
    """GFI over a static DAG; also introspectable (``.ir``)."""

    def __init__(self, ir: StaticIR):
        self.ir = ir
        super().__init__(self._exec_ir, name=ir.name)

    def _exec_ir(self, *args):
        if len(args) != len(self.ir.arg_nodes):
            raise TypeError(
                f"{self.ir.name} expects {len(self.ir.arg_nodes)} args, "
                f"got {len(args)}")
        env = {}
        for node, value in zip(self.ir.arg_nodes, args):
            env[node.name] = value
        for node in self.ir.nodes:
            if isinstance(node, TrainableParameterNode):
                env[node.name] = active_handler().get_param(node.name)
            elif isinstance(node, JuliaNode):
                env[node.name] = node.fn(
                    *(env[i.name] for i in node.inputs))
            elif isinstance(node, RandomChoiceNode):
                env[node.name] = trace_at(
                    node.addr, node.dist,
                    *(env[i.name] for i in node.inputs))
            elif isinstance(node, GenerativeFunctionCallNode):
                env[node.name] = trace_at(
                    node.addr, node.gen_fn,
                    *(env[i.name] for i in node.inputs))
            else:
                raise TypeError(f"unknown node {node!r}")
        if self.ir.return_node is None:
            return None
        return env[self.ir.return_node.name]

    def __repr__(self):
        return f"StaticGenFn({self.ir.name}, {len(self.ir.nodes)} nodes)"


def compile_ir(ir: StaticIR) -> StaticGenFn:
    return StaticGenFn(ir)
