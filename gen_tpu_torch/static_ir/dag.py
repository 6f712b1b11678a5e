"""Static IR: an explicit DAG modeling language.

Counterpart: ``gen_tpu/static_ir/dag.py``, all of it: the node types
(ArgumentNode, TrainableParameterNode, JuliaNode, RandomChoiceNode,
GenerativeFunctionCallNode), the validated :class:`StaticIR` and its
builder. The DAG interprets onto the same handler machinery as ``@gen``
bodies (:mod:`.static_gen_fn`); what it adds is the explicit graph: a
validated, introspectable, renderable model structure (see
:mod:`.render_ir`). A JuliaNode's function is a torch function here.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

from ..address import Address
from ..dists.distribution import Distribution
from ..gfi import GenerativeFunction


class StaticIRNode:
    """Base node; ``name`` is the SSA-style variable name."""

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return f"{type(self).__name__}({self.name})"


class ArgumentNode(StaticIRNode):
    def __init__(self, name: str, index: int):
        super().__init__(name)
        self.index = index


class TrainableParameterNode(StaticIRNode):
    def __init__(self, name: str):
        super().__init__(name)


class JuliaNode(StaticIRNode):
    """A pure deterministic function of its input nodes (the reference's
    name for an opaque host-language computation; here a torch function)."""

    def __init__(self, name: str, fn: Callable,
                 inputs: Sequence[StaticIRNode]):
        super().__init__(name)
        self.fn = fn
        self.inputs = tuple(inputs)


class RandomChoiceNode(StaticIRNode):
    def __init__(self, name: str, dist: Distribution,
                 inputs: Sequence[StaticIRNode], addr: Address):
        super().__init__(name)
        self.dist = dist
        self.inputs = tuple(inputs)
        self.addr = addr


class GenerativeFunctionCallNode(StaticIRNode):
    def __init__(self, name: str, gen_fn: GenerativeFunction,
                 inputs: Sequence[StaticIRNode], addr: Address):
        super().__init__(name)
        self.gen_fn = gen_fn
        self.inputs = tuple(inputs)
        self.addr = addr


class StaticIR:
    """A validated DAG in topological order (the builder enforces
    define-before-use, unique names, unique addresses — reference
    dag.jl:120-213)."""

    def __init__(self, nodes, arg_nodes, return_node, name):
        self.nodes = tuple(nodes)
        self.arg_nodes = tuple(arg_nodes)
        self.return_node = return_node
        self.name = name

    @property
    def choice_nodes(self):
        return [n for n in self.nodes if isinstance(n, RandomChoiceNode)]

    @property
    def call_nodes(self):
        return [n for n in self.nodes
                if isinstance(n, GenerativeFunctionCallNode)]

    @property
    def addresses(self):
        return [n.addr for n in self.nodes
                if isinstance(n, (RandomChoiceNode,
                                  GenerativeFunctionCallNode))]


class StaticIRBuilder:
    """Builder mirroring the reference's ``StaticIRBuilder``."""

    def __init__(self, name: str = "static_model"):
        self.name = name
        self._nodes = []
        self._arg_nodes = []
        self._names = set()
        self._addrs = set()
        self._return_node: Optional[StaticIRNode] = None

    def _check_name(self, name):
        if name in self._names:
            raise ValueError(f"duplicate node name {name!r}")
        self._names.add(name)

    def _check_addr(self, addr):
        if addr in self._addrs:
            raise ValueError(f"duplicate address {addr!r}")
        self._addrs.add(addr)

    def _check_inputs(self, inputs):
        for n in inputs:
            if n not in self._nodes and n not in self._arg_nodes:
                raise ValueError(
                    f"input node {n!r} not defined in this builder")

    def argument(self, name: str) -> ArgumentNode:
        self._check_name(name)
        node = ArgumentNode(name, len(self._arg_nodes))
        self._arg_nodes.append(node)
        return node

    def parameter(self, name: str) -> TrainableParameterNode:
        self._check_name(name)
        node = TrainableParameterNode(name)
        self._nodes.append(node)
        return node

    def julia(self, fn: Callable, inputs: Sequence[StaticIRNode],
              name: Optional[str] = None) -> JuliaNode:
        name = name or f"j{len(self._nodes)}"
        self._check_name(name)
        self._check_inputs(inputs)
        node = JuliaNode(name, fn, inputs)
        self._nodes.append(node)
        return node

    def choice(self, dist: Distribution, inputs: Sequence[StaticIRNode],
               addr: Address, name: Optional[str] = None) -> RandomChoiceNode:
        name = name or f"choice_{addr}"
        self._check_name(name)
        self._check_addr(addr)
        self._check_inputs(inputs)
        node = RandomChoiceNode(name, dist, inputs, addr)
        self._nodes.append(node)
        return node

    def call(self, gen_fn: GenerativeFunction,
             inputs: Sequence[StaticIRNode], addr: Address,
             name: Optional[str] = None) -> GenerativeFunctionCallNode:
        name = name or f"call_{addr}"
        self._check_name(name)
        self._check_addr(addr)
        self._check_inputs(inputs)
        node = GenerativeFunctionCallNode(name, gen_fn, inputs, addr)
        self._nodes.append(node)
        return node

    def set_return(self, node: StaticIRNode):
        self._return_node = node

    def build(self) -> "StaticIR":
        return StaticIR(self._nodes, self._arg_nodes, self._return_node,
                        self.name)
