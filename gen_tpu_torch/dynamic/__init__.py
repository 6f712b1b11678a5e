from .fn import (GenFn, gen, get_param, get_param_grad, init_param, param,
                 set_param, set_param_grad, zero_param_grad)
from .handlers import active_handler, trace_at
from .trace import CallRecord, ChoiceRecord, DynamicTrace

__all__ = [
    "GenFn", "gen", "param", "init_param", "get_param", "set_param",
    "get_param_grad", "zero_param_grad", "set_param_grad",
    "trace_at", "active_handler", "DynamicTrace", "ChoiceRecord",
    "CallRecord",
]
