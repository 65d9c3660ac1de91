"""fluid-style layers API: the subset of paddle_tpu.layers that the
ported programs are built from, the learning-rate schedules, the
control-flow layers (``control_flow.py``), and the generated wrappers of
the registered ops (``generated.py``)."""

from .nn import *  # noqa: F401,F403
from .nn import (_elementwise_binary, _compare, _getitem, _to_var,  # noqa: F401
                 _unary, _binary, _reduce_layer)
from .learning_rate_scheduler import (  # noqa: F401
    cosine_decay, exponential_decay, inverse_time_decay, linear_lr_warmup,
    natural_exp_decay, noam_decay, piecewise_decay, polynomial_decay)
from .control_flow import (DynamicRNN, IfElse, array_to_lod_tensor,  # noqa: F401
                           cond, lod_rank_table, lod_tensor_to_array,
                           shrink_memory, static_loop, while_loop)

from . import generated as _generated  # noqa: E402,F401
from .generated import *  # noqa: F401,F403,E402
