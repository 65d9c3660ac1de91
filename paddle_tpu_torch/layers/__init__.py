"""fluid-style layers API (the subset of paddle_tpu.layers that the
decoder LM, the BERT/ERNIE pre-training, the ResNet, LeNet and WMT
Transformer programs are built from, and the learning-rate schedules)."""

from .nn import *  # noqa: F401,F403
from .nn import _elementwise_binary  # noqa: F401
from .learning_rate_scheduler import (  # noqa: F401
    cosine_decay, exponential_decay, inverse_time_decay, linear_lr_warmup,
    natural_exp_decay, noam_decay, piecewise_decay, polynomial_decay)
