"""fluid-style layers API (the subset of paddle_tpu.layers that the
decoder LM and the BERT/ERNIE pre-training program are built from)."""

from .nn import *  # noqa: F401,F403
from .nn import _elementwise_binary  # noqa: F401
