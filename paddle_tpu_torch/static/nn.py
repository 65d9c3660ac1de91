"""paddle.static.nn: the 2.0 re-exports of the op-building layer
functions (the port of ``paddle_tpu/static/nn.py``). The twelve names
whose layers come with the rest of the op registry raise
NotImplementedError naming ROADMAP A7."""

from ..layers import (batch_norm, bilinear_tensor_product,  # noqa: F401
                      conv2d, create_parameter, crf_decoding, embedding, fc,
                      layer_norm, pool2d)
from ..layers.control_flow import (cond, static_loop,  # noqa: F401
                                   while_loop)

_NOT_PORTED = ("conv2d_transpose", "conv3d", "conv3d_transpose",
               "data_norm", "group_norm", "instance_norm", "nce", "prelu",
               "row_conv", "spectral_norm", "case", "switch_case")


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"static.nn.{name} is not in the port yet (ROADMAP A7)")
    raise AttributeError(f"module 'paddle_tpu_torch.static.nn' has no "
                         f"attribute {name!r}")
