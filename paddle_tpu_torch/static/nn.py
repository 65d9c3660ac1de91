"""paddle.static.nn: the 2.0 re-exports of the op-building layer
functions (the port of ``paddle_tpu/static/nn.py``). The six names
whose op types come with the rest of the op registry (``extra_ops2``'s
conv3d, conv3d_transpose, data_norm, nce and row_conv, ``nn_ops``'
spectral_norm) raise NotImplementedError naming ROADMAP A7."""

from ..layers import (batch_norm, bilinear_tensor_product,  # noqa: F401
                      case, conv2d, conv2d_transpose, create_parameter,
                      crf_decoding, embedding, fc, group_norm, instance_norm,
                      layer_norm, pool2d, prelu, switch_case)
from ..layers.control_flow import (cond, static_loop,  # noqa: F401
                                   while_loop)

_NOT_PORTED = ("conv3d", "conv3d_transpose", "data_norm", "nce",
               "row_conv", "spectral_norm")


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"static.nn.{name} is not in the port yet (ROADMAP A7)")
    raise AttributeError(f"module 'paddle_tpu_torch.static.nn' has no "
                         f"attribute {name!r}")
