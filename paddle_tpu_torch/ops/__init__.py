"""Op lowerings; importing this package registers every op type of the
decoder LM's serving programs, of the BERT/ERNIE pre-training program,
of the ResNet classifier program and of the WMT Transformer program."""

from . import (attention_ops, extra_ops, lr_ops, math_ops,  # noqa: F401
               nn_ops, optimizer_ops, quant_ops, tensor_ops)
