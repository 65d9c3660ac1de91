"""Op lowerings; importing this package registers every op type of the
decoder LM's serving programs, of the BERT/ERNIE pre-training program
and of the ResNet classifier program."""

from . import (attention_ops, extra_ops, math_ops, nn_ops,  # noqa: F401
               optimizer_ops, quant_ops, tensor_ops)
