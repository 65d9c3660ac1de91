"""Op lowerings; importing this package registers every op type of the
decoder LM's serving programs and of the BERT/ERNIE pre-training
program."""

from . import (attention_ops, extra_ops, math_ops, nn_ops,  # noqa: F401
               optimizer_ops, quant_ops, tensor_ops)
