"""Op lowerings; importing this package registers every op type of the
decoder LM's serving programs, of the BERT/ERNIE pre-training program,
of the ResNet classifier program, of the WMT Transformer program and of
the inference programs the predictor's passes rewrite."""

from . import (attention_ops, extra_ops, fused_ops, lr_ops,  # noqa: F401
               math_ops, nn_ops, optimizer_ops, quant_ops, tensor_ops)
