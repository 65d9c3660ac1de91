"""Op lowerings; importing this package registers every op type of the
decoder LM's serving programs, of the BERT/ERNIE pre-training program,
of the ResNet classifier program, of the WMT Transformer program and of
the inference programs the predictor's passes rewrite, of the fleet
training chain (loss scaling, clips, regularizers, LAMB/LARS,
recomputed segments), every op type of the reference's math, tensor,
RNN, sequence, beam-search, CRF, fused-RNN and control-flow modules, and
the op types the 2.0 API (``nn``, ``tensor``, the 2.0 optimizers) calls."""

from . import (amp_ops, attention_ops, beam_search_ops,  # noqa: F401
               control_flow_ops, crf_ops, extra_ops, extra_ops2, extra_ops4,
               fused_ops, fused_rnn_ops, linalg_ops, lr_ops, math_ops,
               nn_ops, optimizer_ops, quant_ops, rnn_ops, sequence_ops,
               tensor_ops, vision_ops)
