"""Strategy-driven program rewrites (port of
``paddle_tpu/distributed/fleet/meta_optimizers.py``): the bf16 AMP
rewrite and its optimizer wrapper (:95-165), the pieces the ResNet-50
training path uses.

``rewrite_program_bf16`` casts the fp32 inputs of white-list ops to
bf16; their outputs come out bf16 at run time while their VarDescs keep
the dtype the builder gave them, as in the reference. Parameters stay
fp32 masters, so gradients and optimizer math stay fp32. Dynamic loss
scaling (``check_finite_and_unscale``, ``update_loss_scaling``) is not in
the port: bf16 needs no loss scaling.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ...core.ir import OpDesc, Program
from ...core.types import dtype_name

AMP_WHITE_LIST = {"matmul", "matmul_v2", "mul", "conv2d", "depthwise_conv2d",
                  "bmm", "flash_attention", "ring_attention"}
AMP_BLACK_LIST = {"softmax_with_cross_entropy", "cross_entropy", "layer_norm",
                  "batch_norm", "sync_batch_norm", "mean", "reduce_mean",
                  "softmax", "exp", "log"}


def rewrite_program_bf16(program: Program, white_list=None):
    """Insert one ``cast`` to bf16 before the first white-list op that
    reads each fp32 var (``<name>.cast_bf16``, shared by later readers),
    and point the white-list ops at the casts."""
    white = set(white_list or AMP_WHITE_LIST)
    block = program.global_block()
    new_ops: List[OpDesc] = []
    cast_cache: Dict[str, str] = {}
    for op in block.ops:
        if op.type in white:
            for slot, names in list(op.inputs.items()):
                new_names = []
                for n in names:
                    var = block._find_var_recursive(n)
                    if var is None or dtype_name(var.dtype) != "float32":
                        new_names.append(n)
                        continue
                    cname = cast_cache.get(n)
                    if cname is None:
                        cname = f"{n}.cast_bf16"
                        block.create_var(name=cname, shape=var.shape,
                                         dtype="bfloat16", stop_gradient=False)
                        new_ops.append(OpDesc(
                            "cast", {"X": [n]}, {"Out": [cname]},
                            {"out_dtype": "bfloat16",
                             "op_role": op.attrs.get("op_role", 0)}))
                        cast_cache[n] = cname
                    new_names.append(cname)
                op.inputs[slot] = new_names
        new_ops.append(op)
    block.ops = new_ops


class AMPOptimizer:
    """Wraps an optimizer: ``backward`` rewrites the program to bf16
    before building the gradients (reference: amp_optimizer.py and
    contrib/mixed_precision/decorator.py OptimizerWithMixedPrecision)."""

    def __init__(self, inner, configs: Optional[dict] = None):
        self.inner = inner
        self.configs = configs or {}
        if self.configs.get("use_dynamic_loss_scaling"):
            raise NotImplementedError(
                "AMP dynamic loss scaling (check_finite_and_unscale, "
                "update_loss_scaling) is not in the port; pass "
                "use_dynamic_loss_scaling=False (bf16 needs no scaling)")

    def backward(self, loss, **kw):
        rewrite_program_bf16(loss.block.program,
                             white_list=(set(AMP_WHITE_LIST)
                                         | set(self.configs.get(
                                             "custom_white_list", []))))
        return self.inner.backward(loss, **kw)

    def apply_gradients(self, params_grads):
        return self.inner.apply_gradients(params_grads)

    def minimize(self, loss, **kw):
        pg = self.backward(loss, **kw)
        return self.apply_gradients(pg), pg
