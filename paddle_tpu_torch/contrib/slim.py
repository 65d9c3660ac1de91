"""Slim quantisation: the QAT transform pass, post-training quantisation
and the int8 deployment convert (port of ``paddle_tpu/contrib/slim.py``).

* ``QuantizationTransformPass`` (:33) inserts fake quantise-dequantise
  ops (ops/quant_ops.py) on the weights and input activations of the
  quantisable ops, with straight-through gradients for QAT;
* ``PostTrainingQuantization`` (:139) calibrates each activation's
  abs-max on sample batches, then freezes the scales into the program;
* ``quantize_weights_int8`` (:200) gives per-channel int8 weight arrays
  and their fp scales;
* ``convert_to_int8_program`` (:227) rewrites a clean inference program
  so that every quantisable weight is int8 in the scope: matmul-family
  ops with a calibrated activation scale become ``int8_matmul`` in its
  static-quant mode, the others ``int8_matmul`` in its weight-only mode
  (the int8 GEMM kernel), conv-family ops read through
  ``dequantize_weight``; a weight that any other op also reads stays
  fp32 (weight tying).

The programs, the int8 arrays and the scales equal the reference's (the
arrays are numpy in both packages, computed by the same numpy calls).
The scope holds tensors here: a weight is read to the host for the
convert, and its int8 array and scale vector go back as tensors on the
weight's device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import unique_name
from ..core.ir import OpDesc, Program

QUANTIZABLE_OPS = {"mul", "matmul", "matmul_v2", "conv2d",
                   "depthwise_conv2d", "fc"}
# which input slots hold (activation, weight) per op type
_SLOTS = {
    "mul": ("X", "Y"), "matmul": ("X", "Y"), "matmul_v2": ("X", "Y"),
    "conv2d": ("Input", "Filter"), "depthwise_conv2d": ("Input", "Filter"),
    "fc": ("Input", "W"),
}


def _host(value) -> np.ndarray:
    """A scope value as a numpy array on the host."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _store(scope, name: str, array: np.ndarray, like=None):
    """Put ``array`` into the scope as a tensor on ``like``'s device (a
    tensor's, else the CPU), its dtype kept."""
    dev = like.device if isinstance(like, torch.Tensor) else "cpu"
    scope.set(name, torch.from_numpy(np.ascontiguousarray(array)).to(dev))


class QuantizationTransformPass:
    """Insert weight + activation fake-qdq ops before each quantizable op
    (reference: quantization_pass.py QuantizationTransformPass).

    For QAT, apply() must run BEFORE optimizer.minimize() so the backward
    pass is built over the fake-quant ops and their straight-through
    gradients; applying after minimize leaves the backward differentiating
    the unquantized path."""

    def __init__(self, weight_bits: int = 8, activation_bits: int = 8,
                 quantizable_op_type: Optional[Sequence[str]] = None,
                 moving_rate: float = 0.9, for_test: bool = False):
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.ops = set(quantizable_op_type or QUANTIZABLE_OPS)
        self.moving_rate = moving_rate
        self.for_test = for_test

    def apply(self, program: Program, startup_program: Optional[Program] = None
              ) -> Program:
        """When startup_program is given, zero-init ops for the
        activation-scale state are appended there (otherwise call
        init_scale_state(scope) before running)."""
        block = program.global_block()
        params = {v.name for v in block.vars.values()
                  if getattr(v, "persistable", False)}
        new_ops: List[OpDesc] = []
        # keyed on (name, scheme): a var consumed under two different quant
        # schemes (other bits / other quant_axis) gets its own qdq op
        quantized: Dict[tuple, str] = {}
        scale_vars: List[str] = []
        for op in block.ops:
            if op.type in self.ops:
                act_slot, w_slot = _SLOTS[op.type]
                axis = 1 if op.type in ("mul", "matmul", "matmul_v2",
                                        "fc") else 0
                for slot, bits, channelwise in (
                        (act_slot, self.activation_bits, False),
                        (w_slot, self.weight_bits, True)):
                    names = op.inputs.get(slot)
                    if not names:
                        continue
                    src = names[0]
                    qkey = (src, bits, channelwise,
                            axis if channelwise else -1)
                    if qkey in quantized:
                        op.inputs[slot] = [quantized[qkey]]
                        continue
                    qname = unique_name.generate(src + ".quantized")
                    var = block.var(src) if block.has_var(src) else None
                    block.create_var(name=qname,
                                     shape=list(var.shape) if var else None,
                                     dtype=str(var.dtype) if var else "float32")
                    is_weight = src in params
                    if is_weight and channelwise:
                        sname = unique_name.generate(src + ".scale")
                        block.create_var(name=sname, shape=[-1],
                                         dtype="float32")
                        new_ops.append(OpDesc(
                            "fake_channel_wise_quantize_dequantize_abs_max",
                            {"X": [src]}, {"Out": [qname],
                                           "OutScale": [sname]},
                            {"bit_length": bits, "quant_axis": axis}))
                    else:
                        sname = unique_name.generate(src + ".scale")
                        state = unique_name.generate(src + ".state")
                        accum = unique_name.generate(src + ".accum")
                        for nm, shape in ((sname, [1]), (state, [1]),
                                          (accum, [1])):
                            block.create_var(name=nm, shape=shape,
                                             dtype="float32",
                                             persistable=True)
                        scale_vars.extend([sname, state, accum])
                        new_ops.append(OpDesc(
                            "fake_quantize_dequantize_moving_average_abs_max",
                            {"X": [src], "InScale": [sname],
                             "InState": [state], "InAccum": [accum]},
                            {"Out": [qname], "OutScale": [sname],
                             "OutState": [state], "OutAccum": [accum]},
                            {"bit_length": bits,
                             "moving_rate": self.moving_rate,
                             "is_test": self.for_test}))
                    quantized[qkey] = qname
                    op.inputs[slot] = [qname]
            new_ops.append(op)
        block.ops = new_ops
        # activation-scale state must exist before running: either via the
        # startup program (here) or init_scale_state(scope)
        self.scale_var_names = scale_vars
        if startup_program is not None:
            sblock = startup_program.global_block()
            for name in scale_vars:
                sblock.create_var(name=name, shape=[1], dtype="float32",
                                  persistable=True)
                sblock.append_op("fill_constant", {}, {"Out": [name]},
                                 {"shape": [1], "dtype": "float32",
                                  "value": 0.0})
        return program

    def init_scale_state(self, scope):
        for name in getattr(self, "scale_var_names", []):
            if scope.find_var(name) is None:
                _store(scope, name, np.zeros((1,), np.float32),
                       next((v for _, v in scope.items()
                             if isinstance(v, torch.Tensor)), None))


class PostTrainingQuantization:
    """Calibrate activation scales on sample batches then emit a quantized
    inference program (reference: post_training_quantization.py)."""

    def __init__(self, executor, program: Program, feed_names,
                 scope, batch_generator, weight_bits=8, activation_bits=8,
                 quantizable_op_type=None):
        self.exe = executor
        self.program = program
        self.feed_names = list(feed_names)
        self.scope = scope
        self.batches = batch_generator
        self.wbits = weight_bits
        self.abits = activation_bits
        self.op_types = set(quantizable_op_type or QUANTIZABLE_OPS)

    def quantize(self) -> Program:
        block = self.program.global_block()
        params = {v.name for v in block.vars.values()
                  if getattr(v, "persistable", False)}
        # 1. which activations feed quantizable ops
        act_names: List[str] = []
        for op in block.ops:
            if op.type in self.op_types:
                act_slot, _ = _SLOTS[op.type]
                names = op.inputs.get(act_slot)
                if names and names[0] not in params and \
                        names[0] not in act_names:
                    act_names.append(names[0])
        # 2. run calibration batches, record abs-max per activation
        scales = {n: 0.0 for n in act_names}
        fetchable = [n for n in act_names]
        for feed in self.batches:
            vals = self.exe.run(self.program, feed=feed,
                                fetch_list=fetchable, scope=self.scope,
                                use_compiled=False)
            for n, v in zip(fetchable, vals):
                scales[n] = max(scales[n], float(np.max(np.abs(v))))
        # 3. rewrite: static abs-max qdq on activations + channelwise on
        # weights (scales frozen as attrs/consts)
        qpass = QuantizationTransformPass(
            weight_bits=self.wbits, activation_bits=self.abits,
            quantizable_op_type=self.op_types, for_test=True)
        qpass.apply(self.program)
        qpass.init_scale_state(self.scope)
        # seed the frozen activation scales: moving-average vars in test
        # mode read InScale directly
        for op in self.program.global_block().ops:
            if op.type == "fake_quantize_dequantize_moving_average_abs_max":
                src = op.inputs["X"][0]
                if src in scales:
                    # an activation dead on calibration data gets scale 1.0
                    # (coarse but non-destructive) instead of 0, which
                    # would collapse nonzero inference values to ~1e-8
                    sc = scales[src] if scales[src] > 0 else 1.0
                    name = op.inputs["InScale"][0]
                    _store(self.scope, name, np.asarray([sc], np.float32),
                           self.scope.find_var(name))
        self.calibrated_scales = scales
        return self.program


def quantize_weights_int8(program: Program, scope,
                          op_types=None) -> Dict[str, dict]:
    """Deployment convert: per-channel int8 weight arrays + fp scales
    (reference: quantization_pass.py QuantizationFreezePass/convert)."""
    op_types = set(op_types or QUANTIZABLE_OPS)
    out: Dict[str, dict] = {}
    block = program.global_block()
    for op in block.ops:
        if op.type not in op_types:
            continue
        _, w_slot = _SLOTS[op.type]
        names = op.inputs.get(w_slot)
        if not names:
            continue
        base = names[0].split(".quantized")[0]
        w = scope.find_var(base)
        if w is None:
            continue
        w = np.asarray(_host(w), np.float32)
        axis = 1 if op.type in ("mul", "matmul", "matmul_v2", "fc") else 0
        red = tuple(i for i in range(w.ndim) if i != axis)
        scale = np.maximum(np.max(np.abs(w), axis=red, keepdims=True), 1e-8)
        q = np.clip(np.round(w / scale * 127.0), -127, 127).astype(np.int8)
        out[base] = {"int8": q, "scale": (scale / 127.0).squeeze()}
    return out


def convert_to_int8_program(program: Program, scope, act_scales=None,
                            op_types=None):
    """Rewrite a clean inference program so every quantisable weight is
    stored int8 in the scope, with

      * matmul-family ops whose activation has a calibrated scale
        (PostTrainingQuantization.calibrated_scales) replaced by
        ``int8_matmul`` in its static-quant mode (int8 x int8 with int32
        accumulation; an fc's bias is an ``elementwise_add`` after it),
      * matmul-family ops without one replaced by ``int8_matmul`` in its
        weight-only mode (no act_scale attr; an fc's Bias rides the op's
        Bias input): the int8 GEMM kernel (kernels/int8_gemm.py), so a
        slim-quantised model reaches the kernel with no model change,
      * every other quantisable op reading through ``dequantize_weight``.

    Returns the rewritten program; the scope is updated in place (weight
    -> int8 tensor, weight@int8_scale -> per-channel scales)."""
    act_scales = dict(act_scales or {})
    arrays = quantize_weights_int8(program, scope, op_types=op_types)
    op_types = set(op_types or QUANTIZABLE_OPS)
    block = program.global_block()
    # weights read by ANY op outside the rewrite set must stay fp in the
    # scope (e.g. a weight-tied embedding also feeding lookup_table) —
    # overwriting them with int8 would silently corrupt that consumer
    shared = set()
    for op in block.ops:
        for slot, names in op.inputs.items():
            if op.type in op_types and slot == _SLOTS.get(op.type,
                                                          ("", ""))[1]:
                continue
            shared.update(n.split(".quantized")[0] for n in names)
    new_ops = []
    dequantized = {}
    for op in block.ops:
        if op.type not in op_types:
            new_ops.append(op)
            continue
        act_slot, w_slot = _SLOTS[op.type]
        wnames = op.inputs.get(w_slot)
        base = wnames[0].split(".quantized")[0] if wnames else None
        if base not in arrays or base in shared:
            new_ops.append(op)
            continue
        q = arrays[base]
        like = scope.find_var(base)
        _store(scope, base, q["int8"], like)
        scale_name = base + "@int8_scale"
        _store(scope, scale_name,
               np.asarray(q["scale"], np.float32).reshape(-1), like)
        block.create_var(name=scale_name, persistable=True,
                         stop_gradient=True)
        aname = (op.inputs.get(act_slot) or [None])[0]
        # int8_matmul contracts the activation's LAST axis against the
        # 2-D weight: only the plainly-flattened matmul family qualifies
        # (mul with x_num_col_dims below ndim-1 reshapes first; fc
        # carries a Bias the int8 op has no slot for -> weight-only)
        # int8_matmul contracts the activation's LAST axis against the
        # 2-D weight, so only trivially-flattened shapes qualify: plain
        # matmuls always; mul/fc only when their num_col_dims equals
        # ndim-1 (otherwise they reshape first — weight-only path)
        avar = block.vars.get(aname)
        andim = len(avar.shape) if avar is not None and avar.shape else None
        xd = int(op.attrs.get(
            "in_num_col_dims" if op.type == "fc" else "x_num_col_dims", 1))
        mat_family = (op.type in ("matmul", "matmul_v2")
                      or (op.type in ("mul", "fc") and andim is not None
                          and xd == andim - 1))
        plain = not any(op.attrs.get(k) for k in
                        ("transpose_X", "transpose_Y", "trans_x",
                         "trans_y")) and \
            float(op.attrs.get("alpha", 1.0)) == 1.0
        if mat_family and plain and aname in act_scales and \
                act_scales[aname] > 0:
            out_name = op.outputs["Out"][0]
            bias_names = op.inputs.get("Bias") if op.type == "fc" else None
            if bias_names:
                # fc carries a bias: int8 GEMM into a temp, then the add
                mm_out = out_name + "@int8mm"
                block.create_var(name=mm_out, stop_gradient=True)
                new_ops.append(OpDesc(
                    "int8_matmul",
                    {"X": [aname], "Y": [base], "YScale": [scale_name]},
                    {"Out": [mm_out]},
                    {"act_scale": float(act_scales[aname])}))
                new_ops.append(OpDesc(
                    "elementwise_add",
                    {"X": [mm_out], "Y": [bias_names[0]]},
                    {"Out": [out_name]}, {"axis": -1}))
            else:
                new_ops.append(OpDesc(
                    "int8_matmul",
                    {"X": [aname], "Y": [base], "YScale": [scale_name]},
                    {"Out": [out_name]},
                    {"act_scale": float(act_scales[aname])}))
            continue
        if mat_family and plain:
            # weight-only int8 through the same op (no act_scale attr):
            # the activation stays fp and the int8 GEMM kernel applies
            # the per-channel scale in its epilogue
            out_name = op.outputs["Out"][0]
            inputs = {"X": [aname], "Y": [base], "YScale": [scale_name]}
            bias_names = op.inputs.get("Bias") if op.type == "fc" else None
            if bias_names:
                inputs["Bias"] = [bias_names[0]]
            new_ops.append(OpDesc("int8_matmul", inputs,
                                  {"Out": [out_name]}, {}))
            continue
        # weight-only non-matmul (conv family): dequantize once per
        # consumer chain
        if base not in dequantized:
            deq = base + "@dequantized"
            block.create_var(name=deq, stop_gradient=True)
            axis = 1 if mat_family else 0
            new_ops.append(OpDesc(
                "dequantize_weight", {"X": [base], "Scale": [scale_name]},
                {"Out": [deq]}, {"axis": axis}))
            dequantized[base] = deq
        op.inputs[w_slot] = [dequantized[base]]
        new_ops.append(op)
    block.ops = new_ops
    return program
