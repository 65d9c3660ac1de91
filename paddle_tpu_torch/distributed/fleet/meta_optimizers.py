"""Strategy-driven program rewrites (port of
``paddle_tpu/distributed/fleet/meta_optimizers.py``): each wraps an inner
optimizer and rewrites the program.

* the DP gradient allreduce (:36-61): a no-op at one rank, which is all
  the port runs; above one it raises (ROADMAP A8);
* AMP (:95-204): the bf16 rewrite casts the fp32 inputs of white-list
  ops to bf16; their outputs come out bf16 at run time while their
  VarDescs keep the dtype the model code gave them, as in the reference.
  Parameters stay fp32 masters, so gradients and optimizer math stay
  fp32. With ``use_dynamic_loss_scaling`` the loss is multiplied by a
  persistable scale, and ``check_finite_and_unscale`` and
  ``update_loss_scaling`` (``ops/amp_ops.py``) run before the update;
* recompute (:207-293): the forward ops between checkpoints become
  ``block_call`` segments (``ops/control_flow_ops.py``), which the
  backward recomputes;
* gradient merge (:299-365): each gradient is summed into a persistable
  ``@GradAcc``; a counter, ``elementwise_mod`` and ``equal`` give the
  fire flag; a ``conditional_block`` scales the accumulators (with
  ``avg``), runs the inner optimizer's update and zeroes them. The
  update ops write their state in place, and the ``conditional_block``
  runs its sub-block only where the flag holds (it decides on the host),
  so a step that does not fire leaves every parameter and moment as it
  was;
* the LARS/LAMB swap (:647-663).

DGC, LocalSGD and sharding are not in the port
(``fleet_base.DistributedOptimizer`` refuses them).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ...core import unique_name
from ...core.ir import Block, OpDesc, OpRole, Program, default_main_program
from ...core.types import dtype_name
from ...layers import nn as L


def insert_grad_allreduce(program: Program, params_grads, nranks: int,
                          axis_name="dp", average: bool = True):
    """The reference's [scale(1/n) +] c_allreduce_sum of each gradient,
    which is nothing at one rank; above one it raises: the collectives
    are not in the port."""
    if nranks <= 1:
        return
    raise NotImplementedError(
        f"data parallelism over {nranks} ranks (the gradient allreduce) is "
        f"not in the port: ROADMAP A8")


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
    """Wraps an optimizer (reference: amp_optimizer.py and
    contrib/mixed_precision/decorator.py OptimizerWithMixedPrecision):
    ``backward`` rewrites the program to bf16 and, with
    ``use_dynamic_loss_scaling``, multiplies the loss by a persistable
    ``loss_scaling`` var (``init_loss_scaling``) before building the
    gradients; ``apply_gradients`` then unscales the gradients and updates
    the scale before the inner optimizer's ops."""

    def __init__(self, inner, configs: Optional[dict] = None):
        self.inner = inner
        self.configs = configs or {}
        self._loss_scaling_var = None

    def backward(self, loss, **kw):
        rewrite_program_bf16(loss.block.program,
                             white_list=(set(AMP_WHITE_LIST)
                                         | set(self.configs.get(
                                             "custom_white_list", []))))
        if self.configs.get("use_dynamic_loss_scaling"):
            self._loss_scaling_var = L.create_global_var(
                [1], self.configs.get("init_loss_scaling", 32768.0),
                "float32", persistable=True,
                name=unique_name.generate("loss_scaling"))
            loss = loss * self._loss_scaling_var
        return self.inner.backward(loss, **kw)

    def apply_gradients(self, params_grads):
        if self.configs.get("use_dynamic_loss_scaling"):
            params_grads = append_loss_scaling_ops(
                params_grads, self._loss_scaling_var)
        return self.inner.apply_gradients(params_grads)

    def minimize(self, loss, **kw):
        pg = self.backward(loss, **kw)
        return self.apply_gradients(pg), pg

    def __getattr__(self, item):
        return getattr(self.inner, item)


def append_loss_scaling_ops(params_grads, scale_var):
    """check_finite_and_unscale and update_loss_scaling over every
    gradient (reference: operators/amp/*), with new ``good_steps`` and
    ``bad_steps`` int32 counters. As in the reference, the ratios and step
    counts are the op's defaults (incr every 1000 good steps by 2, decr
    after 2 bad ones by 0.5), whatever the configs say (ROADMAP C)."""
    block = default_main_program().current_block()
    good = L.create_global_var([1], 0, "int32", persistable=True,
                               name=unique_name.generate("good_steps"))
    bad = L.create_global_var([1], 0, "int32", persistable=True,
                              name=unique_name.generate("bad_steps"))
    grads = [g for _, g in params_grads]
    found_inf = block.create_var(
        name=unique_name.generate("found_inf"), dtype="bool", shape=(1,),
        stop_gradient=True)
    block.append_op("check_finite_and_unscale",
                    {"X": grads, "Scale": [scale_var]},
                    {"Out": grads, "FoundInfinite": [found_inf]}, {})
    block.append_op("update_loss_scaling",
                    {"X": grads, "FoundInfinite": [found_inf],
                     "PrevLossScaling": [scale_var], "InGoodSteps": [good],
                     "InBadSteps": [bad]},
                    {"Out": grads, "LossScaling": [scale_var],
                     "OutGoodSteps": [good], "OutBadSteps": [bad]},
                    {"incr_every_n_steps": 1000, "decr_every_n_nan_or_inf": 2,
                     "incr_ratio": 2.0, "decr_ratio": 0.5})
    return params_grads


def _segment_external_io(ops: List[OpDesc], block: Block,
                         later_reads: set) -> Tuple[List[str], List[str]]:
    """(the vars the ops read before any of them writes them, the vars
    they write that ``later_reads`` holds), each in first-seen order."""
    produced = set()
    reads: List[str] = []
    for op in ops:
        for n in op.input_names():
            if n not in produced and n not in reads:
                reads.append(n)
        produced.update(op.output_names())
    outs = [n for n in dict.fromkeys(
        n for op in ops for n in op.output_names())
        if n in later_reads]
    return reads, outs


class GradientMergeOptimizer:
    """Accumulate the gradients of ``k_steps`` micro-batches, then run the
    inner optimizer's update on their sum (divided by k with ``avg``)
    inside a ``conditional_block`` (reference: optimizer.py:5025)."""

    def __init__(self, inner, k_steps: int = 1, avg: bool = True):
        self.inner = inner
        self.k_steps = int(k_steps)
        self.avg = avg

    def backward(self, loss, **kw):
        return self.inner.backward(loss, **kw)

    def minimize(self, loss, **kw):
        pg = self.backward(loss, **kw)
        ops = self.apply_gradients(pg)
        return ops, pg

    def apply_gradients(self, params_grads):
        k = self.k_steps
        if k <= 1:
            return self.inner.apply_gradients(params_grads)
        program = default_main_program()
        block = program.global_block()
        with program._role_guard(OpRole.Optimize):
            acc_pg = []
            for p, g in params_grads:
                acc = L.create_global_var(list(p.shape), 0.0, "float32",
                                          persistable=True,
                                          name=f"{p.name}@GradAcc")
                block.append_op("sum", {"X": [acc, g]}, {"Out": [acc]}, {})
                acc_pg.append((p, block.var(acc.name)))
            counter = L.create_global_var([1], 0.0, "float32",
                                          persistable=True,
                                          name=unique_name.generate("gm_step"))
            block.append_op("increment", {"X": [counter]}, {"Out": [counter]},
                            {"step": 1.0})
            kvar = L.fill_constant([1], "float32", float(k))
            rem = block.create_var(name=unique_name.generate("gm_rem"),
                                   stop_gradient=True)
            block.append_op("elementwise_mod", {"X": [counter], "Y": [kvar]},
                            {"Out": [rem]}, {"axis": -1})
            zero = L.fill_constant([1], "float32", 0.0)
            fire = block.create_var(name=unique_name.generate("gm_fire"),
                                    dtype="bool", stop_gradient=True)
            block.append_op("equal", {"X": [rem], "Y": [zero]},
                            {"Out": [fire]}, {})

            # the update sub-block: scale, the inner update, reset
            sub = program.create_block(parent_idx=0)
            try:
                scaled_pg = []
                for p, acc in acc_pg:
                    if self.avg:
                        sub.append_op("scale", {"X": [acc]}, {"Out": [acc]},
                                      {"scale": 1.0 / k})
                    scaled_pg.append((p, acc))
                self.inner.apply_gradients(scaled_pg)
                for p, acc in acc_pg:
                    sub.append_op("scale", {"X": [acc]}, {"Out": [acc]},
                                  {"scale": 0.0})
            finally:
                program.rollback()

            reads, _ = _segment_external_io(sub.ops, sub, set())
            reads = list(dict.fromkeys(reads))
            written = list(dict.fromkeys(
                n for op in sub.ops for n in op.output_names()))
            # every output also passes through the branch not taken
            io_names = list(dict.fromkeys(reads + written))
            block.append_op(
                "conditional_block",
                {"Cond": [fire], "X": io_names},
                {"Out": written},
                {"sub_block": sub, "input_names": io_names,
                 "output_names": written})
        return []

    def __getattr__(self, item):
        return getattr(self.inner, item)


class RecomputeOptimizer:
    """Activation recompute (reference: optimizer.py:4547 /
    fleet recompute_optimizer.py): before the backward is built, the
    forward ops are cut after each op that writes a checkpoint, and each
    segment of two ops or more (not the last, not one that writes a
    persistable) becomes a ``block_call`` over a new sub-block, with
    ``remat``. The backward recomputes each segment from its inputs, so
    only the segments' inputs and outputs outlive the forward."""

    def __init__(self, inner, checkpoints: Optional[List] = None):
        self.inner = inner
        self._checkpoints = [c if isinstance(c, str) else c.name
                             for c in (checkpoints or [])]

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = [c if isinstance(c, str) else c.name
                             for c in checkpoints]

    def _rewrite(self, program: Program, loss_name: str):
        block = program.global_block()
        ckpts = set(self._checkpoints)
        if not ckpts:
            return
        segments: List[List[OpDesc]] = [[]]
        for op in block.ops:
            segments[-1].append(op)
            if any(n in ckpts for n in op.output_names()):
                segments.append([])
        if not segments[-1]:
            segments.pop()
        # what the later segments (and the loss) read, per segment
        suffix_reads: List[set] = [set() for _ in segments]
        acc: set = {loss_name}
        for i in range(len(segments) - 1, -1, -1):
            suffix_reads[i] = set(acc)
            for op in segments[i]:
                acc.update(op.input_names())
        new_ops: List[OpDesc] = []
        for i, seg in enumerate(segments):
            last = i == len(segments) - 1
            persist_out = any(
                block.has_var(n) and block.var(n).persistable
                for op in seg for n in op.output_names())
            if last or len(seg) < 2 or persist_out:
                new_ops.extend(seg)
                continue
            reads, outs = _segment_external_io(
                seg, block, suffix_reads[i] | ckpts)
            sub = Block(program, len(program.blocks), 0)
            sub.ops = list(seg)
            program.blocks.append(sub)
            new_ops.append(OpDesc(
                "block_call", {"X": reads}, {"Out": outs},
                {"sub_block": sub, "input_names": reads,
                 "output_names": outs, "remat": True,
                 "op_role": OpRole.Forward}))
        block.ops = new_ops

    def backward(self, loss, **kw):
        self._rewrite(loss.block.program, loss.name)
        return self.inner.backward(loss, **kw)

    def apply_gradients(self, params_grads):
        return self.inner.apply_gradients(params_grads)

    def minimize(self, loss, **kw):
        pg = self.backward(loss, **kw)
        return self.apply_gradients(pg), pg

    def __getattr__(self, item):
        return getattr(self.inner, item)


def maybe_swap_large_batch_optimizer(inner, strategy):
    """Momentum -> LarsMomentum with ``strategy.lars``, Adam -> Lamb with
    ``strategy.lamb`` (reference: lars_optimizer.py / lamb_optimizer.py).
    As in the reference, the new optimizer keeps the inner one's learning
    rate and momentum but not its ``grad_clip`` or ``regularization``
    (ROADMAP C)."""
    from ... import optimizer as opt

    if strategy.lars and isinstance(inner, opt.MomentumOptimizer) and \
            not isinstance(inner, opt.LarsMomentumOptimizer):
        return opt.LarsMomentumOptimizer(
            inner._learning_rate, momentum=inner._momentum,
            **strategy.lars_configs)
    if strategy.lamb and isinstance(inner, opt.AdamOptimizer) and \
            not isinstance(inner, opt.LambOptimizer):
        return opt.LambOptimizer(
            inner._learning_rate,
            lamb_weight_decay=strategy.lamb_configs.get("lamb_weight_decay",
                                                        0.01))
    return inner
