"""Control-flow layers: cond, while_loop, static_loop, DynamicRNN,
IfElse and the rank-table and tensor-array layers (port of
``paddle_tpu/layers/control_flow.py``).

Branch and body functions are traced into child blocks of the current
program (``_trace_sub_block``) and run by the sub-block ops of
``ops/control_flow_ops.py``. What a sub-block reads from outside
(``_block_external_reads``) becomes the op's inputs, exactly as the
reference computes it: a read missed here would be a wrong result, not
an error.

Gradients: ``cond``, ``static_loop`` (so ``DynamicRNN``) and a
``while_loop`` with ``grad_max_iters`` differentiate through the generic
vjp grad maker; an unbounded ``while_loop`` does not, and asking for its
gradient raises at build time.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

from ..core.ir import Block, Variable, default_main_program

from ..layer_helper import LayerHelper


def _as_list(v):
    if v is None:
        return []
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _trace_sub_block(fn, args=()):
    """Run `fn` with ops captured into a fresh child block. Returns
    (block, output Variables)."""
    program = default_main_program()
    blk = program.create_block()
    try:
        outs = fn(*args)
    finally:
        program.rollback()
    return blk, _as_list(outs)


def _block_external_reads(blocks: Sequence[Block],
                          extra_needed: Sequence[str] = ()) -> List[str]:
    """Names read by the blocks' ops but not produced inside them, plus
    any `extra_needed` names (e.g. branch OUTPUTS no op produces — an
    identity branch returns an outer var directly) — all must be fed to
    the lowering's env. Reuses the executor's canonical dataflow walk."""
    from ..core.executor import _analyze_block

    reads: List[str] = []
    seen = set()
    produced = set()
    for blk in blocks:
        ext, writes = _analyze_block(blk)
        produced.update(writes)
        for n in ext:
            if n not in seen:
                seen.add(n)
                reads.append(n)
    for n in extra_needed:
        if n not in produced and n not in seen:
            seen.add(n)
            reads.append(n)
    return reads


def cond(pred: Variable, true_fn: Callable, false_fn: Optional[Callable] = None,
         name=None):
    """paddle.static.nn.cond — both branches trace into sub-blocks and must
    return the same structure of Variables (or both None). The ``cond`` op
    reads ``pred`` on the host and runs only the branch it takes."""
    helper = LayerHelper("cond", name=name)
    true_blk, true_outs = _trace_sub_block(true_fn)
    false_blk, false_outs = _trace_sub_block(false_fn) if false_fn else (None, [])
    if len(true_outs) != len(false_outs):
        # includes false_fn=None with a value-returning true_fn: both
        # branches must give the same output structure
        raise ValueError(
            f"cond branches must return the same number of outputs "
            f"(true: {len(true_outs)}, false: {len(false_outs)}"
            f"{'; provide a false_fn' if false_fn is None else ''})")
    ext = _block_external_reads(
        [b for b in (true_blk, false_blk) if b],
        extra_needed=[v.name for v in true_outs + false_outs])
    ext = [n for n in ext if n != pred.name]
    out_vars = [helper.create_variable_for_type_inference(
        v.dtype if hasattr(v, "dtype") else "float32")
        for v in (true_outs or [])]
    helper.append_op(
        "cond", {"Cond": [pred], "X": ext},
        {"Out": [v.name for v in out_vars]},
        {"true_block": true_blk, "false_block": false_blk,
         "input_names": list(ext), "cond_name": pred.name,
         "true_out_names": [v.name for v in true_outs],
         "false_out_names": [v.name for v in false_outs]})
    if not out_vars:
        return None
    return out_vars[0] if len(out_vars) == 1 else out_vars


def while_loop(cond_fn: Callable, body_fn: Callable,
               loop_vars: Sequence[Variable], name=None,
               grad_max_iters: int = 0):
    """paddle.static.nn.while_loop — a dynamic trip count: the host reads
    the condition before each trip.

    grad_max_iters=N makes the loop reverse-differentiable (the
    reference while_op's sub-block grad capability,
    controlflow/while_op.cc): the lowering becomes a bounded N-step
    loop on the device whose carry freezes once the condition turns
    false, so backward flows through exactly the iterations that ran.
    Without it the loop is forward-only, and its gradient raises at
    build time."""
    helper = LayerHelper("while_loop", name=name)
    loop_vars = _as_list(loop_vars)
    cond_blk, cond_outs = _trace_sub_block(cond_fn, loop_vars)
    if len(cond_outs) != 1:
        raise ValueError("while_loop cond_fn must return one boolean")
    body_blk, body_outs = _trace_sub_block(body_fn, loop_vars)
    if len(body_outs) != len(loop_vars):
        raise ValueError(
            f"body_fn must return as many values as loop_vars "
            f"({len(body_outs)} vs {len(loop_vars)})")
    carry_names = [v.name for v in loop_vars]
    ext = [n for n in _block_external_reads(
        [cond_blk, body_blk],
        extra_needed=[v.name for v in cond_outs + body_outs])
        if n not in carry_names]
    out_vars = [helper.create_variable_for_type_inference(v.dtype)
                for v in loop_vars]
    helper.append_op(
        "while_loop", {"X": [v.name for v in loop_vars], "Ext": ext},
        {"Out": [v.name for v in out_vars]},
        {"cond_block": cond_blk, "body_block": body_blk,
         "carry_names": carry_names,
         "cond_out_name": cond_outs[0].name,
         "body_out_names": [v.name for v in body_outs],
         "ext_names": list(ext),
         "grad_max_iters": int(grad_max_iters)})
    return out_vars


def static_loop(n: int, body_fn: Callable, loop_vars: Sequence[Variable],
                name=None):
    """Fixed-trip-count loop on the device — reverse-differentiable (the
    StaticRNN role). body_fn(i_var, *loop_vars) -> new loop_vars."""
    helper = LayerHelper("static_loop", name=name)
    loop_vars = _as_list(loop_vars)
    program = default_main_program()
    blk = program.create_block()
    try:
        i_var = blk.create_var(name=helper.name + ".i", shape=[],
                               dtype="int32", stop_gradient=True)
        body_outs = _as_list(body_fn(i_var, *loop_vars))
    finally:
        program.rollback()
    if len(body_outs) != len(loop_vars):
        raise ValueError("body_fn must return as many values as loop_vars")
    carry_names = [v.name for v in loop_vars]
    ext = [n for n in _block_external_reads(
        [blk], extra_needed=[v.name for v in body_outs])
        if n not in carry_names and n != i_var.name]
    out_vars = [helper.create_variable_for_type_inference(v.dtype)
                for v in loop_vars]
    helper.append_op(
        "static_loop", {"X": [v.name for v in loop_vars], "Ext": ext},
        {"Out": [v.name for v in out_vars]},
        {"body_block": blk, "carry_names": carry_names,
         "i_name": i_var.name, "num_steps": int(n),
         "body_out_names": [v.name for v in body_outs],
         "ext_names": list(ext)})
    return out_vars


class DynamicRNN:
    """Variable-length RNN builder (reference: layers/control_flow.py
    DynamicRNN — LoD-driven decode loops over lod_rank_table). Padded
    -dense redesign: sequences stay [B, S, D] with a Length tensor; the
    loop is ONE differentiable static_loop over S steps whose
    memories FREEZE once a row passes its length (`where(i < len, new,
    old)`) — bit-equal final states to the reference's shrinking-batch
    schedule, static shapes (a compiled step captures the loop)
    instead of LoD bookkeeping. The reference's array read/write ops back the per-step
    access (ops/control_flow_ops.py array_read/array_write).

    Usage (fluid surface):
        drnn = DynamicRNN()
        with drnn.block():
            w = drnn.step_input(emb, length=seq_len)   # [B, D] per step
            prev = drnn.memory(shape=[H])
            h = some_layers(w, prev)
            drnn.update_memory(prev, h)
            drnn.output(h)
        out = drnn()                 # [B, S, H], zero past each length
    """

    def __init__(self, name=None):
        from ..core import unique_name

        self.helper = LayerHelper("dynamic_rnn", name=name)
        self._uname = unique_name.generate(name or "drnn")
        self._program = default_main_program()
        self._step_inputs = []     # (stacked outer [S,B,D], step var)
        self._memories = []        # dict per memory
        self._outputs = []         # (outer zero buffer, inblock buf name,
        #                             step value var, out name)
        self._length = None
        self._max_len = None
        self._blk = None
        self._i = None
        self._results = None

    # -- inside-block API ---------------------------------------------------
    def block(self):
        import contextlib

        @contextlib.contextmanager
        def cm():
            self._blk = self._program.create_block()
            self._i = self._blk.create_var(
                name=f"{self._uname}.i", shape=[], dtype="int32",
                stop_gradient=True)
            try:
                yield
            except BaseException:
                # assembling a half-built block would mask the user's
                # error with an unrelated secondary failure
                self._program.rollback()
                raise
            else:
                self._program.rollback()
                self._assemble()

        return cm()

    def _parent_block(self):
        return self._program.blocks[self._blk.parent_idx]

    def step_input(self, x: Variable, length: Optional[Variable] = None):
        """Declare a [B, S, D...] sequence input; returns its [B, D...]
        slice for the current step."""
        assert self._blk is not None, "call inside drnn.block()"
        if length is not None:
            self._length = length
        if self._max_len is None:
            if x.shape[1] is None or int(x.shape[1]) <= 0:
                raise ValueError(
                    f"DynamicRNN.step_input: the sequence dim of "
                    f"{x.name} is dynamic ({x.shape}) — the padded loop "
                    f"needs a static max length (reshape/pad the input)")
            self._max_len = int(x.shape[1])
        parent = self._parent_block()
        perm = [1, 0] + list(range(2, len(x.shape)))
        stacked = parent.create_var(
            name=f"{x.name}.{self._uname}.steps",
            shape=[x.shape[1], x.shape[0]] + list(x.shape[2:]),
            dtype=x.dtype, stop_gradient=bool(x.stop_gradient))
        parent.append_op("transpose2", {"X": [x.name]},
                         {"Out": [stacked.name]}, {"axis": perm})
        step = self._blk.create_var(
            name=f"{stacked.name}.t", shape=[x.shape[0]] + list(x.shape[2:]),
            dtype=x.dtype, stop_gradient=bool(x.stop_gradient))
        self._blk.append_op("array_read", {"X": [stacked.name],
                                           "I": [self._i.name]},
                            {"Out": [step.name]}, {})
        self._step_inputs.append((stacked, step))
        return step

    def static_input(self, x: Variable):
        """A non-sequence input visible every step (ext capture)."""
        return x

    def memory(self, init: Optional[Variable] = None, shape=None,
               value: float = 0.0, dtype="float32"):
        assert self._blk is not None, "call inside drnn.block()"
        parent = self._parent_block()
        if init is None:
            if shape is None:
                raise ValueError("memory() needs init= or shape=")
            if not self._step_inputs:
                raise ValueError("declare a step_input before a "
                                 "shape-initialised memory (batch size)")
            stacked = self._step_inputs[0][0]
            b = stacked.shape[1]
            init = parent.create_var(
                name=f"{self._uname}.mem{len(self._memories)}.init",
                shape=[b] + list(shape), dtype=dtype, stop_gradient=True)
            # batch dim may be dynamic (-1): copy it from the stacked
            # input at run time (reference fill_constant_batch_size_like)
            parent.append_op(
                "fill_constant_batch_size_like",
                {"Input": [stacked.name]}, {"Out": [init.name]},
                {"shape": [1] + list(shape), "value": float(value),
                 "dtype": dtype, "input_dim_idx": 1,
                 "output_dim_idx": 0})
        mem = self._blk.create_var(
            name=f"{self._uname}.mem{len(self._memories)}",
            shape=list(init.shape), dtype=init.dtype)
        self._memories.append({"init": init, "mem": mem, "update": None})
        return mem

    def update_memory(self, mem: Variable, new: Variable):
        assert self._blk is not None, "call inside drnn.block()"
        rec = next(r for r in self._memories if r["mem"] is mem)
        if self._length is not None:
            new = self._masked(new, mem)
        rec["update"] = new

    def _masked(self, new: Variable, old: Variable):
        """where(i < length, new, old) — freeze finished rows."""
        blk = self._blk
        self._mask_n = getattr(self, "_mask_n", 0) + 1
        n = self._mask_n
        cond = blk.create_var(name=f"{self._uname}.live{n}",
                              shape=[old.shape[0]], dtype="bool",
                              stop_gradient=True)
        blk.append_op("less_than",
                      {"X": [self._i.name], "Y": [self._length.name]},
                      {"Out": [cond.name]}, {})
        for _ in range(max(len(old.shape) - 1, 0)):
            c2 = blk.create_var(name=f"{cond.name}.u",
                                shape=list(cond.shape) + [1],
                                dtype="bool", stop_gradient=True)
            blk.append_op("unsqueeze2", {"X": [cond.name]},
                          {"Out": [c2.name]},
                          {"axes": [len(cond.shape)]}, infer_shape=False)
            cond = c2
        out = blk.create_var(name=f"{new.name}.sel{n}",
                             shape=list(old.shape), dtype=old.dtype)
        blk.append_op("where", {"Condition": [cond.name], "X": [new.name],
                                "Y": [old.name]}, {"Out": [out.name]}, {})
        return out

    def output(self, *outs):
        assert self._blk is not None, "call inside drnn.block()"
        parent = self._parent_block()
        for o in outs:
            s = self._max_len
            buf_init = parent.create_var(
                name=f"{self._uname}.out{len(self._outputs)}.buf",
                shape=[s] + list(o.shape), dtype=o.dtype,
                stop_gradient=True)
            if self._step_inputs and any(d in (-1, None)
                                         for d in o.shape or ()):
                parent.append_op(
                    "fill_constant_batch_size_like",
                    {"Input": [self._step_inputs[0][0].name]},
                    {"Out": [buf_init.name]},
                    {"shape": [s, 1] + list(o.shape[1:]), "value": 0.0,
                     "dtype": str(o.dtype), "input_dim_idx": 1,
                     "output_dim_idx": 1})
            else:
                parent.append_op(
                    "fill_constant", {}, {"Out": [buf_init.name]},
                    {"shape": [s] + list(o.shape), "value": 0.0,
                     "dtype": str(o.dtype)})
            buf = self._blk.create_var(
                name=f"{buf_init.name}.c", shape=list(buf_init.shape),
                dtype=o.dtype)
            if self._length is not None:
                zero = self._blk.create_var(
                    name=f"{o.name}.z{len(self._outputs)}",
                    shape=list(o.shape), dtype=o.dtype,
                    stop_gradient=True)
                self._blk.append_op(
                    "fill_constant_batch_size_like",
                    {"Input": [o.name]}, {"Out": [zero.name]},
                    {"shape": [1] + list(o.shape[1:]), "value": 0.0,
                     "dtype": str(o.dtype), "input_dim_idx": 0,
                     "output_dim_idx": 0})
                o = self._masked(o, zero)
            new_buf = self._blk.create_var(
                name=f"{buf.name}.w", shape=list(buf.shape), dtype=o.dtype)
            self._blk.append_op("array_write",
                                {"X": [buf.name], "I": [self._i.name],
                                 "V": [o.name]},
                                {"Out": [new_buf.name]}, {})
            self._outputs.append({"init": buf_init, "buf": buf,
                                  "new_buf": new_buf})

    # -- assembly -----------------------------------------------------------
    def _assemble(self):
        blk = self._blk
        carries = [r["mem"] for r in self._memories] \
            + [r["buf"] for r in self._outputs]
        inits = [r["init"] for r in self._memories] \
            + [r["init"] for r in self._outputs]
        body_outs = []
        for r in self._memories:
            body_outs.append(r["update"] if r["update"] is not None
                             else r["mem"])
        body_outs += [r["new_buf"] for r in self._outputs]
        ext = [n for n in _block_external_reads(
            [blk], extra_needed=[v.name for v in body_outs])
            if n not in {c.name for c in carries} and n != self._i.name]
        out_vars = [self.helper.create_variable_for_type_inference(v.dtype)
                    for v in inits]
        self.helper.append_op(
            "static_loop", {"X": [v.name for v in inits], "Ext": ext},
            {"Out": [v.name for v in out_vars]},
            {"body_block": blk, "carry_names": [c.name for c in carries],
             "i_name": self._i.name, "num_steps": int(self._max_len),
             "body_out_names": [v.name for v in body_outs],
             "ext_names": list(ext)})
        n_mem = len(self._memories)
        finals = []
        for k, bufv in enumerate(out_vars[n_mem:]):
            # [S, B, D...] -> [B, S, D...] (rank from the init buffer —
            # static_loop outputs skip shape inference)
            rank = len(self._outputs[k]["init"].shape)
            out = self.helper.create_variable_for_type_inference(bufv.dtype)
            self.helper.append_op("transpose2", {"X": [bufv.name]},
                                  {"Out": [out.name]},
                                  {"axis": [1, 0] + list(range(2, rank))})
            finals.append(out)
        self._results = {"memories": out_vars[:n_mem], "outputs": finals}

    def __call__(self):
        assert self._results is not None, "finish drnn.block() first"
        outs = self._results["outputs"]
        return outs[0] if len(outs) == 1 else outs

    def final_memories(self):
        """Final (length-frozen) memory states — the reference's
        drnn memory at sequence end."""
        return self._results["memories"]


def lod_rank_table(x, level=0, name=None):
    """Build the length-descending rank table (reference:
    layers/control_flow.py lod_rank_table over lod_rank_table_op.cc).
    Padded form: x is the per-row Length tensor [B]; returns the
    (Items, Index) pair consumed by lod_tensor_to_array /
    array_to_lod_tensor / shrink_memory."""
    helper = LayerHelper("lod_rank_table", name=name)
    items = helper.create_variable_for_type_inference("int32", True)
    index = helper.create_variable_for_type_inference("int32", True)
    helper.append_op("lod_rank_table", {"X": [x]},
                     {"Items": [items], "Index": [index]}, {})
    return items, index


def lod_tensor_to_array(x, table, name=None):
    """reference: layers/control_flow.py lod_tensor_to_array
    (lod_tensor_to_array_op.cc). `table` is the (Items, Index) pair from
    lod_rank_table; returns the [S, B, ...] step-stacked array with
    finished rows zeroed."""
    helper = LayerHelper("lod_tensor_to_array", name=name)
    items, index = table
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("lod_tensor_to_array",
                     {"X": [x], "RankTable": [items, index]},
                     {"Out": [out]}, {})
    return out


def array_to_lod_tensor(x, table, name=None):
    """reference: layers/control_flow.py array_to_lod_tensor — inverse of
    lod_tensor_to_array."""
    helper = LayerHelper("array_to_lod_tensor", name=name)
    items, index = table
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("array_to_lod_tensor",
                     {"X": [x], "RankTable": [items, index]},
                     {"Out": [out]}, {})
    return out


def shrink_memory(x, i, table, name=None):
    """reference: layers/control_flow.py shrink_memory
    (shrink_rnn_memory_op.cc) — zero the rank-ordered memory rows whose
    sequence finished before step i (static-shape form of the
    shrinking-batch decode)."""
    helper = LayerHelper("shrink_memory", name=name)
    items, index = table
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("shrink_rnn_memory",
                     {"X": [x], "RankTable": [items, index], "I": [i]},
                     {"Out": [out]}, {})
    return out


class IfElse:
    """Row-wise two-branch control flow over split/merge_lod_tensor
    (reference: python/paddle/fluid/layers/control_flow.py IfElse, built
    on split_lod_tensor_op.cc / merge_lod_tensor_op.cc).

    cond is a [B,1] boolean tensor. `ie.input(x)` inside a branch block
    returns that branch's row subset of x; `ie.output(...)` registers
    branch results; calling `ie()` merges true/false outputs row-wise.

    Static-shape re-design: the reference COMPACTS each branch's rows; here
    both branch tensors keep the full [B, ...] shape with the other
    branch's rows zeroed (split_lod_tensor docstring) — merge picks
    row-wise, so results match the reference for row-local branch
    bodies. Branch code that mixes rows (batch norms/reductions) would
    see the zero rows; use layers.cond for whole-batch branching.

    ::

        ie = layers.IfElse(mask)
        with ie.true_block():
            ie.output(ie.input(x) * 2.0)
        with ie.false_block():
            ie.output(ie.input(x) - 1.0)
        out, = ie()
    """

    def __init__(self, cond, name=None):
        self.cond = cond
        self.helper = LayerHelper("if_else", name=name)
        self._in_true = None
        self._true_outs = []
        self._false_outs = []
        self._splits = {}

    def _block(self, branch):
        import contextlib

        @contextlib.contextmanager
        def guard():
            if self._in_true is not None:
                raise RuntimeError("IfElse blocks cannot nest")
            self._in_true = branch
            try:
                yield
            finally:
                self._in_true = None

        return guard()

    def true_block(self):
        return self._block(True)

    def false_block(self):
        return self._block(False)

    def input(self, x):
        if self._in_true is None:
            raise RuntimeError("IfElse.input() must run inside "
                               "true_block()/false_block()")
        if x.name not in self._splits:
            t = self.helper.create_variable_for_type_inference(x.dtype)
            f = self.helper.create_variable_for_type_inference(x.dtype)
            self.helper.append_op(
                "split_lod_tensor", {"X": [x], "Mask": [self.cond]},
                {"OutTrue": [t], "OutFalse": [f]}, {})
            self._splits[x.name] = (t, f)
        t, f = self._splits[x.name]
        return t if self._in_true else f

    def output(self, *outs):
        if self._in_true is None:
            raise RuntimeError("IfElse.output() must run inside "
                               "true_block()/false_block()")
        (self._true_outs if self._in_true else self._false_outs).extend(outs)

    def __call__(self):
        if len(self._true_outs) != len(self._false_outs):
            raise ValueError(
                f"IfElse branches registered different output counts "
                f"(true {len(self._true_outs)}, false "
                f"{len(self._false_outs)})")
        merged = []
        for t, f in zip(self._true_outs, self._false_outs):
            out = self.helper.create_variable_for_type_inference(t.dtype)
            self.helper.append_op(
                "merge_lod_tensor",
                {"InTrue": [t], "InFalse": [f], "Mask": [self.cond]},
                {"Out": [out]}, {})
            merged.append(out)
        return merged
