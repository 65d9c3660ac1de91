"""Control-flow ops that hold a sub-block, and the tensor-array ops of the
control-flow layers (port of ``paddle_tpu/ops/control_flow_ops.py``:
block_call :30, conditional_block :56, while :86, print :114, cond :125,
while_loop :162 with its grad maker :257, static_loop :276, array_read
:305, array_write :318, lod_rank_table :330, split_lod_tensor :344,
merge_lod_tensor :365, run_program :380; and of
``paddle_tpu/ops/extra_ops4.py``: shrink_rnn_memory :122,
lod_tensor_to_array :142, array_to_lod_tensor :162).

A sub-block runs through ``executor.run_sub_block`` in a local env of its
own, under the caller's grad mode, with the seed-table slots of its
random ops (``__seeds__``, ``rng.seed_slots``). Every gradient here is
the generic ``__vjp_grad__``, which runs the op again under autograd.

``block_call`` is the segment op of the recompute rewrite
(``distributed/fleet/meta_optimizers.py`` ``RecomputeOptimizer``): its
``__vjp_grad__`` recomputes the sub-block, so between the forward and
the backward only the call's inputs and outputs stay alive, which is
what the reference's ``jax.checkpoint`` (``remat``) gives. A random op
of the sub-block draws in the recompute the bits of its forward.

Two kinds of loop and branch. ``static_loop``, a ``while_loop`` with
``grad_max_iters`` (a masked loop of that many steps) and so
``DynamicRNN`` have a fixed trip count and read nothing on the host, so
a compiled step captures them into its CUDA graph. ``conditional_block``,
``cond``, ``while``, an unbounded ``while_loop`` and ``print`` decide on
the host, as the reference's lax ops do on concrete values: one read of
the predicate a decision, and a branch that is not taken does not run
(the optimizer ops of a gradient-merge block update their state in
place, so running a branch and selecting its result would be wrong). A
compiled step that holds one runs uncaptured (``executor.host_decider``).
On meta tensors (the cost model's count) a decision counts the true
branch, or one trip of a loop."""

from __future__ import annotations

import contextlib
import weakref

import torch

from ..core.registry import (creating_on, creation_device,
                             default_grad_maker, register_grad_maker,
                             register_op)


def _run(blk, env, attrs, keep):
    from ..core.executor import run_sub_block

    run_sub_block(blk, env, step=attrs.get("__step__"),
                  seeds=attrs.get("__seeds__"), keep=keep)
    return env


def _scalar(t):
    return t.reshape(()) if t.dim() else t


def _decide(t):
    """The host's reading of a predicate tensor (one read), or None on
    meta tensors, where nothing can be read."""
    if t.device.type == "meta":
        return None
    return bool(_scalar(t))


@register_op("block_call", skip_infer_shape=True,
             required_attrs=("sub_block", "input_names", "output_names"))
def block_call(ins, attrs):
    """Out (the values of ``output_names``) of the sub-block run on X (the
    values of ``input_names``)."""
    out_names = list(attrs["output_names"])
    env = dict(zip(attrs["input_names"], ins["X"]))
    _run(attrs["sub_block"], env, attrs, out_names)
    return {"Out": [env[n] for n in out_names]}


@register_op("conditional_block", skip_infer_shape=True,
             non_diff_inputs=("Cond",), decides_on_host=True,
             required_attrs=("sub_block", "input_names", "output_names"))
def conditional_block(ins, attrs):
    """The sub-block run on X where Cond holds; where it does not, the
    sub-block does not run and each output passes through the input of
    its name (so every output name is also an input name)."""
    out_names = list(attrs["output_names"])
    env = dict(zip(attrs["input_names"], ins["X"]))
    if _decide(ins["Cond"][0]) is not False:
        _run(attrs["sub_block"], env, attrs, out_names)
    return {"Out": [env[n] for n in out_names]}


@register_op("while", skip_infer_shape=True, non_diff_inputs=("Condition",),
             decides_on_host=True,
             required_attrs=("sub_block", "carry_names", "cond_name"))
def while_op(ins, attrs):
    """The sub-block run on the carry (X, the values of ``carry_names``,
    the condition var among them) while ``cond_name`` holds; the sub-block
    rewrites the condition each trip."""
    names = list(attrs["carry_names"])
    cond = attrs["cond_name"]
    vals = list(ins["X"])
    while True:
        env = dict(zip(names, vals))
        go = _decide(env[cond])
        if go is False:
            break
        _run(attrs["sub_block"], env, attrs, names)
        vals = [env[n] for n in names]
        if go is None:
            break
    return {"Out": vals}


@register_op("print", skip_infer_shape=True, decides_on_host=True)
def print_op(ins, attrs):
    """Prints ``message: X`` on the host (a read of X) and passes X on."""
    x = ins["X"][0]
    if x.device.type != "meta":
        print(f"{attrs.get('message', 'print_op')}: "
              f"{x.detach().cpu().numpy()}", flush=True)
    return {"Out": x}


@register_op("cond", skip_infer_shape=True, non_diff_inputs=("Cond",),
             decides_on_host=True,
             required_attrs=("true_block", "input_names",
                             "true_out_names", "false_out_names"))
def cond_two_branch(ins, attrs):
    """Runs ``true_block`` or ``false_block`` (none: the inputs pass
    through) on X as Cond decides, and gives that branch's outputs. The
    branches may read the predicate by ``cond_name``. With no outputs
    nothing runs, as in the reference."""
    t_out = list(attrs["true_out_names"])
    if not t_out:
        return {"Out": []}
    pred = ins["Cond"][0]
    take = _decide(pred) is not False
    blk = attrs["true_block"] if take else attrs.get("false_block")
    out_names = t_out if take else list(attrs["false_out_names"])
    env = dict(zip(attrs["input_names"], ins["X"]))
    if attrs.get("cond_name"):
        env[attrs["cond_name"]] = pred
    if blk is not None:
        _run(blk, env, attrs, out_names)
    return {"Out": [env[n] for n in out_names]}


def _loop_fns(ins, attrs):
    """(cond_fn, body_fn) of a ``while_loop`` on a carry list: each runs
    its sub-block in a new env of the loop's external reads and the
    carry."""
    carry_names = list(attrs["carry_names"])
    ext = dict(zip(attrs["ext_names"], ins.get("Ext", [])))
    cond_out = attrs["cond_out_name"]
    body_out = list(attrs["body_out_names"])

    def cond_fn(carry):
        env = dict(ext)
        env.update(zip(carry_names, carry))
        _run(attrs["cond_block"], env, attrs, [cond_out])
        return _scalar(env[cond_out])

    def body_fn(carry):
        env = dict(ext)
        env.update(zip(carry_names, carry))
        _run(attrs["body_block"], env, attrs, body_out)
        return [env[n] for n in body_out]

    return cond_fn, body_fn


def truncation_message(max_iters: int) -> str:
    return (f"while_loop: bounded scan truncated at {max_iters} "
            f"iterations — the runtime trip count exceeds grad_max_iters "
            f"(set from the traced example input); results are WRONG for "
            f"this input. Pass to_static(fn, loop_max_iters=N) / "
            f"while_loop(grad_max_iters=N) with a larger bound.")


@register_op("while_loop", skip_infer_shape=True,
             required_attrs=("cond_block", "body_block", "carry_names",
                             "body_out_names", "ext_names", "cond_out_name"),
             decides_on_host=lambda attrs: not int(
                 attrs.get("grad_max_iters", 0) or 0))
def while_loop_op(ins, attrs):
    """The body run on the carry X while the cond block holds, with the
    loop's external reads (Ext). Without ``grad_max_iters`` the host reads
    the condition before each trip. With ``grad_max_iters=N`` the loop is
    N masked steps on the device (each step's result kept only where the
    condition held before it), which autograd differentiates through the
    trips that ran; if the condition still holds after N steps the result
    is wrong for this input: op by op that raises, in a compiled step it
    leaves a flag that the executor reads with the fetches and warns on
    (``executor.truncation_guard``)."""
    from ..core.executor import truncation_guard

    cond_fn, body_fn = _loop_fns(ins, attrs)
    carry = list(ins["X"])
    max_iters = int(attrs.get("grad_max_iters", 0) or 0)
    if max_iters > 0:
        for _ in range(max_iters):
            active = cond_fn(carry)
            carry = [torch.where(active, n, c)
                     for n, c in zip(body_fn(carry), carry)]
        truncation_guard(cond_fn(carry), truncation_message(max_iters))
        return {"Out": carry}
    while True:
        go = _decide(cond_fn(carry))
        if go is False:
            break
        carry = body_fn(carry)
        if go is None:
            break
    return {"Out": carry}


@register_grad_maker("while_loop")
def _while_loop_grad_maker(op, out_grads, in_grads):
    """An unbounded loop has no gradient: asking for one raises here, at
    build time; with ``grad_max_iters`` the generic vjp differentiates
    the masked loop."""
    if not int(op.attrs.get("grad_max_iters", 0) or 0):
        if any(g is not None for gs in in_grads.values()
               for g in (gs or [])):
            raise ValueError(
                "while_loop is not reverse-differentiable with a dynamic "
                "trip count (XLA while has no transpose); pass "
                "grad_max_iters=N to while_loop for the bounded-scan "
                "lowering, or use static_loop")
        return []
    return default_grad_maker(op, out_grads, in_grads)


@register_op("static_loop", skip_infer_shape=True,
             required_attrs=("body_block", "carry_names", "body_out_names",
                             "ext_names", "i_name", "num_steps"))
def static_loop_op(ins, attrs):
    """``num_steps`` trips of the body on the carry X with the external
    reads Ext; the body reads the trip as the 0-d int32 ``i_name``."""
    carry_names = list(attrs["carry_names"])
    body_out = list(attrs["body_out_names"])
    ext = dict(zip(attrs["ext_names"], ins.get("Ext", [])))
    carry = list(ins["X"])
    n = int(attrs["num_steps"])
    device = carry[0].device if carry else creation_device()
    steps = torch.arange(n, dtype=torch.int32, device=device)
    for i in range(n):
        env = dict(ext)
        env.update(zip(carry_names, carry))
        env[attrs["i_name"]] = steps[i]
        _run(attrs["body_block"], env, attrs, body_out)
        carry = [env[nm] for nm in body_out]
    return {"Out": carry}


def _index(i):
    return i.reshape(1).long()


@register_op("array_read", non_diff_inputs=("I",))
def array_read(ins, attrs):
    """Slot I (a tensor, read on the device) of a [S, ...] stacked
    array."""
    x = ins["X"][0]
    return {"Out": x.index_select(0, _index(ins["I"][0]))[0]}


@register_op("array_write", non_diff_inputs=("I",))
def array_write(ins, attrs):
    """The stacked array X with slot I set to V (a new tensor)."""
    x, v = ins["X"][0], ins["V"][0]
    return {"Out": x.index_copy(0, _index(ins["I"][0]),
                                v.to(x.dtype).unsqueeze(0))}


@register_op("lod_rank_table", non_diff_inputs=("X",))
def lod_rank_table(ins, attrs):
    """X holds the [B] lengths: Items the lengths in descending order,
    Index the row of each (a stable sort: equal lengths keep their
    order); both int32."""
    ln = ins["X"][0].reshape(-1).int()
    items, order = torch.sort(ln, descending=True, stable=True)
    return {"Items": items, "Index": order.int()}


def _row_mask(mask, x):
    m = mask.reshape(-1).bool()
    return m.reshape((-1,) + (1,) * (x.dim() - 1))


@register_op("split_lod_tensor", non_diff_inputs=("Mask",))
def split_lod_tensor(ins, attrs):
    """The rows of X where Mask holds (OutTrue) and where it does not
    (OutFalse), each at X's full shape with the other rows zeroed (the
    reference compacts them; merge_lod_tensor undoes either)."""
    x = ins["X"][0]
    m = _row_mask(ins["Mask"][0], x)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return {"OutTrue": torch.where(m, x, zero),
            "OutFalse": torch.where(m, zero, x)}


@register_op("merge_lod_tensor", non_diff_inputs=("Mask",))
def merge_lod_tensor(ins, attrs):
    """Out[i] = InTrue[i] where Mask[i], else InFalse[i]."""
    t, f = ins["InTrue"][0], ins["InFalse"][0]
    return {"Out": torch.where(_row_mask(ins["Mask"][0], t), t,
                               f.to(t.dtype))}


@register_op("run_program", skip_infer_shape=True,
             required_attrs=("program",))
def run_program(ins, attrs):
    """A Program run as one op (the dygraph -> static bridge of
    ``@to_static``): X are its feeds (``feed_names``), Params its
    parameters (``param_names``), Out its ``fetch_names``; the
    ``program`` attr is a Program object, which does not serialise.
    Random ops draw the bits of step 0 unless a ``__step__`` is given, as
    the reference's jitted call does.

    On the CPU, on meta tensors and under an outer CUDA-graph capture
    (the reference's "already under an outer jit trace") the global
    block runs op by op in an env of those values under the caller's
    grad mode, so autograd differentiates it. On a CUDA device the block
    replays CUDA graphs cached for each key of its inputs' shapes, dtypes
    and grad flags (``core.graph.BlockGraphs``: a forward graph and,
    under autograd, a backward graph); a block holding an op that cannot
    be captured (not ``capturable``, or deciding on the host) runs op by
    op on the device instead, each run counted in
    ``executor.uncaptured_steps`` with the op named
    (``run_program_graphs(False)`` runs it so on request, uncounted). A
    bounded loop's truncation warns, as the reference's jitted call
    does."""
    prog = attrs["program"]
    feed_names = list(attrs.get("feed_names", ()))
    param_names = list(attrs.get("param_names", ()))
    fetch = list(attrs.get("fetch_names", ()))
    feeds, params = list(ins.get("X") or []), list(ins.get("Params") or [])
    device = next((t.device for t in feeds + params), None)
    if device is not None and device.type == "cuda" and _GRAPHS[-1] and \
            not torch.cuda.is_current_stream_capturing():
        from ..core import telemetry
        from ..core.graph import replay

        state = _program_state(prog)
        if state["uncapturable"] is None:
            train = torch.is_grad_enabled() and any(
                t.requires_grad for t in feeds + params)
            key = (tuple(feed_names), tuple(param_names), tuple(fetch),
                   train, device, tuple((tuple(t.shape), t.dtype,
                                         t.requires_grad)
                                        for t in feeds + params))
            graphs = state["graphs"].get(key)
            if graphs is None:
                from ..core.graph import BlockGraphs

                graphs = state["graphs"][key] = BlockGraphs(
                    prog.global_block(), feeds, params, fetch, feed_names,
                    param_names, device, train)
            return {"Out": replay(graphs, feeds, params)}
        telemetry.counter_add("executor.uncaptured_steps", 1,
                              op=state["uncapturable"])
    env = dict(zip(param_names, params))
    env.update(zip(feed_names, feeds))
    with creating_on(creation_device() if device is None else device):
        _run_op_by_op(prog.global_block(), env, attrs, fetch)
    return {"Out": [env[n] for n in fetch]}


# whether run_program replays CUDA graphs on a CUDA device (the default);
# off, its block runs op by op there too (``run_program_graphs``)
_GRAPHS = [True]


@contextlib.contextmanager
def run_program_graphs(enabled: bool):
    """Within the block, ``run_program`` on a CUDA device replays its
    graphs (True) or runs its block op by op, uncounted (False): the
    replay checks hold one against the other."""
    _GRAPHS.append(bool(enabled))
    try:
        yield
    finally:
        _GRAPHS.pop()


# per Program: the op a CUDA graph cannot replay (or None) and the
# BlockGraphs of each key; kept beside the Program, not in it, so that
# copying a program that holds a run_program op copies no graph
_PROGRAM_STATE = weakref.WeakKeyDictionary()


def _program_state(prog):
    state = _PROGRAM_STATE.get(prog)
    if state is None:
        state = _PROGRAM_STATE[prog] = {
            "uncapturable": _uncapturable(prog.global_block().ops),
            "graphs": {}}
    return state


def _uncapturable(ops):
    """The first op of ``ops`` (or of what they run) that a CUDA graph
    cannot replay: one deciding on the host (``executor.host_decider``)
    or one whose registry entry is not ``capturable``; None if none is."""
    from ..core import registry
    from ..core.executor import host_decider
    from ..core.rng import _run_attrs, sub_blocks

    found = host_decider(ops)
    if found:
        return found
    for op in ops:
        if not registry.get(op.type).capturable:
            return op.type
        inner = [blk.ops for blk in sub_blocks(op)]
        program = _run_attrs(op).get("program")
        if op.type == "run_program" and program is not None:
            inner.append(program.global_block().ops)
        for sub in inner:
            found = _uncapturable(sub)
            if found:
                return found
    return None


def _run_op_by_op(block, env, attrs, keep):
    """Run the block op by op (step 0 unless ``__step__`` is given); the
    truncation flags of its bounded loops are read after the run and
    warned on."""
    import warnings

    from ..core.executor import _GUARDS, run_sub_block

    step = attrs.get("__step__")
    guards = []
    _GUARDS.append(guards)
    try:
        run_sub_block(block, env, step=0 if step is None else step,
                      seeds=attrs.get("__seeds__"), keep=keep)
    finally:
        _GUARDS.pop()
    for flag, message in guards:
        if flag.device.type != "meta" and bool(flag):
            warnings.warn(message, stacklevel=3)


def _rank_table(ins):
    items = ins["RankTable"][0].reshape(-1).long()
    index = ins["RankTable"][1].reshape(-1).long() \
        if len(ins["RankTable"]) > 1 else None
    return items, index


@register_op("shrink_rnn_memory", non_diff_inputs=("RankTable", "I"))
def shrink_rnn_memory(ins, attrs):
    """The rank-ordered memory X with the rows of the sequences that ended
    before step I zeroed (the reference drops them from the batch)."""
    x = ins["X"][0]
    items, _ = _rank_table(ins)
    active = (items > ins["I"][0].reshape(()).long()).sum()
    keep = torch.arange(x.shape[0], device=x.device) < active
    return {"Out": torch.where(_row_mask(keep, x), x, torch.zeros_like(x))}


@register_op("lod_tensor_to_array", non_diff_inputs=("RankTable",))
def lod_tensor_to_array(ins, attrs):
    """X [B, S, ...] as a [S, B, ...] array in rank-table order: Out[t, j]
    = X[Index[j], t] where Items[j] > t, else 0."""
    x = ins["X"][0]
    items, index = _rank_table(ins)
    s = x.shape[1]
    steps = x.index_select(0, index).transpose(0, 1)
    alive = torch.arange(s, device=x.device)[:, None] < items[None, :]
    alive = alive.reshape(tuple(alive.shape) + (1,) * (x.dim() - 2))
    return {"Out": torch.where(alive, steps, torch.zeros_like(steps))}


@register_op("array_to_lod_tensor", non_diff_inputs=("RankTable",))
def array_to_lod_tensor(ins, attrs):
    """The inverse of lod_tensor_to_array: the [S, B, ...] rank-ordered
    steps back as [B, S, ...] in the rows' own order."""
    a = ins["X"][0]
    _, index = _rank_table(ins)
    b = a.shape[1]
    inv = torch.zeros(b, dtype=torch.long, device=a.device).index_copy(
        0, index, torch.arange(b, device=a.device))
    return {"Out": a.transpose(0, 1).index_select(0, inv)}
