"""Control-flow ops that hold a sub-block (port of
``paddle_tpu/ops/control_flow_ops.py``): ``block_call`` (:30-53), the
segment op of the recompute rewrite
(``distributed/fleet/meta_optimizers.py`` ``RecomputeOptimizer``).

``block_call`` runs its sub-block as a function of its inputs, in a local
env of its own. Its gradient is the generic ``__vjp_grad__``, whose
lowering runs the call again under autograd and differentiates it: the
sub-block's activations live only inside that recompute, and between the
forward and the backward only the call's inputs and outputs stay alive,
which is what the reference's ``jax.checkpoint`` (``remat``) gives. So
the port recomputes every ``block_call`` segment, with ``remat`` or
without. A random op of the sub-block draws in the recompute the bits of
its forward: op by op both fold the same step into its seed, and a
compiled step binds both to the op's one slot of the seed table
(``core/rng.seed_slots``). ``conditional_block`` and ``while`` are not in
the port."""

from __future__ import annotations

from ..core.registry import register_op


@register_op("block_call", skip_infer_shape=True,
             required_attrs=("sub_block", "input_names", "output_names"))
def block_call(ins, attrs):
    """Out (the values of ``output_names``) of the sub-block run on X (the
    values of ``input_names``)."""
    from ..core.executor import run_sub_block

    out_names = list(attrs["output_names"])
    env = dict(zip(attrs["input_names"], ins["X"]))
    run_sub_block(attrs["sub_block"], env, step=attrs.get("__step__"),
                  seeds=attrs.get("__seeds__"), keep=out_names)
    return {"Out": [env[n] for n in out_names]}
