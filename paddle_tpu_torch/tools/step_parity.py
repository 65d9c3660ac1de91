"""The compiled step against the op-by-op step, step by step, on the card.

    python -m paddle_tpu_torch.tools.step_parity [--seq 512|2048|4096]
                                                 [--layers N] [--steps 24]

Builds ERNIE-large at one of ``profile_train``'s cells (hidden 1024, 16
heads, FFN 4096, vocab 18000, bf16, flash attention with dropout, AdamW;
seq 2048 batch 4 by default; ``--layers`` deep, 24 by default), runs its
startup on cuda:0, and runs ``--steps`` steps three times, op by op twice and
compiled once (its second step the capture, the later ones replays),
each run starting every step from the first op-by-op run's state, copied
into its own tensors (which the graph reads), so that a difference shows
at the step that makes it (``compiled_parity``). It prints one JSON line:
the three runs' losses, whether the losses and every dropout mask of the
compiled run equal the first op-by-op run's bit for bit and whether the
masks are new each step, how many state tensors end equal bit for bit and
whether every one does in both other runs, the tensors in which a run
differs from the first, with the forward ops that read them and both
runs' largest differences, and whether the launch counts a step
agree. Then the card's name and power limit. Needs one CUDA card; exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch


def _nondeterministic_sources(main_prog, names):
    """The forward op types that read each named tensor: where two runs
    differ, the op whose gradient sums in a run-dependent order (atomics)
    is among them."""
    ops = main_prog.global_block().ops
    return {n: sorted({o.type for o in ops if n in o.input_names()
                       and not o.type.endswith("_grad")
                       and o.type not in ("__vjp_grad__", "adamw", "adam")})
            for n in names}


def compiled_parity(dev, layers, seq, steps, batch_size=None, seed=5,
                    model="ernie_large", warmup_steps=4000, flash=True):
    """The record described in the module docstring, for ERNIE-large at
    ``seq`` (batch ``batch_size``, the cell's by default), ``layers``
    deep, or for Transformer-big (``model="transformer_big"``: ``layers``
    encoder and decoder layers each, noam over ``warmup_steps``; its
    sequence is always s256, so ``seq`` is not read; ``flash=False``
    takes its unfused attention branch), over ``steps`` steps on one
    synthetic batch made from ``seed``.
    ``losses_and_masks_bitwise_equal``, ``masks_new_each_step``,
    ``state_bitwise_equal_in_all_runs`` and ``launch_counts_equal`` are
    booleans; ``max_state_diff`` and ``max_eager_spread`` give, for each
    tensor in which the compiled or the second op-by-op run differs from
    the first, the compiled and the second op-by-op run's largest
    difference from the first; ``last`` holds the last compiled step's
    launch counts."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.tools.profile_train import (_ernie, _loss,
                                                      _transformer_big)

    if model == "transformer_big":
        main_prog, startup, make_batch, fetch, info, _ = _transformer_big(
            layers, warmup_steps, flash)
    else:
        main_prog, startup, make_batch, fetch, info, _ = _ernie(seq, layers)
    batch_size = batch_size or info["batch"]
    ops = main_prog.global_block().ops
    base = Scope()
    Executor(device=dev).run(startup, scope=base)
    batch = make_batch(batch_size, seed)
    masks = [o.outputs["Mask"][0] for o in ops if o.type == "dropout"]
    fetch = [fetch[0].name] + masks
    names = [n for n, v in base.items() if isinstance(v, torch.Tensor)]
    runs = []
    for comp in (False, False, True):
        sc = Scope()
        for n, v in base.items():
            sc.set(n, v.clone() if isinstance(v, torch.Tensor) else v)
        runs.append((Executor(device=dev), sc, comp))
    del base
    losses, outs_equal, fresh, prev = [[], [], []], True, True, None
    spread, diff = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0.0)
    counts = []
    for _ in range(steps):
        start = {n: runs[0][1].find_var(n).clone() for n in names}
        outs = []
        for i, (exe, sc, comp) in enumerate(runs):
            for n in names:
                sc.find_var(n).copy_(start[n])
            kernels.reset_launch_counts()
            outs.append(exe.run(main_prog, feed=batch, scope=sc,
                                fetch_list=fetch, use_compiled=comp))
            torch.cuda.synchronize()
            if i in (0, 2):
                counts.append(kernels.snapshot_counts())
            losses[i].append(_loss(outs[-1]))
        outs_equal &= all(np.array_equal(x, y)
                          for x, y in zip(outs[0], outs[2]))
        if prev is not None:
            fresh &= not np.array_equal(prev, outs[2][1])
        prev = outs[2][1]
        for n in names:
            a, b, c = (r[1].find_var(n).float() for r in runs)
            spread[n] = max(spread[n], float((b - a).abs().max()))
            diff[n] = max(diff[n], float((c - a).abs().max()))
        del start, outs
    differ = sorted(n for n in names if spread[n] or diff[n])
    # the counters now hold the last compiled step's launches
    last = dict(launches=kernels.launch_counts(),
                layouts=kernels.layout_counts(),
                dtypes=kernels.dtype_counts())
    for exe, _, _ in runs:
        exe.close()
    return dict(
        info, batch=batch_size, steps=steps,
        losses={"eager": losses[0], "eager_again": losses[1],
                "compiled": losses[2]},
        dropout_masks=len(masks), losses_and_masks_bitwise_equal=outs_equal,
        masks_new_each_step=fresh, state_tensors=len(names),
        state_bitwise_equal=sum(1 for n in names if diff[n] == 0),
        state_bitwise_equal_in_all_runs=not differ,
        runs_differ_in=differ,
        ops_reading_them=_nondeterministic_sources(main_prog, differ),
        max_state_diff={n: diff[n] for n in differ},
        max_eager_spread={n: spread[n] for n in differ},
        launches_per_step={k: v for k, v in last["launches"].items() if v},
        launch_counts_equal=all(c == counts[0] for c in counts),
        last=last)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seq", type=int, choices=(512, 2048, 4096),
                        default=2048)
    parser.add_argument("--layers", type=int, default=24)
    parser.add_argument("--steps", type=int, default=24)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_parity: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    record = compiled_parity(torch.device("cuda:0"), args.layers, args.seq,
                             args.steps)
    del record["last"]
    print(json.dumps(record), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
