"""Layer-wise model summary (port of ``paddle_tpu/hapi/model_summary.py``):
summary(net, input_size) runs one forward pass with forward hooks on
every sub-layer, prints each one's output shape and parameter count and
returns {'total_params', 'trainable_params'}."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

__all__ = ["summary"]


def _as_size_list(input_size):
    if isinstance(input_size, (list, tuple)) and input_size and \
            isinstance(input_size[0], (list, tuple)):
        return [tuple(s) for s in input_size]
    return [tuple(input_size)]


def _shape_of(out):
    if isinstance(out, (list, tuple)):
        return [_shape_of(o) for o in out]
    shp = getattr(out, "shape", None)
    return list(shp) if shp is not None else None


def summary(net, input_size, dtypes=None):
    """Print a per-layer table for a dygraph Layer by running one
    forward pass on zero inputs of `input_size` (one shape tuple, or a
    list of them for multi-input nets; a leading -1/None batch dim
    becomes 1). Returns {'total_params': int, 'trainable_params': int}.
    """
    from .. import dygraph
    from ..dygraph.layers import Layer

    sizes = _as_size_list(input_size)
    if dtypes is None:
        dtypes = ["float32"] * len(sizes)
    elif isinstance(dtypes, str):
        dtypes = [dtypes] * len(sizes)
    if len(dtypes) != len(sizes):
        raise ValueError(
            f"dtypes length ({len(dtypes)}) must match the number of "
            f"input shapes ({len(sizes)})")

    rows: List[dict] = []
    handles = []

    def make_hook(name, layer):
        def hook(lyr, ins, out):
            n_params = sum(
                int(np.prod(p.shape)) if p.shape else 1
                for p in layer.parameters(include_sublayers=False))
            rows.append({
                "name": f"{type(layer).__name__}-{name}" if name
                        else type(layer).__name__,
                "output_shape": _shape_of(out),
                "params": n_params,
            })

        return hook

    for name, layer in net.named_sublayers(include_self=False):
        handles.append(layer.register_forward_post_hook(
            make_hook(name, layer)))

    was_dygraph = dygraph.enabled()
    params = net.parameters()
    device = params[0]._tensor.device if params else None
    # summary must not flip a net being trained into eval as a side
    # effect — remember each sublayer's mode and restore it
    modes = [(lyr, lyr.training)
             for lyr in net.sublayers(include_self=True)]
    try:
        if not was_dygraph:
            dygraph.enable_dygraph(device)
        from ..tensor import to_tensor

        feeds = []
        for shp, dt in zip(sizes, dtypes):
            shp = tuple(1 if (d is None or int(d) < 0) else int(d)
                        for d in shp)
            feeds.append(to_tensor(np.zeros(shp, dtype=dt)))
        with dygraph.no_grad():
            net.eval()
            net(*feeds)
    finally:
        for h in handles:
            h.remove()
        for lyr, training in modes:
            lyr.training = training
        if not was_dygraph:
            dygraph.disable_dygraph()

    # parameters owned by layers whose forward never fired (e.g. shared
    # tables used functionally) still count toward the totals
    total = trainable = 0
    for p in net.parameters():
        n = int(np.prod(p.shape)) if p.shape else 1
        total += n
        if not getattr(p, "stop_gradient", False):
            trainable += n

    width = max([len(r["name"]) for r in rows] + [12])
    print(f"{'Layer (type)':<{width + 2}}{'Output Shape':<26}{'Param #':>12}")
    print("=" * (width + 40))
    for r in rows:
        print(f"{r['name']:<{width + 2}}"
              f"{str(r['output_shape']):<26}{r['params']:>12,}")
    print("=" * (width + 40))
    print(f"Total params: {total:,}")
    print(f"Trainable params: {trainable:,}")
    print(f"Non-trainable params: {total - trainable:,}")
    return {"total_params": total, "trainable_params": trainable}
