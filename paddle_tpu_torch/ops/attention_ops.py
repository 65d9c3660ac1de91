"""Attention lowerings (port of ``paddle_tpu/ops/attention_ops.py``:
_attn_dropout :17, flash_attention :37, its grad maker :81,
flash_attention_grad :112, kv_cache_write :167, cached_kv_attention
:205, chunk_cached_attention :259, fused_bn_add_act :357,
fused_layer_norm :381).

The three pool-writing ops update the pool tensors IN PLACE and return
the same tensors as PoolKOut/PoolVOut — the counterpart of the jit
donation at ``paddle_tpu/serving/decode.py:552``, where XLA updates the
donated pool buffers in place. Index tensors arrive as int32 (the
reference's rule) and are widened to int64 for torch indexing.
"""

from __future__ import annotations

import torch

from ..core import rng
from ..core.ir import OpDesc
from ..core.registry import (default_grad_maker, register_grad_maker,
                             register_op)
from ..kernels.flash_attention import (flash_attention, flash_bwd, flash_fwd,
                                      general_bwd, general_fwd)
from ..kernels.layer_norm import fused_layer_norm
from ..kernels.paged_attention import paged_decode_attention
from .bn_act import fused_batch_norm_act


def _attn_dropout(attrs):
    """(rate, seed) of attention-probs dropout: seed is the uint32 that
    folds the op's build-time seed and the runtime step, so every step
    draws a fresh mask and the grad op recomputes the forward's."""
    rate = float(attrs.get("dropout_prob", 0.0) or 0.0)
    if rate <= 0.0 or bool(attrs.get("is_test", False)):
        return 0.0, 0
    return rate, rng.op_seed(attrs)


def _key_bias(bias, b, sk):
    """The [B,Sk] key-bias normal form of a flash_attention Bias, as the
    reference's ``_dispatch_plan`` derives it: a 4-D bias [B|1,1,1,Sk|1]
    broadcasts to [B,1,1,Sk], a 2-D one is a key bias. Any other bias
    gives None: the reference's ``reference_general`` route (plain
    attention with the full [B,H,Sq,Sk]-broadcast bias, not a kernel)."""
    if bias.dim() == 4 and bias.shape[1] == 1 and bias.shape[2] == 1:
        return torch.broadcast_to(bias, (b, 1, 1, sk)).reshape(b, sk)
    if bias.dim() == 2:
        return torch.broadcast_to(bias, (b, sk))
    return None


def _flash_args(ins, attrs):
    """(q, k, v, bias, general, heads, scale, causal, layout) of a
    flash_attention op or its grad op: packed [B,S,n*hd] q/k/v with a
    head_dim or num_heads attr, or [B,H,S,D] ("bnsd") q/k/v. bias is the
    key bias [B,Sk] (or None), or, with ``general``, the op's own Bias
    for the reference_general route."""
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    bias = ins["Bias"][0] if ins.get("Bias") else None
    if q.dim() == 4:
        layout, n, hd, sk = "bnsd", q.shape[1], q.shape[-1], k.shape[2]
    elif q.dim() == 3:
        layout, sk = "packed", k.shape[1]
        if attrs.get("head_dim"):
            n = q.shape[-1] // int(attrs["head_dim"])
        else:
            n = int(attrs["num_heads"])
        hd = q.shape[-1] // n
    else:
        raise ValueError(f"flash_attention takes 3-D (packed) or 4-D "
                         f"([B,H,S,D]) q, got {tuple(q.shape)}")
    general = False
    if bias is not None:
        kb = _key_bias(bias, q.shape[0], sk)
        general = kb is None
        bias = bias if general else kb
    scale = attrs.get("scale")
    scale = float(scale) if scale is not None else hd ** -0.5
    return (q.contiguous(), k.contiguous(), v.contiguous(), bias, general,
            n, scale, bool(attrs.get("causal", False)), layout)


@register_op("flash_attention", non_diff_inputs=("Bias",))
def flash_attention_op(ins, attrs):
    """Out = softmax(Q K^T * scale + Bias) V, with the log-sum-exp Lse
    [B,n,Sq] beside it for the saved-residual grad op.

    Q/K/V packed [B,S,n*hd] (head_dim or num_heads attr), or Q [B,H,Sq,D]
    and K/V [B,H,Sk,D]; Out comes in Q's layout. Bias, if given, is a key
    bias [B,1,1,Sk] or [B,Sk]. Attrs: causal, scale (default 1/sqrt(hd)),
    dropout_prob/is_test/seed (attention-probs dropout). Runs the flash
    forward kernel (kernels/flash_attention.py) in either layout. Under
    autograd (the op inside a ``block_call`` segment that its
    ``__vjp_grad__`` recomputes) it runs through
    ``FlashAttentionFunction``, whose backward is the backward kernel;
    otherwise its gradient is the ``flash_attention_grad`` op. Any
    other bias ([B,H,Sq,Sk], [B,1,Sq,Sk]) takes the reference's
    ``reference_general`` route (``general_fwd``: plain attention, no
    kernel, its Lse the true log-sum-exp where the reference gives
    zeros)."""
    q, k, v, bias, general, n, scale, causal, layout = _flash_args(ins,
                                                                   attrs)
    rate, seed = _attn_dropout(attrs)
    if general:
        out, lse = general_fwd(q, k, v, n, scale, causal, bias, rate, seed,
                               layout)
        return {"Out": out, "Lse": lse}
    fwd = flash_attention if torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v)) else flash_fwd
    out, lse = fwd(q, k, v, n, scale, causal, bias, rate, seed, layout)
    return {"Out": out, "Lse": lse}


@register_grad_maker("flash_attention")
def _flash_attention_grad_maker(op, out_grads, in_grads):
    """Emit flash_attention_grad consuming the SAVED forward Out/Lse
    instead of the generic __vjp_grad__, which would run the forward
    kernel again. Descs without the Lse output take the generic maker."""
    og = (out_grads.get("Out") or [None])[0]
    if og is None or not op.outputs.get("Lse"):
        return default_grad_maker(op, out_grads, in_grads)
    grads = {s: (in_grads.get(s) or [None])[0]
             for s in ("Q", "K", "V", "Bias")}
    if all(g is None for g in grads.values()):
        return []
    inputs = {"Q": list(op.inputs["Q"]), "K": list(op.inputs["K"]),
              "V": list(op.inputs["V"]), "Out": list(op.outputs["Out"]),
              "Lse": list(op.outputs["Lse"]), "OutGrad": [og]}
    if op.inputs.get("Bias"):
        inputs["Bias"] = list(op.inputs["Bias"])
    outputs = {s + "Grad": [g] for s, g in grads.items() if g is not None}
    attrs = dict(op.attrs)
    # drop the forward's role tags so that append_backward tags this op
    # Backward
    attrs.pop("op_role", None)
    attrs.pop("op_role_var", None)
    return [OpDesc("flash_attention_grad", inputs, outputs, attrs)]


@register_op("flash_attention_grad",
             non_diff_inputs=("Bias", "Out", "Lse", "OutGrad"),
             skip_infer_shape=True)
def flash_attention_grad_op(ins, attrs):
    """d(Q,K,V,Bias) of flash_attention from the saved (Out, Lse),
    through the flash backward kernel: the forward never runs again. A
    bias that is not a key bias takes the forward's reference_general
    route (``general_bwd``: the forward recomputed under autograd, as the
    reference's vjp does there). BiasGrad comes in the Bias's shape."""
    q, k, v, bias, general, n, scale, causal, layout = _flash_args(ins,
                                                                   attrs)
    out, lse, do = ins["Out"][0], ins["Lse"][0], ins["OutGrad"][0]
    rate, seed = _attn_dropout(attrs)
    if general:
        dq, dk, dv, dbias = general_bwd(q, k, v, do, n, scale, causal, bias,
                                        rate, seed, layout)
        return {"QGrad": dq, "KGrad": dk, "VGrad": dv, "BiasGrad": dbias}
    dq, dk, dv, dbias = flash_bwd(
        q, k, v, out.contiguous(), lse.contiguous(),
        do.to(out.dtype).reshape(out.shape).contiguous(), n, scale, causal,
        bias, rate, seed, layout)
    outs = {"QGrad": dq, "KGrad": dk, "VGrad": dv}
    if dbias is not None:
        outs["BiasGrad"] = _sum_to(dbias, ins["Bias"][0])
    return outs


def _sum_to(dbias, bias):
    """The [B,Sk] key-bias gradient in ``bias``'s own shape, summed over
    the dims the bias was broadcast along (what the reference's CPU route,
    a vjp of plain attention, returns)."""
    b, sk = dbias.shape
    full = dbias.reshape((b, 1, 1, sk) if bias.dim() == 4 else (b, sk))
    dims = [d for d, (f, s) in enumerate(zip(full.shape, bias.shape))
            if s == 1 and f != 1]
    return full.sum(dims, keepdim=True) if dims else full


@register_op("kv_cache_write")
def kv_cache_write_op(ins, attrs):
    """Bulk-write a prompt's keys/values into the paged KV pool, in
    place. K, V [B,S,kvdim]; PoolK, PoolV [N,P,kvdim]; PageTable [B,MP];
    Lengths [B]. Token s of row b lands at page PageTable[b, s // P],
    offset s % P; positions at or past the row's length go to page 0,
    the pool's reserved scratch page."""
    k, v = ins["K"][0], ins["V"][0]
    pool_k, pool_v = ins["PoolK"][0], ins["PoolV"][0]
    table = ins["PageTable"][0].long()
    lengths = ins["Lengths"][0].reshape(-1).long()
    b, s, kvdim = k.shape
    page = int(pool_k.shape[1])
    pos = torch.arange(s, device=k.device)
    phys = table[:, pos // page]                                # [B, S]
    phys = torch.where(pos[None, :] < lengths[:, None], phys,
                       torch.zeros_like(phys))
    _write_slots(pool_k, pool_v, (phys * page + pos % page).reshape(-1),
                 k.reshape(b * s, kvdim), v.reshape(b * s, kvdim))
    return {"PoolKOut": pool_k, "PoolVOut": pool_v}


def _write_slots(pool_k, pool_v, slots, k, v):
    """pool[slot // P, slot % P] = row, in place, for each flat slot id
    (one index_copy_ per pool)."""
    kvdim = pool_k.shape[-1]
    pool_k.view(-1, kvdim).index_copy_(0, slots, k)
    pool_v.view(-1, kvdim).index_copy_(0, slots, v)


@register_op("cached_kv_attention")
def cached_kv_attention_op(ins, attrs):
    """One decode step of attention against the paged KV cache: write
    the step's K/V at (PageTable[b, pos//P], pos%P) in place, then
    attend each row's query over its positions 0..pos through the paged
    attention kernel (kernels/paged_attention.py). Positions past pos
    get no weight, so recycled pages contribute nothing and per-row
    results depend on the row alone. Empty slots carry an all-zero page
    table and write to scratch page 0."""
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    pool_k, pool_v = ins["PoolK"][0], ins["PoolV"][0]
    table = ins["PageTable"][0]
    pos = ins["Positions"][0].reshape(-1)
    n, hd = int(attrs["num_heads"]), int(attrs["head_dim"])
    scale = float(attrs.get("scale") or hd ** -0.5)
    page = int(pool_k.shape[1])
    pos64 = pos.long()
    phys = table.gather(1, (pos64 // page)[:, None])[:, 0].long()
    _write_slots(pool_k, pool_v, phys * page + pos64 % page, k, v)
    out = paged_decode_attention(q, pool_k, pool_v, table, pos, n, hd, scale)
    return {"Out": out, "PoolKOut": pool_k, "PoolVOut": pool_v}


@register_op("chunk_cached_attention",
             required_attrs=("num_heads", "head_dim"),
             non_diff_inputs=("K", "V", "PoolK", "PoolV", "PageTable",
                              "ChunkStart", "Lengths"))
def chunk_cached_attention_op(ins, attrs):
    """One page-aligned PROMPT CHUNK of prefill against the paged KV pool,
    the building block of the prefix-sharing chunked prefill
    (serving/prefix_store.py). It writes the chunk's K/V into the row's
    pages, in place, and attends each chunk query over (a) the pool
    positions 0..ChunkStart-1, the already-prefilled (possibly shared)
    prefix, and (b) the chunk's own keys causally. A chunk's output
    depends only on the chunk's tokens and the prior positions' pool
    bytes (invalid positions are masked to -1e9 before the softmax and
    get exactly 0 weight), so replaying only the uncached suffix chunks
    over cached prefix pages reproduces the cold prefill bit for bit.

    Q, K, V [B, C, kvdim]; PoolK/PoolV [N, P, kvdim]; PageTable [B, MP];
    ChunkStart [B] (page-aligned global position of chunk token 0);
    Lengths [B] (valid tokens in this chunk, 1..C). Positions past a
    row's length write to scratch page 0. The context is gathered from
    the pools BEFORE the chunk's writes, as the reference's pre-write
    pools give it. Plain PyTorch, as the reference's lowering is plain
    jnp: one softmax in fp32 over the concatenated [ctx | chunk] scores.
    No host read and no data-dependent shape, so it can be captured.
    Outputs: Out [B, C, kvdim], PoolKOut, PoolVOut (the pools)."""
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    pool_k, pool_v = ins["PoolK"][0], ins["PoolV"][0]
    table = ins["PageTable"][0].long()
    start = ins["ChunkStart"][0].reshape(-1).long()
    lengths = ins["Lengths"][0].reshape(-1).long()
    b, c, kvdim = k.shape
    n, hd = int(attrs["num_heads"]), int(attrs["head_dim"])
    scale = float(attrs.get("scale") or hd ** -0.5)
    page = int(pool_k.shape[1])
    mp = int(table.shape[1])
    s_ctx = mp * page
    # the prior context, read from the pre-write pools (a gathered copy)
    ctx_k = pool_k[table].reshape(b, s_ctx, n, hd)
    ctx_v = pool_v[table].reshape(b, s_ctx, n, hd)
    # -- write phase: kv_cache_write with a start offset ---------------------
    pos = torch.arange(c, device=k.device)
    g = start[:, None] + pos[None, :]                           # [B, C]
    phys = table.gather(1, (g // page).clamp_max(mp - 1))
    phys = torch.where(pos[None, :] < lengths[:, None], phys,
                       torch.zeros_like(phys))
    _write_slots(pool_k, pool_v, (phys * page + g % page).reshape(-1),
                 k.reshape(b * c, kvdim), v.reshape(b * c, kvdim))
    # -- attend phase: prior pool context + causal in-chunk ------------------
    qh = q.reshape(b, c, n, hd)
    sc_ctx = torch.einsum("bqnh,bsnh->bnqs", qh, ctx_k) * scale
    seen = torch.arange(s_ctx, device=k.device)[None, None, None, :] < \
        start[:, None, None, None]
    sc_ctx = torch.where(seen, sc_ctx, -1e9)
    kh, vh = k.reshape(b, c, n, hd), v.reshape(b, c, n, hd)
    sc_chk = torch.einsum("bqnh,bsnh->bnqs", qh, kh) * scale
    causal = pos[None, :] <= pos[:, None]                       # [Cq, Ck]
    sc_chk = torch.where(causal[None, None], sc_chk, -1e9)
    probs = torch.softmax(torch.cat([sc_ctx, sc_chk], -1), dim=-1)
    out = torch.einsum("bnqs,bsnh->bqnh", probs[..., :s_ctx], ctx_v) + \
        torch.einsum("bnqs,bsnh->bqnh", probs[..., s_ctx:], vh)
    return {"Out": out.reshape(b, c, n * hd), "PoolKOut": pool_k,
            "PoolVOut": pool_v}


@register_op("fused_bn_add_act", non_diff_inputs=("Mean", "Variance"))
def fused_bn_add_act_op(ins, attrs):
    """Training-time BatchNorm(+residual Z)+ReLU as one op (reference
    :357) with the pinned-residual backward of ``ops/bn_act.py``; the
    batch_norm contract plus the optional Z added before the
    activation."""
    x = ins["X"][0]
    z = ins["Z"][0] if ins.get("Z") else None
    y, mo, vo, sm, sv = fused_batch_norm_act(
        x, ins["Scale"][0], ins["Bias"][0], ins["Mean"][0],
        ins["Variance"][0], z, eps=float(attrs.get("epsilon", 1e-5)),
        momentum=float(attrs.get("momentum", 0.9)),
        c_axis=1 if attrs.get("data_layout", "NCHW") == "NCHW" else -1,
        act=attrs.get("act", "relu"),
        is_test=bool(attrs.get("is_test", False)))
    return {"Y": y, "MeanOut": mo, "VarianceOut": vo, "SavedMean": sm,
            "SavedVariance": sv}


@register_op("fused_layer_norm")
def fused_layer_norm_op(ins, attrs):
    """Layer norm over the last axis through the layer_norm kernel
    (reference :381); ``layer_norm`` stays the general begin_norm_axis
    op. As there, Variance is the variance, 1 / rstd^2 - eps."""
    scale = ins["Scale"][0] if ins.get("Scale") else None
    bias = ins["Bias"][0] if ins.get("Bias") else None
    eps = attrs.get("epsilon", 1e-5)
    y, mean, rstd = fused_layer_norm(ins["X"][0], scale, bias, eps=eps)
    return {"Y": y, "Mean": mean, "Variance": 1.0 / (rstd * rstd) - eps}
