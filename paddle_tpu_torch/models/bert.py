"""BERT / ERNIE transformer encoder + pre-training program.

The port of ``paddle_tpu/models/bert.py``: the encoder is built as
program IR through the layers API, op for op as the reference builds it
(the two programs serialise to the same JSON), with the packed
flash-attention op (``use_flash_attention``) or the unfused attention
chain (the default, which the inference passes fuse).
The sharding annotations on the weights are recorded (they are part of
the program) but nothing in the port reads them: it runs on one device.
Not in the port, and raising: ring attention / sequence parallelism,
pipeline stages and data parallelism above 1.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import layers
from ..core.ir import Program, program_guard
from ..core.scope import scope_from_numpy  # noqa: F401  (its old home)
from ..initializer import TruncatedNormal
from ..param_attr import ParamAttr
from ..parallel.api import set_logical_axes, shard_tensor


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    hidden_act: str = "gelu"
    dtype: str = "float32"
    # emit the fused flash-attention op instead of the
    # matmul/softmax/dropout/matmul chain (ops/attention_ops.py);
    # attention-probs dropout runs inside the kernel
    use_flash_attention: bool = False
    # ring attention (sequence parallelism) is not in the port
    use_ring_attention: bool = False


def bert_base() -> BertConfig:
    return BertConfig()


def bert_large() -> BertConfig:
    return BertConfig(hidden_size=1024, num_hidden_layers=24,
                      num_attention_heads=16, intermediate_size=4096)


def ernie_large() -> BertConfig:
    """ERNIE 2.0 large: BERT-large geometry with ERNIE's own 18k
    WordPiece vocab."""
    return BertConfig(vocab_size=18000, hidden_size=1024, num_hidden_layers=24,
                      num_attention_heads=16, intermediate_size=4096)


def _param(name, cfg):
    return ParamAttr(name=name, initializer=TruncatedNormal(
        0.0, cfg.initializer_range))


def _dense(x, d_out, name, cfg, act=None, tp_spec=None):
    """3-D dense: [B,S,H] @ [H,d_out] + b, with optional TP sharding spec on
    the weight (e.g. (None,'mp') column-parallel, ('mp',None) row-parallel)."""
    w = layers.create_parameter([int(x.shape[-1]), d_out], cfg.dtype,
                                attr=_param(name + "_w", cfg))
    if tp_spec is not None:
        shard_tensor(w, tp_spec)
    else:
        set_logical_axes(w, ("embed", "mlp"))
    b = layers.create_parameter([d_out], cfg.dtype,
                                attr=ParamAttr(name=name + "_b"), is_bias=True)
    if tp_spec is not None and tp_spec[-1] is not None:
        shard_tensor(b, (tp_spec[-1],))
    elif tp_spec is None:
        set_logical_axes(b, ("mlp",))
    out = layers.linear(x, w, b)
    if act == "gelu":
        out = layers.gelu(out, approximate=True)
    elif act:
        out = getattr(layers, act)(out)
    return out


def _attention(x, attn_bias, cfg: BertConfig, name: str, is_test=False):
    """Multi-head self-attention: three separate projections, then either
    the packed flash-attention op (``use_flash_attention``) or the
    reference's unfused chain on [B,n,S,hd] heads (matmul q k^T * alpha,
    + bias, softmax, dropout, matmul v), which the inference passes
    rewrite into one bnsd flash_attention op. QKV carry the
    column-parallel annotation, the output projection the row-parallel
    one."""
    h = cfg.hidden_size
    n = cfg.num_attention_heads
    hd = h // n
    if cfg.use_ring_attention:
        raise NotImplementedError(
            "ring attention (sequence parallelism) is not in the port")
    if cfg.use_flash_attention:
        # PACKED path: the projections' [B,S,H] outputs feed the fused
        # kernels directly and ctx comes back [B,S,H], with no reshape or
        # transpose op in the layer
        q3 = _dense(x, h, f"{name}_q", cfg, tp_spec=(None, "mp"))
        k3 = _dense(x, h, f"{name}_k", cfg, tp_spec=(None, "mp"))
        v3 = _dense(x, h, f"{name}_v", cfg, tp_spec=(None, "mp"))
        ctx = layers.flash_attention(
            q3, k3, v3, bias=attn_bias, scale=1.0 / np.sqrt(hd),
            num_heads=n, dropout_rate=cfg.attention_probs_dropout_prob,
            is_test=is_test)
        return _dense(ctx, h, f"{name}_out", cfg, tp_spec=("mp", None))

    def proj(suffix):
        t = _dense(x, h, f"{name}_{suffix}", cfg, tp_spec=(None, "mp"))
        t = layers.reshape(t, [0, 0, n, hd])
        return layers.transpose(t, [0, 2, 1, 3])      # [B,n,S,hd]

    q, k, v = proj("q"), proj("k"), proj("v")
    scores = layers.matmul(q, k, transpose_y=True, alpha=1.0 / np.sqrt(hd))
    if attn_bias is not None:
        scores = scores + attn_bias
    probs = layers.softmax(scores)
    probs = layers.dropout(probs, cfg.attention_probs_dropout_prob,
                           is_test=is_test,
                           dropout_implementation="upscale_in_train")
    ctx = layers.matmul(probs, v)                 # [B,n,S,hd]
    ctx = layers.transpose(ctx, [0, 2, 1, 3])
    ctx = layers.reshape(ctx, [0, 0, h])
    return _dense(ctx, h, f"{name}_out", cfg, tp_spec=("mp", None))


def _encoder_layer(x, attn_bias, cfg: BertConfig, name: str, is_test=False):
    attn = _attention(x, attn_bias, cfg, f"{name}_attn", is_test)
    attn = layers.dropout(attn, cfg.hidden_dropout_prob, is_test=is_test,
                          dropout_implementation="upscale_in_train")
    x = layers.layer_norm(x + attn, begin_norm_axis=2,
                          param_attr=ParamAttr(name=f"{name}_ln1_scale"),
                          bias_attr=ParamAttr(name=f"{name}_ln1_bias"))
    ffn = _dense(x, cfg.intermediate_size, f"{name}_ffn1", cfg,
                 act=cfg.hidden_act, tp_spec=(None, "mp"))
    ffn = _dense(ffn, cfg.hidden_size, f"{name}_ffn2", cfg,
                 tp_spec=("mp", None))
    ffn = layers.dropout(ffn, cfg.hidden_dropout_prob, is_test=is_test,
                         dropout_implementation="upscale_in_train")
    return layers.layer_norm(x + ffn, begin_norm_axis=2,
                             param_attr=ParamAttr(name=f"{name}_ln2_scale"),
                             bias_attr=ParamAttr(name=f"{name}_ln2_bias"))


def _attn_bias_from_mask(input_mask):
    """Additive attention bias [B,1,1,S] from the [B,S] 0/1 mask:
    (mask-1)*1e4 -> 0 on real tokens, -1e4 on padding."""
    bias2d = layers.scale(input_mask, scale=10000.0, bias=-1.0,
                          bias_after_scale=False)
    bias2d.stop_gradient = True
    attn_bias = layers.unsqueeze(bias2d, [1, 2])
    attn_bias.stop_gradient = True
    return attn_bias


def bert_encoder(src_ids, sent_ids, pos_ids, input_mask, cfg: BertConfig,
                 is_test=False, pipeline_stages: int = 0):
    """Token+segment+position embeddings -> N transformer layers.
    Returns sequence output [B,S,H]. pipeline_stages > 1 (the
    device_guard-tagged pipeline variant) is not in the port."""
    if int(pipeline_stages or 0) > 1:
        raise NotImplementedError(
            "pipeline parallelism is not in the port (one device)")
    emb = layers.embedding(src_ids, [cfg.vocab_size, cfg.hidden_size],
                           param_attr=_param("word_embedding", cfg),
                           dtype=cfg.dtype)
    semb = layers.embedding(sent_ids,
                            [cfg.type_vocab_size, cfg.hidden_size],
                            param_attr=_param("sent_embedding", cfg),
                            dtype=cfg.dtype)
    pemb = layers.embedding(pos_ids, [cfg.max_position_embeddings,
                                      cfg.hidden_size],
                            param_attr=_param("pos_embedding", cfg),
                            dtype=cfg.dtype)
    x = emb + semb + pemb
    x = layers.layer_norm(x, begin_norm_axis=2,
                          param_attr=ParamAttr(name="emb_ln_scale"),
                          bias_attr=ParamAttr(name="emb_ln_bias"))
    x = layers.dropout(x, cfg.hidden_dropout_prob, is_test=is_test,
                       dropout_implementation="upscale_in_train")
    attn_bias = _attn_bias_from_mask(input_mask)
    for i in range(cfg.num_hidden_layers):
        x = _encoder_layer(x, attn_bias, cfg, f"layer_{i}", is_test)
    return x


def build_pretraining_program(cfg: BertConfig, seq_len: int = 128,
                              batch_size: int = -1, optimizer_name="adamw",
                              lr: float = 1e-4, is_test=False,
                              with_optimizer=True, with_nsp=True,
                              sequence_parallel: int = 0,
                              data_parallel: int = 1,
                              pipeline_stages: int = 0,
                              max_predictions_per_seq: int = 0):
    """MLM + NSP pre-training step (the BERT/ERNIE recipe).

    Feeds: src_ids, sent_ids, pos_ids, input_mask [B,S];
           mask_labels [B,S] int64, mask_weight [B,S] float, 1.0 at
           masked positions; nsp_labels [B,1].
    seq_len must fit the position table: an out-of-range position gather
    would train on garbage rows.
    Fetches: loss (total), lm_loss, nsp_loss (0 when with_nsp=False).

    With max_predictions_per_seq = k only the top-k masked positions of
    each example are gathered BEFORE the vocab projection (the standard
    BERT recipe), which cuts the [B,S,V] logits to [B,k,V].

    The sequence-, pipeline- and data-parallel variants of the reference
    are not in the port and raise."""
    if seq_len > cfg.max_position_embeddings:
        raise ValueError(
            f"seq_len {seq_len} exceeds max_position_embeddings "
            f"{cfg.max_position_embeddings} — raise the config's table "
            f"size for long-context runs")
    if int(sequence_parallel or 0) > 1 or int(pipeline_stages or 0) > 1 \
            or int(data_parallel or 1) > 1:
        raise NotImplementedError(
            "sequence_parallel, pipeline_stages and data_parallel above 1 "
            "are not in the port (one device)")
    main, startup = Program(), Program()
    with program_guard(main, startup):
        B, S = batch_size, seq_len
        src_ids = layers.static_data("src_ids", [B, S], "int64")
        sent_ids = layers.static_data("sent_ids", [B, S], "int64")
        pos_ids = layers.static_data("pos_ids", [B, S], "int64")
        input_mask = layers.static_data("input_mask", [B, S], "float32")
        mask_labels = layers.static_data("mask_labels", [B, S], "int64")
        mask_weight = layers.static_data("mask_weight", [B, S], "float32")
        nsp_labels = layers.static_data("nsp_labels", [B, 1], "int64")

        seq_out = bert_encoder(src_ids, sent_ids, pos_ids, input_mask, cfg,
                               is_test=is_test)

        # MLM head: transform + tied decoder over the word embedding
        k = int(max_predictions_per_seq or 0)
        if k > 0:
            w_sel, pos = layers.topk(mask_weight, k)         # [B,k]
            lab_sel = layers.take_along_axis(mask_labels, pos, axis=1)
            pos3 = layers.unsqueeze(pos, [2])                # [B,k,1]
            mlm_in = layers.take_along_axis(seq_out, pos3, axis=1)
            mlm_labels, mlm_weight = lab_sel, w_sel
        else:
            mlm_in, mlm_labels, mlm_weight = seq_out, mask_labels, mask_weight
        trans = _dense(mlm_in, cfg.hidden_size, "mlm_trans", cfg,
                       act=cfg.hidden_act)
        trans = layers.layer_norm(trans, begin_norm_axis=2,
                                  param_attr=ParamAttr(name="mlm_ln_scale"),
                                  bias_attr=ParamAttr(name="mlm_ln_bias"))
        word_emb = main.global_block().var("word_embedding")
        lm_logits = layers.matmul(trans, word_emb, transpose_y=True)
        lm_bias = layers.create_parameter([cfg.vocab_size], cfg.dtype,
                                          attr=ParamAttr(name="mlm_out_bias"),
                                          is_bias=True)
        lm_logits = layers.elementwise_add(lm_logits, lm_bias, axis=-1)
        lm_loss_all = layers.softmax_with_cross_entropy(
            lm_logits, layers.unsqueeze(mlm_labels, [2]))
        lm_loss_all = layers.squeeze(lm_loss_all, [2])
        num = layers.reduce_sum(lm_loss_all * mlm_weight)
        denom = layers.reduce_sum(mlm_weight)
        lm_loss = num / (denom + 1e-5)

        if with_nsp:
            # NSP head on pooled [CLS]
            first_tok = layers.slice(seq_out, [1], [0], [1])
            pooled = _dense(first_tok, cfg.hidden_size, "pooler", cfg,
                            act="tanh")
            pooled = layers.reshape(pooled, [0, cfg.hidden_size])
            nsp_logits = layers.fc(pooled, 2, param_attr=_param("nsp_w", cfg),
                                   bias_attr=ParamAttr(name="nsp_b"))
            nsp_loss = layers.mean(
                layers.softmax_with_cross_entropy(nsp_logits, nsp_labels))
            loss = lm_loss + nsp_loss
        else:
            nsp_loss = layers.fill_constant([1], "float32", 0.0)
            loss = lm_loss

        if with_optimizer:
            from .. import optimizer as opt_mod

            if optimizer_name == "adamw":
                opt = opt_mod.AdamWOptimizer(lr, weight_decay=0.01)
            elif optimizer_name == "lamb":
                opt = opt_mod.LambOptimizer(lr)
            else:
                opt = opt_mod.AdamOptimizer(lr)
            opt.minimize(loss)

    feeds = dict(src_ids=src_ids, sent_ids=sent_ids, pos_ids=pos_ids,
                 input_mask=input_mask, mask_labels=mask_labels,
                 mask_weight=mask_weight, nsp_labels=nsp_labels)
    fetches = dict(loss=loss, lm_loss=lm_loss, nsp_loss=nsp_loss)
    return main, startup, feeds, fetches


def encoder_checkpoints(program) -> list:
    """The output of each encoder layer of a program built here (the Y
    of the layer's last layer norm), in layer order: the checkpoints of
    one recompute segment a layer (``strategy.recompute_configs``)."""
    return [op.outputs["Y"][0] for op in program.global_block().ops
            if op.type == "layer_norm"
            and op.inputs["Scale"][0].endswith("_ln2_scale")]


def synthetic_pretraining_batch(cfg: BertConfig, batch_size: int, seq_len: int,
                                seed: int = 0,
                                max_predictions_per_seq: int = 0):
    """max_predictions_per_seq caps the masked count per row (the standard
    BERT data-pipeline contract — required for the masked-gather MLM head
    to be loss-exact)."""
    rng = np.random.RandomState(seed)
    src = rng.randint(0, cfg.vocab_size, (batch_size, seq_len)).astype(np.int64)
    sent = rng.randint(0, cfg.type_vocab_size,
                       (batch_size, seq_len)).astype(np.int64)
    pos = np.tile(np.arange(seq_len, dtype=np.int64), (batch_size, 1))
    mask = np.ones((batch_size, seq_len), np.float32)
    labels = rng.randint(0, cfg.vocab_size, (batch_size, seq_len)).astype(np.int64)
    weight = (rng.rand(batch_size, seq_len) < 0.15).astype(np.float32)
    k = int(max_predictions_per_seq or 0)
    if k > 0:
        for row in weight:      # keep only the first k masked positions
            hits = np.flatnonzero(row)
            if len(hits) > k:
                row[hits[k:]] = 0.0
    nsp = rng.randint(0, 2, (batch_size, 1)).astype(np.int64)
    return dict(src_ids=src, sent_ids=sent, pos_ids=pos, input_mask=mask,
                mask_labels=labels, mask_weight=weight, nsp_labels=nsp)
