"""Transformer (WMT14 En-De, "big" config): the encoder-decoder training
program.

The port of ``paddle_tpu/models/transformer.py``: sinusoidal positions,
the source embedding shared by the encoder, the decoder and the output
projection, post-norm layers ("dropout, add, layer norm"),
label-smoothed cross entropy over padded targets weighted by a 0/1 mask,
and Adam under the noam schedule. The program is built op for op as the
reference builds it (the two serialise to the same JSON). Attention runs
through the packed flash-attention op: encoder self-attention with the
source key-padding bias, decoder self-attention causal with no bias, and
encoder-decoder cross-attention (q from the decoder, k and v from the
encoder output) with the source key-padding bias.

With ``use_flash_attention=False`` attention is the unfused chain
instead: heads split to [B,n,S,hd], ``matmul`` with alpha 1/sqrt(hd),
the shared additive causal table (a non-trainable parameter
``causal_mask_{seq}``, one a program) and the key bias added, ``softmax``,
``dropout`` (upscale_in_train), ``matmul``, heads merged; no flash op
runs.

The tensor-parallel annotations on the weights are recorded (they are
part of the program) but nothing in the port reads them: it runs on one
device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import layers
from ..core.ir import Program, program_guard
from ..initializer import Normal, NumpyArrayInitializer
from ..param_attr import ParamAttr
from ..parallel.api import set_logical_axes, shard_tensor


@dataclass
class TransformerConfig:
    src_vocab_size: int = 32000
    tgt_vocab_size: int = 32000
    max_length: int = 256
    d_model: int = 1024
    n_head: int = 16
    d_inner: int = 4096
    n_encoder_layers: int = 6
    n_decoder_layers: int = 6
    dropout: float = 0.1
    label_smooth_eps: float = 0.1
    weight_sharing: bool = True  # tgt embedding == output projection
    # the packed flash-attention op, or the unfused matmul/softmax chain
    use_flash_attention: bool = True

    def __post_init__(self):
        if self.weight_sharing and self.src_vocab_size != self.tgt_vocab_size:
            raise ValueError(
                "weight_sharing=True requires src_vocab_size == "
                f"tgt_vocab_size (got {self.src_vocab_size} vs "
                f"{self.tgt_vocab_size}): a shared embedding table cannot "
                "serve two vocabularies")


def transformer_big() -> TransformerConfig:
    return TransformerConfig()


def transformer_base() -> TransformerConfig:
    return TransformerConfig(d_model=512, n_head=8, d_inner=2048)


def _sinusoid_table(max_len: int, d: int) -> np.ndarray:
    pos = np.arange(max_len)[:, None].astype(np.float64)
    i = np.arange(d)[None, :].astype(np.float64)
    angle = pos / np.power(10000.0, 2 * (i // 2) / d)
    table = np.zeros((max_len, d), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


def _dense(x, d_out, name, cfg, act=None, tp_spec=None):
    w = layers.create_parameter(
        [int(x.shape[-1]), d_out], "float32",
        attr=ParamAttr(name=name + "_w",
                       initializer=Normal(0.0, cfg.d_model ** -0.5)))
    if tp_spec is not None:
        shard_tensor(w, tp_spec)
    else:
        set_logical_axes(w, ("embed", "mlp"))
    b = layers.create_parameter([d_out], "float32",
                                attr=ParamAttr(name=name + "_b"), is_bias=True)
    if tp_spec is not None and tp_spec[-1] is not None:
        shard_tensor(b, (tp_spec[-1],))
    elif tp_spec is None:
        set_logical_axes(b, ("mlp",))
    out = layers.linear(x, w, b)
    if act:
        out = getattr(layers, act)(out)
    return out


def _causal_bias(seq):
    """The additive [1,1,S,S] upper-triangle mask of the unfused branch:
    -1e9 above the diagonal. The parameter ``causal_mask_{seq}`` is
    deduplicated by name, so every decoder layer shares one table, and
    its unsqueezed variable is cached once a program."""
    from ..core.ir import default_main_program

    prog = default_main_program()
    cache = getattr(prog, "_causal_bias_cache", None)
    if cache is None:
        cache = prog._causal_bias_cache = {}
    if seq not in cache:
        tri = np.triu(np.full((seq, seq), -1e9, np.float32), k=1)
        causal_var = layers.create_parameter(
            [seq, seq], "float32",
            attr=ParamAttr(name=f"causal_mask_{seq}",
                           initializer=NumpyArrayInitializer(tri),
                           trainable=False))
        causal_var.stop_gradient = True
        cache[seq] = layers.unsqueeze(causal_var, [0, 1])
    return cache[seq]


def _mha(q_in, kv_in, attn_bias, cfg, name, is_test=False, causal=False):
    """Multi-head attention, q_in is kv_in for self-attention: three
    projections (column-parallel annotations), attention, the output
    projection (row-parallel). The bias is a key-padding bias [B,1,1,Sk]
    or None; causal=True is the decoder's triangle. With
    ``use_flash_attention`` attention is the packed flash op on the
    projections' [B,S,d] outputs (the triangle inside the kernel);
    without it, the unfused chain on [B,n,S,hd] heads (the triangle an
    additive table, ``_causal_bias``)."""
    d, n = cfg.d_model, cfg.n_head
    hd = d // n
    q = _dense(q_in, d, f"{name}_q", cfg, tp_spec=(None, "mp"))
    k = _dense(kv_in, d, f"{name}_k", cfg, tp_spec=(None, "mp"))
    v = _dense(kv_in, d, f"{name}_v", cfg, tp_spec=(None, "mp"))

    if cfg.use_flash_attention:
        ctx = layers.flash_attention(
            q, k, v, bias=attn_bias, causal=causal, scale=hd ** -0.5,
            num_heads=n, dropout_rate=cfg.dropout, is_test=is_test)
        return _dense(ctx, d, f"{name}_o", cfg, tp_spec=("mp", None))

    def split_heads(t):
        t = layers.reshape(t, [0, 0, n, hd])
        return layers.transpose(t, [0, 2, 1, 3])  # [B,n,S,hd]

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    scores = layers.matmul(q, k, transpose_y=True, alpha=hd ** -0.5)
    if causal:
        scores = scores + _causal_bias(int(q.shape[2]))
    if attn_bias is not None:
        scores = scores + attn_bias
    probs = layers.softmax(scores)
    probs = layers.dropout(probs, cfg.dropout, is_test=is_test,
                           dropout_implementation="upscale_in_train")
    ctx = layers.matmul(probs, v)
    ctx = layers.transpose(ctx, [0, 2, 1, 3])
    ctx = layers.reshape(ctx, [0, 0, d])
    return _dense(ctx, d, f"{name}_o", cfg, tp_spec=("mp", None))


def _prepost(x, residual, cfg, name, is_test=False):
    """Dropout, residual add, layer norm."""
    x = layers.dropout(x, cfg.dropout, is_test=is_test,
                       dropout_implementation="upscale_in_train")
    return layers.layer_norm(x + residual, begin_norm_axis=2,
                             param_attr=ParamAttr(name=name + "_ln_scale"),
                             bias_attr=ParamAttr(name=name + "_ln_bias"))


def _ffn(x, cfg, name):
    h = _dense(x, cfg.d_inner, f"{name}_fc1", cfg, act="relu",
               tp_spec=(None, "mp"))
    return _dense(h, cfg.d_model, f"{name}_fc2", cfg, tp_spec=("mp", None))


def _embed(ids, vocab_size, cfg, name, is_test=False):
    """Token embedding * sqrt(d) + the fixed sinusoid table + dropout. The
    table is a non-trainable parameter named after the embedding, so a
    shared embedding shares its table too."""
    emb = layers.embedding(ids, [vocab_size, cfg.d_model],
                           param_attr=ParamAttr(
                               name=name,
                               initializer=Normal(0.0, cfg.d_model ** -0.5)))
    emb = layers.scale(emb, scale=cfg.d_model ** 0.5)
    seq_len = int(ids.shape[1])
    pos_tab = _sinusoid_table(seq_len, cfg.d_model)
    pos = layers.create_parameter(
        [seq_len, cfg.d_model], "float32",
        attr=ParamAttr(name=f"{name}_pos_enc",
                       initializer=NumpyArrayInitializer(pos_tab),
                       trainable=False))
    pos.stop_gradient = True
    x = emb + pos
    return layers.dropout(x, cfg.dropout, is_test=is_test,
                          dropout_implementation="upscale_in_train")


def encoder(src_ids, src_mask, cfg, is_test=False):
    x = _embed(src_ids, cfg.src_vocab_size, cfg, "src_word_emb", is_test)
    # (mask - 1) * 1e9: 0 on real tokens, -1e9 on padding, [B,1,1,S]
    bias = layers.unsqueeze(src_mask, [1, 2])
    attn_bias = layers.scale(bias, scale=1e9, bias=-1.0, bias_after_scale=False)
    attn_bias.stop_gradient = True
    for i in range(cfg.n_encoder_layers):
        name = f"enc_{i}"
        x = _prepost(_mha(x, x, attn_bias, cfg, f"{name}_sa", is_test), x,
                     cfg, f"{name}_sa", is_test)
        x = _prepost(_ffn(x, cfg, f"{name}_ffn"), x, cfg, f"{name}_ffn",
                     is_test)
    return x


def decoder(tgt_ids, enc_out, src_mask, cfg, is_test=False):
    x = _embed(tgt_ids, cfg.tgt_vocab_size, cfg,
               "src_word_emb" if cfg.weight_sharing else "tgt_word_emb",
               is_test)
    cross = layers.unsqueeze(src_mask, [1, 2])
    cross_bias = layers.scale(cross, scale=1e9, bias=-1.0,
                              bias_after_scale=False)
    cross_bias.stop_gradient = True
    for i in range(cfg.n_decoder_layers):
        name = f"dec_{i}"
        x = _prepost(_mha(x, x, None, cfg, f"{name}_sa", is_test,
                          causal=True), x,
                     cfg, f"{name}_sa", is_test)
        x = _prepost(_mha(x, enc_out, cross_bias, cfg, f"{name}_ca", is_test),
                     x, cfg, f"{name}_ca", is_test)
        x = _prepost(_ffn(x, cfg, f"{name}_ffn"), x, cfg, f"{name}_ffn",
                     is_test)
    return x


def build_wmt_program(cfg: TransformerConfig, seq_len: int = 64,
                      batch_size: int = -1, warmup_steps: int = 4000,
                      lr_scale: float = 2.0, is_test=False,
                      with_optimizer=True, amp: bool = False):
    """The teacher-forced training step.

    Feeds: src_ids, tgt_ids, lbl_ids [B,S] int64; src_mask, lbl_weight
    [B,S] float32 (1 on real tokens). Fetches: loss (the weighted token
    mean) and token_num. amp=True runs the matmul-class ops in bf16
    through the static AMP rewrite (no loss scaling)."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        B, S = batch_size, seq_len
        src_ids = layers.static_data("src_ids", [B, S], "int64")
        tgt_ids = layers.static_data("tgt_ids", [B, S], "int64")
        lbl_ids = layers.static_data("lbl_ids", [B, S], "int64")
        src_mask = layers.static_data("src_mask", [B, S], "float32")
        lbl_weight = layers.static_data("lbl_weight", [B, S], "float32")

        enc_out = encoder(src_ids, src_mask, cfg, is_test)
        dec_out = decoder(tgt_ids, enc_out, src_mask, cfg, is_test)

        if cfg.weight_sharing:
            emb = main.global_block().var("src_word_emb")
            logits = layers.matmul(dec_out, emb, transpose_y=True)
        else:
            logits = _dense(dec_out, cfg.tgt_vocab_size, "out_proj", cfg)

        # label-smoothed soft-label cross entropy
        oh = layers.one_hot(lbl_ids, cfg.tgt_vocab_size)
        smooth = layers.label_smooth(layers.cast(oh, "float32"),
                                     epsilon=cfg.label_smooth_eps)
        smooth.stop_gradient = True
        per_tok = layers.softmax_with_cross_entropy(logits, smooth,
                                                    soft_label=True)
        per_tok = layers.squeeze(per_tok, [2])
        token_num = layers.reduce_sum(lbl_weight)
        token_num.stop_gradient = True
        loss = layers.reduce_sum(per_tok * lbl_weight) / (token_num + 1e-9)

        if with_optimizer:
            from .. import optimizer as opt_mod

            lr = layers.noam_decay(cfg.d_model, warmup_steps,
                                   learning_rate=lr_scale)
            opt = opt_mod.AdamOptimizer(lr, beta1=0.9, beta2=0.997,
                                        epsilon=1e-9)
            if amp:
                from ..contrib.mixed_precision import decorate

                opt = decorate(opt, use_dynamic_loss_scaling=False)
            opt.minimize(loss)

    feeds = dict(src_ids=src_ids, tgt_ids=tgt_ids, lbl_ids=lbl_ids,
                 src_mask=src_mask, lbl_weight=lbl_weight)
    fetches = dict(loss=loss, token_num=token_num)
    return main, startup, feeds, fetches


def synthetic_batch(cfg: TransformerConfig, batch_size: int, seq_len: int,
                    seed: int = 0):
    """Random ids from 1 up, labels the targets shifted by one, and each
    row's first ``len`` positions real, len uniform in [S/2, S]."""
    rng = np.random.RandomState(seed)
    src = rng.randint(1, cfg.src_vocab_size, (batch_size, seq_len))
    tgt = rng.randint(1, cfg.tgt_vocab_size, (batch_size, seq_len))
    lbl = np.roll(tgt, -1, axis=1)
    lens = rng.randint(seq_len // 2, seq_len + 1, batch_size)
    mask = (np.arange(seq_len)[None, :] < lens[:, None])
    return dict(src_ids=src.astype(np.int64), tgt_ids=tgt.astype(np.int64),
                lbl_ids=lbl.astype(np.int64),
                src_mask=mask.astype(np.float32),
                lbl_weight=mask.astype(np.float32))
