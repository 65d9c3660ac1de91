"""Decoder-only transformer LM — the generative-serving workload.

The port of ``paddle_tpu/models/decoder_lm.py``: the same post-LN block
stack, built as the same two op-desc programs (same op types, slots,
attrs and var names) that ``serving/decode.py`` runs:

* ``build_prefill_program`` — one causal pass over the padded prompt
  that writes every token's K/V into the paged pool (``kv_cache_write``)
  and emits the last valid position's logits;
* ``build_step_program`` — one token per slot at a fixed slot-array
  shape, attending through ``cached_kv_attention``;
* ``build_chunk_prefill_program`` — one page-aligned chunk of a prompt
  against the pool (``chunk_cached_attention``), the prefix store's
  prefill (``serving/prefix_store.py``).

Parameters are ``static_data`` feeds (or ``layer_norm`` parameters)
resolved by name from the engine's param dict. Under
``weight_quant="int8"`` every dense layer is one ``int8_matmul`` op over
(int8 weight, per-output-channel scale, bias). Params are numpy arrays
in the same layout as the JAX package's, so ``params_from_numpy`` moves
either package's dict (or a servable dir written by either) onto a
torch device.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass
from typing import Dict

import numpy as np
import torch

from .. import layers
from ..core.ir import Program, default_main_program, program_guard
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

PARAMS_FILE = "decoder_lm_params.npz"
CONFIG_FILE = "decoder_lm_config.json"


@dataclass
class DecoderLMConfig:
    vocab_size: int = 1024
    d_model: int = 64
    n_head: int = 4
    n_layers: int = 2
    d_inner: int = 128
    max_seq_len: int = 128
    bos_id: int = 1
    eos_id: int = 2

    def __post_init__(self):
        if self.d_model % self.n_head:
            raise ValueError(f"d_model {self.d_model} not divisible by "
                             f"n_head {self.n_head}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head


def _dense_specs(cfg: DecoderLMConfig):
    """Dense sublayers per block, in program order: (suffix, d_in, d_out)."""
    d, di = cfg.d_model, cfg.d_inner
    return [("q", d, d), ("k", d, d), ("v", d, d), ("o", d, d),
            ("fc1", d, di), ("fc2", di, d)]


def _param(name, shape, dtype="float32"):
    return layers.static_data(name, list(shape), dtype)


def _dense(x, name, d_in, d_out, quant: bool):
    """x @ W + b with W an fp32 feed, or one weight-only ``int8_matmul``
    op over (int8 weight, per-channel scale, bias)."""
    b = _param(f"{name}_b", (d_out,))
    if quant:
        w8 = _param(f"{name}_w_i8", (d_in, d_out), "int8")
        ws = _param(f"{name}_w_scale", (d_out,))
        helper = LayerHelper("int8_matmul")
        out = helper.create_variable_for_type_inference("float32")
        helper.append_op("int8_matmul",
                         {"X": [x], "Y": [w8], "YScale": [ws], "Bias": [b]},
                         {"Out": [out]}, {})
        return out
    w = _param(f"{name}_w", (d_in, d_out))
    return layers.linear(x, w, b)


def _post_ln(x, residual, name):
    return layers.layer_norm(x + residual, begin_norm_axis=len(x.shape) - 1,
                             param_attr=ParamAttr(name=f"{name}_scale"),
                             bias_attr=ParamAttr(name=f"{name}_bias"))


def _sinusoid_table(max_len: int, d: int) -> np.ndarray:
    pos = np.arange(max_len)[:, None].astype(np.float64)
    i = np.arange(d)[None, :].astype(np.float64)
    angle = pos / np.power(10000.0, 2 * (i // 2) / d)
    table = np.zeros((max_len, d), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


def decoder_lm_params(cfg: DecoderLMConfig, seed: int = 0):
    """Deterministic fp32 numpy parameter dict for the builders' names —
    the same arrays as ``paddle_tpu``'s for the same (cfg, seed)."""
    rng = np.random.RandomState(seed)
    std = cfg.d_model ** -0.5
    p = {"lm_tok_emb": rng.normal(0.0, std, (cfg.vocab_size, cfg.d_model))
         .astype(np.float32),
         "lm_pos_enc": _sinusoid_table(cfg.max_seq_len, cfg.d_model)}
    for i in range(cfg.n_layers):
        for suffix, d_in, d_out in _dense_specs(cfg):
            p[f"lm_l{i}_{suffix}_w"] = rng.normal(
                0.0, std, (d_in, d_out)).astype(np.float32)
            p[f"lm_l{i}_{suffix}_b"] = np.zeros(d_out, np.float32)
        for ln in ("ln1", "ln2"):
            p[f"lm_l{i}_{ln}_scale"] = np.ones(cfg.d_model, np.float32)
            p[f"lm_l{i}_{ln}_bias"] = np.zeros(cfg.d_model, np.float32)
    return p


def quantize_decoder_lm_params(params, cfg: DecoderLMConfig):
    """fp32 numpy param dict -> weight-only int8 layout: every dense
    weight becomes (<name>_w_i8 int8, <name>_w_scale fp32 per-output-
    channel abs-max / 127); embeddings, positions, norms and biases stay
    fp32. A dict already in that layout passes through unchanged."""
    out = {}
    for name, v in params.items():
        if name.endswith("_w") and v.ndim == 2 and name != "lm_tok_emb":
            scale = np.maximum(np.abs(v).max(axis=0), 1e-8) / 127.0
            q = np.clip(np.round(v / scale[None, :]), -127, 127)
            out[name + "_i8"] = q.astype(np.int8)
            out[name + "_scale"] = scale.astype(np.float32)
        else:
            out[name] = v
    return out


def params_from_numpy(params: Dict[str, np.ndarray],
                      device) -> Dict[str, torch.Tensor]:
    """The JAX package's parameter dict (fp32 or its int8 form, as numpy
    arrays) -> contiguous torch tensors on ``device``, dtypes kept."""
    device = torch.device(device)
    return {n: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for n, v in params.items()}


def _atomic_write(path: str, write, mode: str = "wb"):
    """Write through a temp file in the same dir, then rename it in."""
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, mode) as f:
            write(f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_decoder_lm(model_dir: str, cfg: DecoderLMConfig,
                    params: Dict[str, np.ndarray]) -> str:
    """Persist config + numpy params as a servable dir, in the reference's
    format (``decoder_lm_config.json`` + ``decoder_lm_params.npz``, each
    committed by an atomic rename), so either package's
    ``load_decoder_lm`` reads it."""
    os.makedirs(model_dir, exist_ok=True)
    _atomic_write(os.path.join(model_dir, CONFIG_FILE),
                  lambda f: json.dump(asdict(cfg), f), mode="w")
    _atomic_write(os.path.join(model_dir, PARAMS_FILE),
                  lambda f: np.savez(f, **params))
    return model_dir


def load_decoder_lm(model_dir: str):
    """(cfg, numpy params) from a servable dir written by
    ``paddle_tpu.models.decoder_lm.save_decoder_lm``."""
    with open(os.path.join(model_dir, CONFIG_FILE)) as f:
        cfg = DecoderLMConfig(**json.load(f))
    with np.load(os.path.join(model_dir, PARAMS_FILE)) as z:
        params = {k: z[k] for k in z.files}
    return cfg, params


def _embed_step(tokens, positions, cfg):
    emb = _param("lm_tok_emb", (cfg.vocab_size, cfg.d_model))
    pos = _param("lm_pos_enc", (cfg.max_seq_len, cfg.d_model))
    x = layers.scale(layers.gather(emb, tokens), scale=cfg.d_model ** 0.5)
    return x + layers.gather(pos, positions), emb


def _pool_vars(cfg, layer, num_pages, page_size):
    return (_param(f"kv_k_{layer}", (num_pages, page_size, cfg.d_model)),
            _param(f"kv_v_{layer}", (num_pages, page_size, cfg.d_model)))


def _named_out(name, dtype="float32"):
    return default_main_program().current_block().create_var(
        name=name, dtype=dtype, stop_gradient=True)


def _block_tail(x, attn, name, cfg, quant):
    """Output projection, post-LN residuals and the ReLU MLP."""
    o = _dense(attn, f"{name}_o", cfg.d_model, cfg.d_model, quant)
    x = _post_ln(o, x, f"{name}_ln1")
    h = layers.relu(_dense(x, f"{name}_fc1", cfg.d_model, cfg.d_inner,
                           quant))
    f = _dense(h, f"{name}_fc2", cfg.d_inner, cfg.d_model, quant)
    return _post_ln(f, x, f"{name}_ln2")


def _logits(h, emb):
    logits = _named_out("logits")
    LayerHelper("matmul").append_op(
        "matmul", {"X": [h], "Y": [emb]}, {"Out": [logits]},
        {"transpose_Y": True})


def build_step_program(cfg: DecoderLMConfig, batch: int, num_pages: int,
                       page_size: int, weight_quant: str = "none"):
    """One decode step at a FIXED [batch] slot-array shape.

    Feeds: tokens [B] int32, positions [B] int32, page_table [B, MP]
    int32, plus the kv_k_<l>/kv_v_<l> pools. Fetches: ``logits``
    [B, vocab] and kv_k_<l>_out/kv_v_<l>_out (the pools, updated in
    place). The fixed shape keeps per-row results a function of the row
    alone, so continuous batching is bitwise-identical to sequential
    decode."""
    quant = weight_quant == "int8"
    mp = -(-cfg.max_seq_len // page_size)
    main, startup = Program(), Program()
    with program_guard(main, startup):
        tokens = layers.static_data("tokens", [batch], "int32")
        positions = layers.static_data("positions", [batch], "int32")
        table = layers.static_data("page_table", [batch, mp], "int32")
        x, emb = _embed_step(tokens, positions, cfg)
        pool_outs = []
        for i in range(cfg.n_layers):
            name = f"lm_l{i}"
            q = _dense(x, f"{name}_q", cfg.d_model, cfg.d_model, quant)
            k = _dense(x, f"{name}_k", cfg.d_model, cfg.d_model, quant)
            v = _dense(x, f"{name}_v", cfg.d_model, cfg.d_model, quant)
            pk, pv = _pool_vars(cfg, i, num_pages, page_size)
            attn = _named_out(f"lm_l{i}_attn")
            pk_out = _named_out(f"kv_k_{i}_out")
            pv_out = _named_out(f"kv_v_{i}_out")
            LayerHelper("cached_kv_attention").append_op(
                "cached_kv_attention",
                {"Q": [q], "K": [k], "V": [v], "PoolK": [pk], "PoolV": [pv],
                 "PageTable": [table], "Positions": [positions]},
                {"Out": [attn], "PoolKOut": [pk_out], "PoolVOut": [pv_out]},
                {"num_heads": cfg.n_head, "head_dim": cfg.head_dim,
                 "scale": cfg.head_dim ** -0.5})
            pool_outs += [pk_out.name, pv_out.name]
            x = _block_tail(x, attn, name, cfg, quant)
        _logits(x, emb)
    return main, ["tokens", "positions", "page_table"], \
        ["logits"] + pool_outs


def build_chunk_prefill_program(cfg: DecoderLMConfig, batch: int,
                                chunk_len: int, num_pages: int,
                                page_size: int,
                                weight_quant: str = "none"):
    """PAGE-CHUNKED prefill: one pass over a [batch, chunk_len] slice of
    the prompt starting at a page-aligned global position, attending over
    the already-written pool prefix and the chunk causally
    (``chunk_cached_attention``) and writing the chunk's K/V into the
    row's pages. Running a prompt chunk by chunk through this one
    fixed-shape program is the prefix store's prefill: a cache hit skips
    the cached chunks and replays only the suffix, bit-identical to the
    cold run, because each chunk's compute is a function of (chunk
    tokens, prior pool bytes) at one fixed shape.

    Feeds: tokens [B, C] int32 (right-padded chunk), positions [B, C]
    int32 (global positions, for the position encoding), chunk_start [B]
    int32, lengths [B] int32 (valid tokens in the chunk), last_onehot
    [B, C] fp32 (one-hot of the last valid chunk position: the logits
    read, meaningful on the prompt's final chunk), page_table [B, MP]
    int32, and the kv pools. Fetches: ``logits`` and kv_*_out."""
    quant = weight_quant == "int8"
    mp = -(-cfg.max_seq_len // page_size)
    main, startup = Program(), Program()
    with program_guard(main, startup):
        tokens = layers.static_data("tokens", [batch, chunk_len], "int32")
        positions = layers.static_data("positions", [batch, chunk_len],
                                       "int32")
        start = layers.static_data("chunk_start", [batch], "int32")
        lengths = layers.static_data("lengths", [batch], "int32")
        last_oh = layers.static_data("last_onehot", [batch, chunk_len],
                                     "float32")
        table = layers.static_data("page_table", [batch, mp], "int32")
        x, emb = _embed_step(tokens, positions, cfg)
        pool_outs = []
        for i in range(cfg.n_layers):
            name = f"lm_l{i}"
            q = _dense(x, f"{name}_q", cfg.d_model, cfg.d_model, quant)
            k = _dense(x, f"{name}_k", cfg.d_model, cfg.d_model, quant)
            v = _dense(x, f"{name}_v", cfg.d_model, cfg.d_model, quant)
            pk, pv = _pool_vars(cfg, i, num_pages, page_size)
            attn = _named_out(f"lm_l{i}_attn")
            pk_out = _named_out(f"kv_k_{i}_out")
            pv_out = _named_out(f"kv_v_{i}_out")
            LayerHelper("chunk_cached_attention").append_op(
                "chunk_cached_attention",
                {"Q": [q], "K": [k], "V": [v], "PoolK": [pk], "PoolV": [pv],
                 "PageTable": [table], "ChunkStart": [start],
                 "Lengths": [lengths]},
                {"Out": [attn], "PoolKOut": [pk_out], "PoolVOut": [pv_out]},
                {"num_heads": cfg.n_head, "head_dim": cfg.head_dim,
                 "scale": cfg.head_dim ** -0.5})
            pool_outs += [pk_out.name, pv_out.name]
            x = _block_tail(x, attn, name, cfg, quant)
        h_last = layers.reduce_sum(x * layers.unsqueeze(last_oh, [2]),
                                   dim=1)
        _logits(h_last, emb)
    feeds = ["tokens", "positions", "chunk_start", "lengths",
             "last_onehot", "page_table"]
    return main, feeds, ["logits"] + pool_outs


def build_prefill_program(cfg: DecoderLMConfig, batch: int, prompt_len: int,
                          num_pages: int, page_size: int,
                          weight_quant: str = "none"):
    """Causal pass over a [batch, prompt_len] right-padded prompt that
    writes every real token's K/V into the paged pool and emits the LAST
    valid position's logits.

    Feeds: tokens [B, S] int32, lengths [B] int32, last_onehot [B, S]
    fp32 (one-hot of lengths-1), page_table [B, MP] int32, and the kv
    pools. Padded positions are kept away from real queries by the
    causal mask, and kv_cache_write routes them to scratch page 0."""
    quant = weight_quant == "int8"
    mp = -(-cfg.max_seq_len // page_size)
    main, startup = Program(), Program()
    with program_guard(main, startup):
        tokens = layers.static_data("tokens", [batch, prompt_len], "int32")
        lengths = layers.static_data("lengths", [batch], "int32")
        last_oh = layers.static_data("last_onehot", [batch, prompt_len],
                                     "float32")
        table = layers.static_data("page_table", [batch, mp], "int32")
        emb = _param("lm_tok_emb", (cfg.vocab_size, cfg.d_model))
        pos = _param("lm_pos_enc", (cfg.max_seq_len, cfg.d_model))
        x = layers.scale(layers.gather(emb, tokens),
                         scale=cfg.d_model ** 0.5)
        x = x + layers.slice(pos, [0], [0], [prompt_len])
        pool_outs = []
        for i in range(cfg.n_layers):
            name = f"lm_l{i}"
            q = _dense(x, f"{name}_q", cfg.d_model, cfg.d_model, quant)
            k = _dense(x, f"{name}_k", cfg.d_model, cfg.d_model, quant)
            v = _dense(x, f"{name}_v", cfg.d_model, cfg.d_model, quant)
            pk, pv = _pool_vars(cfg, i, num_pages, page_size)
            pk_out = _named_out(f"kv_k_{i}_out")
            pv_out = _named_out(f"kv_v_{i}_out")
            LayerHelper("kv_cache_write").append_op(
                "kv_cache_write",
                {"K": [k], "V": [v], "PoolK": [pk], "PoolV": [pv],
                 "PageTable": [table], "Lengths": [lengths]},
                {"PoolKOut": [pk_out], "PoolVOut": [pv_out]}, {})
            pool_outs += [pk_out.name, pv_out.name]
            ctx = layers.flash_attention(q, k, v, causal=True,
                                         scale=cfg.head_dim ** -0.5,
                                         num_heads=cfg.n_head, is_test=True)
            x = _block_tail(x, ctx, name, cfg, quant)
        # last valid position's hidden state: one masked reduce over S
        h_last = layers.reduce_sum(x * layers.unsqueeze(last_oh, [2]),
                                   dim=1)
        _logits(h_last, emb)
    return main, ["tokens", "lengths", "last_onehot", "page_table"], \
        ["logits"] + pool_outs
