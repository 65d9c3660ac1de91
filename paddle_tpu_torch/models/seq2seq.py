"""Seq2seq machine translation, the book's machine_translation
(tests/book/test_machine_translation.py): an LSTM encoder, an LSTM
decoder started from the encoder's last state, Luong global attention
after the decoder and a softmax over the target vocabulary. The port of
``paddle_tpu/models/seq2seq.py``: the training program is built op for
op as the reference builds it (the two serialise to the same JSON); the
decoders are plain torch functions over the port's scope, one loop over
the steps, on the device the scope's tensors live on.

Sequences are padded [B, S] ids with a length mask; the recurrences are
the ``lstm`` op (``ops/rnn_ops.py``), which the decoders' steps follow:
gates i, f, c, o, and a source row's state frozen past its length."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import layers
from ..core.ir import Program, program_guard
from ..initializer import Normal
from ..ops.beam_search_ops import top_k_rows
from ..param_attr import ParamAttr


@dataclass
class Seq2SeqConfig:
    src_vocab_size: int = 10000
    tgt_vocab_size: int = 10000
    embed_dim: int = 256
    hidden_size: int = 512
    dtype: str = "float32"


def _embedding(ids, vocab, dim, name, cfg):
    return layers.embedding(
        ids, [vocab, dim],
        param_attr=ParamAttr(name=name, initializer=Normal(0.0, 0.1)),
        dtype=cfg.dtype)


def build_seq2seq_program(cfg: Seq2SeqConfig, src_len: int, tgt_len: int,
                          batch_size: int = -1, lr: float = 1e-3,
                          with_optimizer: bool = True):
    """The teacher-forced training step: (main, startup, feeds,
    fetches). Feeds src_ids and src_mask [B, Ss] (1 real / 0 pad),
    tgt_in, tgt_out (shifted by one) and tgt_mask [B, St]; fetches the
    loss, the masked mean token cross entropy. Adam at ``lr``."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        B = batch_size
        src = layers.static_data("src_ids", [B, src_len], "int64")
        src_mask = layers.static_data("src_mask", [B, src_len], "float32")
        tgt_in = layers.static_data("tgt_in", [B, tgt_len], "int64")
        tgt_out = layers.static_data("tgt_out", [B, tgt_len], "int64")
        tgt_mask = layers.static_data("tgt_mask", [B, tgt_len], "float32")

        h = cfg.hidden_size
        src_emb = _embedding(src, cfg.src_vocab_size, cfg.embed_dim,
                             "src_embedding", cfg)
        # the encoder stops at each row's length, so its last state (the
        # decoder's start) never reads a pad position
        src_lens = layers.cast(layers.reduce_sum(src_mask, dim=1), "int32")
        enc_out, enc_h, enc_c = layers.lstm_unit_layer(
            src_emb, h, name="encoder", seq_length=src_lens,
            param_attr=ParamAttr(name="enc_wx"),
            bias_attr=ParamAttr(name="enc_b"))

        tgt_emb = _embedding(tgt_in, cfg.tgt_vocab_size, cfg.embed_dim,
                             "tgt_embedding", cfg)
        dec_out, _, _ = layers.lstm_unit_layer(
            tgt_emb, h, name="decoder", h0=enc_h, c0=enc_c,
            param_attr=ParamAttr(name="dec_wx"),
            bias_attr=ParamAttr(name="dec_b"))

        # Luong attention: scores [B, St, Ss], source padding at -1e4
        scores = layers.matmul(dec_out, enc_out, transpose_y=True,
                               alpha=1.0 / np.sqrt(h))
        bias = layers.scale(src_mask, scale=10000.0, bias=-1.0,
                            bias_after_scale=False)
        bias = layers.unsqueeze(bias, [1])
        scores = scores + bias
        probs = layers.softmax(scores)
        context = layers.matmul(probs, enc_out)
        attn_in = layers.concat([dec_out, context], axis=2)
        attn_vec = layers.fc(attn_in, h, num_flatten_dims=2, act="tanh",
                             param_attr=ParamAttr(name="attn_w"),
                             bias_attr=ParamAttr(name="attn_b"))

        logits = layers.fc(attn_vec, cfg.tgt_vocab_size, num_flatten_dims=2,
                           param_attr=ParamAttr(name="out_w"),
                           bias_attr=ParamAttr(name="out_b"))
        ce = layers.softmax_with_cross_entropy(
            logits, layers.unsqueeze(tgt_out, [2]))
        ce = layers.squeeze(ce, [2])
        num = layers.reduce_sum(ce * tgt_mask)
        denom = layers.reduce_sum(tgt_mask) + 1e-6
        loss = num / denom

        if with_optimizer:
            from .. import optimizer as opt_mod

            opt_mod.AdamOptimizer(lr).minimize(loss)

    feeds = dict(src_ids=src, src_mask=src_mask, tgt_in=tgt_in,
                 tgt_out=tgt_out, tgt_mask=tgt_mask)
    return main, startup, feeds, {"loss": loss}


def synthetic_translation_batch(cfg: Seq2SeqConfig, batch: int, src_len: int,
                                tgt_len: int, seed: int = 0):
    """Random ids in [1, vocab) with lengths from half to all of each
    side, the reference's batch for a seed."""
    rng = np.random.RandomState(seed)
    src = rng.randint(1, cfg.src_vocab_size, (batch, src_len)).astype(np.int64)
    src_l = rng.randint(src_len // 2, src_len + 1, (batch,))
    src_mask = (np.arange(src_len)[None, :] < src_l[:, None]).astype(np.float32)
    tgt = rng.randint(1, cfg.tgt_vocab_size,
                      (batch, tgt_len + 1)).astype(np.int64)
    tgt_l = rng.randint(tgt_len // 2, tgt_len + 1, (batch,))
    tgt_mask = (np.arange(tgt_len)[None, :] < tgt_l[:, None]).astype(np.float32)
    return dict(src_ids=src, src_mask=src_mask, tgt_in=tgt[:, :-1],
                tgt_out=tgt[:, 1:], tgt_mask=tgt_mask)


_FIXED = ("src_embedding", "tgt_embedding", "enc_wx", "enc_b", "dec_wx",
          "dec_b", "attn_w", "attn_b", "out_w", "out_b")


def _decode_params(scope):
    """The trained parameters by name. The recurrent weights carry a
    unique-name suffix (``encoder_wh_<k>``) that depends on how many
    LSTMs the process built, so they are found by prefix."""
    params = {}
    for n in _FIXED:
        v = scope.find_var(n)
        if v is None:
            raise KeyError(f"decode: param '{n}' not in scope")
        params[n] = v
    for key, prefix in (("enc_wh", "encoder_wh"), ("dec_wh", "decoder_wh")):
        cands = sorted(n for n in scope.local_var_names()
                       if n.startswith(prefix))
        if not cands:
            raise KeyError(f"decode: no '{prefix}*' param in scope")
        params[key] = scope.find_var(cands[0])
    return params


def _cell(x_proj, hh, cc, wh):
    """One LSTM step from the projected input: the lstm op's gates."""
    i, f, g, o = (x_proj + hh @ wh).chunk(4, dim=-1)
    cc = torch.sigmoid(f) * cc + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(cc), cc


def _encode(p, src_ids, src_mask, hidden):
    """The encoder's last state and its states [B, Ss, H], each row
    frozen past its length, as the training program's lstm op runs."""
    emb = p["src_embedding"][src_ids]
    b = emb.shape[0]
    lens = src_mask.sum(dim=1)
    hh = emb.new_zeros((b, hidden))
    cc = emb.new_zeros((b, hidden))
    states = []
    for t in range(emb.shape[1]):
        hh_n, cc_n = _cell(emb[:, t] @ p["enc_wx"] + p["enc_b"], hh, cc,
                           p["enc_wh"])
        alive = (t < lens)[:, None]
        hh = torch.where(alive, hh_n, hh)
        cc = torch.where(alive, cc_n, cc)
        states.append(hh)
    return hh, cc, torch.stack(states, dim=1)


def _attend(p, hh, enc_states, bias, hidden):
    """Luong attention of the decoder state over the encoder's states,
    then the tanh projection: [B, H]."""
    sc = torch.einsum("bh,bsh->bs", hh, enc_states) / np.sqrt(hidden)
    probs = torch.softmax(sc + bias, dim=-1)
    ctx = torch.einsum("bs,bsh->bh", probs, enc_states)
    return torch.tanh(torch.cat([hh, ctx], dim=-1) @ p["attn_w"]
                      + p["attn_b"])


def _inputs(p, src_ids, src_mask):
    dev = p["enc_wx"].device
    return (torch.as_tensor(np.asarray(src_ids), device=dev).long(),
            torch.as_tensor(np.asarray(src_mask, np.float32), device=dev))


@torch.no_grad()
def greedy_decode(cfg: Seq2SeqConfig, scope, src_ids, src_mask,
                  bos_id: int = 1, eos_id: int = 2, max_len: int = 32,
                  trace=None):
    """Greedy decoding with the trained parameters: each step's argmax
    fed back, a row that emitted eos_id emitting it from then on.
    [B, max_len] int32 ids. A ``trace`` list gets each step's (choices
    [B], margin [B]) on the host, the margin the gap between the two
    largest logits of the row."""
    p = _decode_params(scope)
    h = cfg.hidden_size
    src_ids, src_mask = _inputs(p, src_ids, src_mask)
    b = src_ids.shape[0]
    hh, cc, enc_states = _encode(p, src_ids, src_mask, h)
    bias = (src_mask - 1.0) * 1e4
    tok = torch.full((b,), bos_id, dtype=torch.long, device=src_ids.device)
    done = torch.zeros(b, dtype=torch.bool, device=src_ids.device)
    toks = []
    for _ in range(max_len):
        hh, cc = _cell(p["tgt_embedding"][tok] @ p["dec_wx"] + p["dec_b"],
                       hh, cc, p["dec_wh"])
        logits = _attend(p, hh, enc_states, bias, h) @ p["out_w"] \
            + p["out_b"]
        tok = torch.where(done, eos_id, torch.argmax(logits, dim=-1))
        if trace is not None:
            top2 = torch.topk(logits, 2, dim=-1).values
            trace.append((tok.cpu(), (top2[:, 0] - top2[:, 1]).cpu()))
        done = done | (tok == eos_id)
        toks.append(tok)
    return torch.stack(toks, dim=1).to(torch.int32).cpu().numpy()


def _log_softmax(x):
    """``jax.nn.log_softmax``: the max taken off, then the log of the sum
    of exponentials."""
    shifted = x - x.amax(dim=-1, keepdim=True)
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


@torch.no_grad()
def beam_search_decode(cfg: Seq2SeqConfig, scope, src_ids, src_mask,
                       beam_size: int = 4, bos_id: int = 1, eos_id: int = 2,
                       max_len: int = 32, length_penalty: float = 0.6,
                       trace=None):
    """Beam search over fixed [B, K] lanes: the K best of each row's
    K x V extensions a step, chosen as ``lax.top_k`` chooses (the lower
    index among equal scores); a finished lane extends only with eos_id
    at no cost; at the end the best lane by the GNMT length penalty
    ((5 + length) / 6) ** length_penalty, a lane's length running to its
    first eos_id. The best sequence of each row, [B, max_len] int32. A
    ``trace`` list gets each step's (choices [B, K], the flat indices of
    the selected candidates, and margin [B], the least gap between two
    neighbours of the row's K + 1 best candidates) on the host."""
    p = _decode_params(scope)
    h, v, k = cfg.hidden_size, cfg.tgt_vocab_size, beam_size
    src_ids, src_mask = _inputs(p, src_ids, src_mask)
    dev = src_ids.device
    b = src_ids.shape[0]
    eh, ec, enc_states = _encode(p, src_ids, src_mask, h)
    enc_t = enc_states.repeat_interleave(k, dim=0)
    bias_t = ((src_mask - 1.0) * 1e4).repeat_interleave(k, dim=0)
    hh, cc = eh.repeat_interleave(k, dim=0), ec.repeat_interleave(k, dim=0)
    tok = torch.full((b * k,), bos_id, dtype=torch.long, device=dev)
    # only lane 0 of a row is alive at first, so the first expansion is
    # not repeated K times
    score = torch.tensor([0.0] + [-1e9] * (k - 1), device=dev).repeat(b)
    done = torch.zeros(b * k, dtype=torch.bool, device=dev)
    seqs = torch.zeros((b * k, max_len), dtype=torch.int32, device=dev)
    eos_only = torch.full((b * k, v), -1e9, device=dev)
    eos_only[:, eos_id] = 0.0
    rows = torch.arange(b, device=dev)[:, None] * k
    for t in range(max_len):
        hh_n, cc_n = _cell(p["tgt_embedding"][tok] @ p["dec_wx"]
                           + p["dec_b"], hh, cc, p["dec_wh"])
        logp = _log_softmax(_attend(p, hh_n, enc_t, bias_t, h) @ p["out_w"]
                            + p["out_b"])
        logp = torch.where(done[:, None], eos_only, logp)
        cand = (score[:, None] + logp).reshape(b, k * v)
        top_sc, top_ix = top_k_rows(cand, k)
        if trace is not None:
            near = top_k_rows(cand, k + 1)[0]
            trace.append((top_ix.cpu(),
                          (near[:, :-1] - near[:, 1:]).amin(dim=1).cpu()))
        flat = (rows + top_ix // v).reshape(-1)
        tok = (top_ix % v).reshape(-1)
        hh, cc = hh_n[flat], cc_n[flat]
        seqs = seqs[flat]
        seqs[:, t] = tok.to(torch.int32)
        done = done[flat] | (tok == eos_id)
        score = top_sc.reshape(-1)
    iseos = seqs == eos_id
    first_eos = torch.argmax(iseos.to(torch.uint8), dim=-1)
    lengths = torch.where(iseos.any(dim=-1), first_eos + 1.0,
                          float(max_len))
    lp = ((5.0 + lengths) / 6.0) ** length_penalty
    best = torch.argmax((score / lp).reshape(b, k), dim=-1)
    return seqs.reshape(b, k, max_len)[torch.arange(b, device=dev),
                                        best].cpu().numpy()
