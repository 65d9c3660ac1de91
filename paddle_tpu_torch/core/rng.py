"""Random bits of the port: the reference's generators, bit for bit.

Two generators decide every random number of a training step in the
reference, and the port reproduces both so that a program trains to the
same masks in either package:

* the per-op **seed**: ``_rng_key`` (``paddle_tpu/ops/tensor_ops.py:22``)
  builds ``jax.random.PRNGKey(op seed)``, folds in the global step, and
  the dropout ops reduce the key to one uint32, ``kd[0] ^ kd[-1]``.
  ``PRNGKey`` and ``fold_in`` are threefry2x32 on two words: done here on
  the host in Python integers (``op_seed``). The mesh-axis folds (``dp``,
  ``sp``) apply inside a sharded run only and are not in the port.
* the **mask**: a splitmix32 hash of the element's lattice index xor the
  seed (``paddle_tpu/ops/pallas/flash_attention.py:49-74``), compared
  with ``rate * 2^32``. Done here on tensors. torch has no uint32
  arithmetic, so values live in int64 and are cut to their low 32 bits
  after every multiply (a wrapped int64 product keeps the right low
  bits) and are never negative before a shift.

The CUDA kernels carry the same splitmix32 in uint32
(``csrc/flash_attention_fwd.cu``, ``csrc/flash_attention_bwd.cu``).

The splitmix lattice is a uint32 element index, so it would alias past
2^32 elements. There the reference's dropout takes
``jax.random.bernoulli(key, 1 - p, shape)`` instead
(``paddle_tpu/ops/nn_ops.py:476-489``), and so does the port's
(``THREEFRY_MIN``, ``threefry_keep``): threefry2x32 under the op's full
two-word key over the element's 64-bit flat index (hi, lo), as this
jax's partitionable threefry draws bits, the two output words xored,
the top 23 bits made a uniform float in [0, 1), kept where it is below
float32(1 - p). It is computed in chunks of the flat index, so its
temporaries stay a bounded size whatever the tensor's.

A compiled step (``core/executor.py``, a CUDA graph on the card) cannot
take a new host integer each step, so the seed also has a device form:
the executor keeps a **seed table**, one int64 slot per random op of the
program, those of its sub-blocks included (``seed_slots``), fills it
before each step from ``op_seed`` with the step folded in
(``seed_values``) and binds each op's slot, a 0-d tensor, as its
``__seed__`` attr. ``op_seed`` returns that tensor when it
is bound; ``dropout_keep`` and ``attn_keep`` take the seed as an int or as
such a tensor and draw the same bits from either. The same step fills a
second table beside it with each slot's full key (``key_values``: the
two words packed in one int64), bound as ``__key__``, which
``op_key`` returns and the threefry branch reads; the first table, and
so every splitmix mask, is unchanged by it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple, Union

import torch

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(key: Tuple[int, int], x: Tuple[int, int]) -> Tuple[int, int]:
    """One threefry2x32 block (20 rounds) on Python integers."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ 0x1BD11BDA)
    x0 = (x[0] + ks[0]) & M32
    x1 = (x[1] + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)``: the seed's high and low words."""
    seed = int(seed)
    return (seed >> 32) & M32, seed & M32


def fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    """``jax.random.fold_in(key, data)`` for a 32-bit ``data``."""
    return threefry2x32(key, (0, int(data) & M32))


Seed = Union[int, torch.Tensor]


def op_key(attrs):
    """The full threefry key (k0, k1) of a random op in this run: the
    op's ``seed`` attr as ``PRNGKey``, the ``__step__`` folded in, as
    Python integers; or, where the executor bound the op's slot of its
    key table (``__key__``, a 0-d int64 tensor holding ``pack_key`` of
    that key), the two words as 0-d tensors read from it."""
    bound = attrs.get("__key__")
    if bound is not None:
        return (bound >> 32) & M32, bound & M32
    key = prng_key(int(attrs.get("seed", 0) or 0))
    step = attrs.get("__step__")
    if step is not None:
        key = fold_in(key, int(step))
    return key


def pack_key(key: Tuple[int, int]) -> int:
    """(k0, k1) as one signed int64: k0 the high word."""
    v = (int(key[0]) << 32) | int(key[1])
    return v - (1 << 64) if v >= (1 << 63) else v


def op_seed(attrs) -> Seed:
    """The uint32 seed of a random op in this run: the op's build-time
    ``seed`` attr, the runtime ``__step__`` folded in, reduced as the
    reference's dropout ops reduce their key. Where the executor bound
    the op's slot of its seed table (``__seed__``, a 0-d int64 tensor
    holding that same value), the slot."""
    bound = attrs.get("__seed__")
    if bound is not None:
        return bound
    key = prng_key(int(attrs.get("seed", 0) or 0))
    step = attrs.get("__step__")
    if step is not None:
        key = fold_in(key, int(step))
    return key[0] ^ key[1]


def _run_attrs(op):
    """The attrs of what a run of ``op`` runs: its own, or for a
    ``__vjp_grad__`` those of the forward it recomputes."""
    return op.attrs.get("fwd_attrs") or {} \
        if op.type == "__vjp_grad__" else op.attrs


def sub_blocks(op) -> list:
    """The blocks a run of ``op`` runs: its Block-valued attrs (a
    ``block_call``'s ``sub_block``, also when a ``__vjp_grad__``
    recomputes the call)."""
    from .ir import Block

    return [v for v in _run_attrs(op).values() if isinstance(v, Block)]


def seed_slots(ops) -> List[Tuple[object, int]]:
    """(key, seed attr) of every random op that a run of ``ops`` runs:
    one slot of the seed table each. An op draws random bits iff it
    carries a ``seed`` attr (dropout, flash_attention with dropout,
    flash_attention_grad, the random initializers), and a
    ``__vjp_grad__`` op iff the forward it recomputes does. The key of
    ``ops[i]`` is ``i``; the key of an op of a sub-block (a
    ``block_call``'s, reached from the call or from the ``__vjp_grad__``
    that recomputes it) is that OpDesc itself, so a call and its
    recompute bind the same slot and draw the same bits."""
    out: List[Tuple[object, int]] = []
    seen: set = set()

    def walk(op):
        for blk in sub_blocks(op):
            for sub in blk.ops:
                if id(sub) in seen:
                    continue
                seen.add(id(sub))
                attrs = _run_attrs(sub)
                if "seed" in attrs:
                    out.append((sub, int(attrs["seed"] or 0)))
                walk(sub)

    for i, op in enumerate(ops):
        attrs = _run_attrs(op)
        if "seed" in attrs:
            out.append((i, int(attrs["seed"] or 0)))
        walk(op)
    return out


def _unseeded(op) -> bool:
    """Whether ``op`` draws random bits without a ``seed`` attr: a
    dropout, or an op with ``dropout_prob`` > 0, not in test mode (or a
    ``__vjp_grad__`` recomputing one); a ``fusion_group`` holding such a
    dropout (its sub-ops' seeds have no slot of their own); an op whose
    sub-blocks hold such an op."""
    if op.type == "fusion_group":
        return any(sub["type"] == "dropout"
                   and not sub["attrs"].get("is_test")
                   and float(sub["attrs"].get("dropout_prob", 0.0)
                             or 0.0) > 0
                   for sub in op.attrs.get("sub_ops") or ())
    if any(_unseeded(sub) for blk in sub_blocks(op) for sub in blk.ops):
        return True
    attrs = _run_attrs(op)
    kind = op.attrs.get("fwd_type") if op.type == "__vjp_grad__" \
        else op.type
    if "seed" in attrs or attrs.get("is_test"):
        return False
    return kind == "dropout" or float(attrs.get("dropout_prob", 0.0)
                                      or 0.0) > 0


def unseeded_random_ops(ops) -> List[int]:
    """Indices of the ops of ``ops`` that draw random bits, themselves or
    in a sub-block they run, through an op that carries no ``seed`` attr
    (``_unseeded``). Op by op such an op still gets a new seed each step
    (the step folded into seed 0); a compiled step has no slot for it and
    would replay one mask."""
    return [i for i, op in enumerate(ops) if _unseeded(op)]


def seed_values(seeds, step: int) -> List[int]:
    """The seed table's values at ``step``: ``op_seed`` of each seed attr
    with the step folded in (each distinct seed computed once)."""
    done: Dict[int, int] = {}
    for s in seeds:
        if s not in done:
            done[s] = op_seed({"seed": s, "__step__": step})
    return [done[s] for s in seeds]


def key_values(seeds, step: int) -> List[int]:
    """The key table's values at ``step``: ``pack_key`` of each seed
    attr's key with the step folded in."""
    done: Dict[int, int] = {}
    for s in seeds:
        if s not in done:
            done[s] = pack_key(op_key({"seed": s, "__step__": step}))
    return [done[s] for s in seeds]


def _golden(seed: Seed):
    """seed * GOLDEN in uint32, for an int or an int tensor seed (an
    int64 product that wraps keeps the right low 32 bits)."""
    if isinstance(seed, torch.Tensor):
        return (seed.long() * GOLDEN) & M32
    return (int(seed) * GOLDEN) & M32


def keep_threshold(rate: float) -> int:
    """Drop iff hash < rate * 2^32 (uint32 compare); computed on the
    host in double and passed to the kernels as an integer, so host and
    device cannot round it differently."""
    return min(int(float(rate) * 4294967296.0), M32)


def splitmix32(x: torch.Tensor) -> torch.Tensor:
    """splitmix32 finalizer over an int64 tensor of uint32 values."""
    x = ((x ^ (x >> 16)) * 0x85EBCA6B) & M32
    x = ((x ^ (x >> 13)) * 0xC2B2AE35) & M32
    return x ^ (x >> 16)


def dropout_keep(shape, seed: Seed, rate: float, device) -> torch.Tensor:
    """bool keep mask of the ``dropout`` op over ``shape``: element i of
    the flattened tensor is kept iff splitmix32(i ^ seed * GOLDEN) >=
    threshold. ``seed`` is an int or a 0-d int tensor on ``device``."""
    n = 1
    for d in shape:
        n *= int(d)
    if n >= THREEFRY_MIN:
        raise NotImplementedError(
            "the splitmix lattice is uint32: dropout over 2^32 or more "
            "elements takes the threefry branch (threefry_keep)")
    lin = torch.arange(n, dtype=torch.int64, device=device)
    h = splitmix32(lin ^ _golden(seed))
    return (h >= keep_threshold(rate)).reshape(tuple(shape))


def attn_keep(seed: Seed, rate: float, b: int, n: int, sq: int, sk: int,
              device) -> torch.Tensor:
    """bool keep mask [b, n, sq, sk] of attention-probs dropout: keyed
    on (b * n + h, q, k) through a per-(b, h) seed and the q * Sk + k
    lattice (``_attn_keep_scale``). ``seed`` is an int or a 0-d int
    tensor on ``device``."""
    bh = torch.arange(b * n, dtype=torch.int64, device=device)
    seed2 = splitmix32(bh ^ _golden(seed))   # per (b, h)
    qi = torch.arange(sq, dtype=torch.int64, device=device)
    ki = torch.arange(sk, dtype=torch.int64, device=device)
    lin = (qi[:, None] * sk + ki[None, :]) & M32
    x = splitmix32(lin[None] ^ ((seed2 * GOLDEN) & M32)[:, None, None])
    return (x >= keep_threshold(rate)).reshape(b, n, sq, sk)


# the element count from which the dropout op draws threefry bits
THREEFRY_MIN = 1 << 32
# elements a chunk of ``threefry_keep`` handles: its int64 temporaries
# are a few times 8 bytes each of these
THREEFRY_CHUNK = 1 << 26
# dropout ops that took the threefry branch since the last reset
threefry_masks = 0


def _rotl_t(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32_t(key, x0: torch.Tensor, x1: torch.Tensor):
    """``threefry2x32`` over int64 tensors of uint32 values: the two
    output words of the block for every (x0, x1). key words are ints or
    0-d int64 tensors."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl_t(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def threefry_bits_at(key, idx: torch.Tensor) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32, partitionable threefry)
    at the flat positions ``idx`` (int64) of any shape: threefry2x32 of
    (idx >> 32, idx & M32) under key, the two words xored. int64 values
    in [0, 2^32)."""
    b0, b1 = threefry2x32_t(key, idx >> 32, idx & M32)
    return b0 ^ b1


def keep_below(rate: float) -> int:
    """Keep iff bits >> 9 < this: ``jax.random.uniform`` makes the float
    (bits >> 9) * 2^-23 exactly, and bernoulli keeps it where it is below
    float32(1 - rate); that is the integer compare with
    ceil(float32(1 - rate) * 2^23)."""
    import math

    import numpy as np

    return int(math.ceil(float(np.float32(1.0 - float(rate))) * (1 << 23)))


def threefry_keep(key, rate: float, start: int, stop: int, device
                  ) -> torch.Tensor:
    """bool keep mask of ``jax.random.bernoulli(key, 1 - rate, shape)``
    over the flat positions [start, stop) of the shape, computed in
    chunks of ``THREEFRY_CHUNK`` positions. key words are ints or 0-d
    int64 tensors on ``device``."""
    out = torch.empty(stop - start, dtype=torch.bool, device=device)
    below = keep_below(rate)
    for lo in range(start, stop, THREEFRY_CHUNK):
        hi = min(lo + THREEFRY_CHUNK, stop)
        idx = torch.arange(lo, hi, dtype=torch.int64, device=device)
        out[lo - start:hi - start] = (threefry_bits_at(key, idx) >> 9) \
            < below
    return out
