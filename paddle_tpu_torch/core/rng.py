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
"""

from __future__ import annotations

from typing import Tuple

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


def op_seed(attrs) -> int:
    """The uint32 seed of a random op in this run: the op's build-time
    ``seed`` attr, the runtime ``__step__`` folded in, reduced as the
    reference's dropout ops reduce their key."""
    key = prng_key(int(attrs.get("seed", 0) or 0))
    step = attrs.get("__step__")
    if step is not None:
        key = fold_in(key, int(step))
    return key[0] ^ key[1]


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


def dropout_keep(shape, seed: int, rate: float, device) -> torch.Tensor:
    """bool keep mask of the ``dropout`` op over ``shape``: element i of
    the flattened tensor is kept iff splitmix32(i ^ seed * GOLDEN) >=
    threshold."""
    n = 1
    for d in shape:
        n *= int(d)
    if n >= (1 << 32):
        raise NotImplementedError(
            "dropout over 2^32 or more elements takes the reference's "
            "threefry branch, which the port does not carry")
    lin = torch.arange(n, dtype=torch.int64, device=device)
    h = splitmix32(lin ^ ((int(seed) * GOLDEN) & M32))
    return (h >= keep_threshold(rate)).reshape(tuple(shape))


def attn_keep(seed: int, rate: float, b: int, n: int, sq: int, sk: int,
              device) -> torch.Tensor:
    """bool keep mask [b, n, sq, sk] of attention-probs dropout: keyed
    on (b * n + h, q, k) through a per-(b, h) seed and the q * Sk + k
    lattice (``_attn_keep_scale``)."""
    bh = torch.arange(b * n, dtype=torch.int64, device=device)
    seed2 = splitmix32(bh ^ ((int(seed) * GOLDEN) & M32))   # per (b, h)
    qi = torch.arange(sq, dtype=torch.int64, device=device)
    ki = torch.arange(sk, dtype=torch.int64, device=device)
    lin = (qi[:, None] * sk + ki[None, :]) & M32
    x = splitmix32(lin[None] ^ ((seed2 * GOLDEN) & M32)[:, None, None])
    return (x >= keep_threshold(rate)).reshape(b, n, sq, sk)
