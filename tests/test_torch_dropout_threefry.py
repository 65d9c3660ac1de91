"""The dropout op's threefry branch (2^32 elements or more), on the CPU.

The reference's dropout switches from its splitmix lattice to
``jax.random.bernoulli(_rng_key(attrs), 1 - p, shape)`` at 2^32
elements (``paddle_tpu/ops/nn_ops.py:476-489``). The port's tensor code
(``core/rng.py`` ``threefry_bits_at``, ``threefry_keep``) is held bit for
bit against jax:

* the bits against ``jax.random.bits`` and the masks against
  ``jax.random.bernoulli``, under the reference's own ``_rng_key``, over
  several seeds, steps, shapes and rates, at any sample of positions and
  over index ranges cut into chunks;
* the op's key (``rng.op_key``) against ``jax.random.key_data``, op by
  op and from a compiled step's key table (``rng.key_values``);
* the dispatch: with the port's threshold constant ``THREEFRY_MIN``
  lowered (the only way to reach the branch at a CPU size), the dropout
  op's Mask equals the reference's bernoulli bit for bit and its Out the
  small path's expression on that mask (the reference's value in fp32;
  in bf16 jax divides by a bf16-rounded 1 - p), fp32 and bf16, both
  implementations, op by op and compiled; below the threshold the
  splitmix masks are unchanged by the key table.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.ops.tensor_ops import _rng_key

import paddle_tpu_torch as ptt
from paddle_tpu_torch import layers as players
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.core import registry as pt_registry
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.core import unique_name as pt_names
from paddle_tpu_torch.core.executor import Executor

torch.set_num_threads(2)

KEYS = [(0, 0), (7, 3), (12345, 0), (2 ** 31 - 1, 17), (99, 123456)]
SHAPES = [(5, 7), (3, 64, 33), (1000,)]


@pytest.mark.parametrize("seed,step", KEYS)
def test_op_key_is_the_reference_key(seed, step):
    attrs = {"seed": seed, "__step__": step}
    want = tuple(int(w) for w in np.asarray(
        jax.random.key_data(_rng_key(attrs))))
    assert rng.op_key(attrs) == want
    packed = torch.tensor(rng.key_values([seed], step)[0])
    k0, k1 = rng.op_key({"__key__": packed})
    assert (int(k0), int(k1)) == want


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed,step", KEYS)
def test_bits_and_masks_match_jax(seed, step, shape):
    attrs = {"seed": seed, "__step__": step}
    key = _rng_key(attrs)
    n = int(np.prod(shape))
    idx = torch.arange(n)
    bits = rng.threefry_bits_at(rng.op_key(attrs), idx).numpy()
    want = np.asarray(jax.random.bits(key, shape, jnp.uint32)).reshape(-1)
    np.testing.assert_array_equal(bits, want.astype(np.int64))
    for p in (0.1, 0.5, 0.9):
        keep = rng.threefry_keep(rng.op_key(attrs), p, 0, n, "cpu").numpy()
        want = np.asarray(jax.random.bernoulli(key, 1.0 - p, shape))
        np.testing.assert_array_equal(keep, want.reshape(-1))


def test_a_sample_and_chunked_ranges_give_the_full_mask(monkeypatch):
    attrs = {"seed": 3, "__step__": 8}
    shape = (37, 101)
    n = 37 * 101
    want = np.asarray(jax.random.bernoulli(_rng_key(attrs), 0.7,
                                           shape)).reshape(-1)
    monkeypatch.setattr(rng, "THREEFRY_CHUNK", 256)
    key = rng.op_key(attrs)
    for start, stop in ((0, n), (1, 999), (n - 300, n)):
        np.testing.assert_array_equal(
            rng.threefry_keep(key, 0.3, start, stop, "cpu").numpy(),
            want[start:stop])
    sample = torch.tensor(sorted({0, n - 1, *np.random.RandomState(0)
                                  .randint(0, n, 300).tolist()}))
    got = (rng.threefry_bits_at(key, sample) >> 9) < rng.keep_below(0.3)
    np.testing.assert_array_equal(got.numpy(), want[sample.numpy()])


def test_bits_past_2_32_use_the_high_word():
    """Positions past 2^32 take their high word as threefry's first
    counter word: the bits of 2^32 + i are those of the pair (1, i)."""
    key = rng.op_key({"seed": 5, "__step__": 1})
    i = torch.arange(8)
    a = rng.threefry_bits_at(key, i + (1 << 32))
    b0, b1 = rng.threefry2x32_t(key, torch.ones_like(i), i)
    assert torch.equal(a, b0 ^ b1)
    for j in range(8):
        x0, x1 = rng.threefry2x32(key, (1, j))
        assert int(a[j]) == x0 ^ x1
    assert not torch.equal(a, rng.threefry_bits_at(key, i))


def _x(shape, dtype):
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    if dtype == "bfloat16":
        return x.astype(ml_dtypes.bfloat16)
    return x


def _t(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


@pytest.mark.parametrize("impl", ["upscale_in_train", "downgrade_in_infer"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_op_takes_the_threefry_branch(monkeypatch, dtype, impl):
    monkeypatch.setattr(rng, "THREEFRY_MIN", 64)
    monkeypatch.setattr(rng, "THREEFRY_CHUNK", 100)
    shape, p = (6, 50), 0.3
    attrs = {"dropout_prob": p, "seed": 21, "__step__": 4,
             "dropout_implementation": impl}
    x = _x(shape, dtype)
    before = rng.threefry_masks
    out = pt_registry.get("dropout").forward({"X": [_t(x)]}, dict(attrs))
    assert rng.threefry_masks == before + 1
    keep = np.asarray(jax.random.bernoulli(_rng_key(attrs), 1.0 - p, shape))
    np.testing.assert_array_equal(out["Mask"].numpy(), keep.astype(np.uint8))
    # Out: the small path's expression on that mask. In fp32 that is the
    # reference's value too; in bf16 jax divides by 1 - p rounded to bf16
    # (a weakly typed scalar), torch by 1 - p itself, on either path
    xt = _t(x)
    kept = xt / (1.0 - p) if impl == "upscale_in_train" else xt
    want = torch.where(torch.from_numpy(keep), kept, torch.zeros_like(kept))
    assert torch.equal(out["Out"], want)
    if dtype == "float32":
        xj = jnp.asarray(x)
        kept = xj / (1.0 - p) if impl == "upscale_in_train" else xj
        np.testing.assert_array_equal(
            out["Out"].numpy(), np.asarray(jnp.where(keep, kept, 0.0)))


def test_below_the_threshold_the_splitmix_mask_is_kept():
    attrs = {"dropout_prob": 0.4, "seed": 9, "__step__": 2}
    x = torch.ones(8, 32)
    out = pt_registry.get("dropout").forward({"X": [x]}, dict(attrs))
    keep = rng.dropout_keep((8, 32), rng.op_seed(attrs), 0.4, "cpu")
    assert torch.equal(out["Mask"].bool(), keep)


def _program():
    with pt_names.guard():
        main, startup = ptt.Program(), ptt.Program()
        with ptt.program_guard(main, startup):
            x = players.data("x", [40])
            h = players.fc(x, 40)
            d = players.dropout(h, 0.25,
                                dropout_implementation="upscale_in_train")
            loss = players.mean(d * d)
            popt.SGDOptimizer(0.1).minimize(loss)
    mask = next(o.outputs["Mask"][0] for o in main.global_block().ops
                if o.type == "dropout")
    return main, startup, [loss.name, mask]


def test_compiled_threefry_masks_equal_op_by_op(monkeypatch):
    """A program whose dropout takes the threefry branch: the compiled
    step (its key table) equals the op-by-op run bit for bit, masks,
    losses and weights, and each step's mask is the reference's
    bernoulli under that step's key."""
    monkeypatch.setattr(rng, "THREEFRY_MIN", 64)
    main, startup, fetch = _program()
    seed = next(o.attrs["seed"] for o in main.global_block().ops
                if o.type == "dropout")
    exe = Executor(device="cpu")
    runs = []
    for use_compiled in (False, True):
        scope = ptt.Scope()
        exe.run(startup, scope=scope)
        x = np.random.RandomState(1).randn(4, 40).astype(np.float32)
        rows = []
        for _ in range(4):
            step = int(scope.find_var("@STEP_COUNTER@"))
            rows.append((step, exe.run(main, feed={"x": x},
                                       fetch_list=fetch, scope=scope,
                                       use_compiled=use_compiled)))
        runs.append((rows, scope))
    (a, sa), (b, sb) = runs
    for (step, ra), (_, rb) in zip(a, b):
        for u, v in zip(ra, rb):
            assert np.array_equal(u, v)
        want = np.asarray(jax.random.bernoulli(
            _rng_key({"seed": seed, "__step__": step}), 0.75, (4, 40)))
        np.testing.assert_array_equal(rb[1], want.astype(np.uint8))
    for n, t in sa.items():
        if isinstance(t, torch.Tensor):
            assert torch.equal(t, sb.find_var(n)), n


def test_the_splitmix_lattice_still_refuses_2_32():
    with pytest.raises(NotImplementedError, match="threefry"):
        rng.dropout_keep((1 << 16, 1 << 16), 1, 0.5, "meta")
