"""paddle_tpu_torch's random bits held against paddle_tpu's, bit for bit.

* ``core/rng.prng_key`` / ``fold_in`` (threefry2x32 on Python integers)
  against ``jax.random.PRNGKey`` / ``fold_in``, and ``op_seed`` against
  the ``kd[0] ^ kd[-1]`` reduction of ``_rng_key``.
* The splitmix32 masks (tensor functions in int64) against the
  reference's uint32 ``_splitmix`` / ``_attn_keep_scale`` and against
  the ``dropout`` op's Mask output.
Everything here is an integer or a boolean: equality is exact.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu.core import registry as jax_registry
from paddle_tpu.ops.tensor_ops import _rng_key

import paddle_tpu_torch  # noqa: F401
from paddle_tpu_torch.core import registry as pt_registry
from paddle_tpu_torch.core import rng

# the module: the package re-exports a function of the same name
jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

SEEDS = [0, 1, 1000003 * 7 + 5]
STEPS = [0, 1, 12345]


def _key_words(key):
    return [int(w) for w in np.asarray(jax.random.key_data(key)).reshape(-1)]


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    assert list(rng.prng_key(seed)) == _key_words(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_and_op_seed_match_jax(seed, step):
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), np.int32(step))
    assert list(rng.fold_in(rng.prng_key(seed), step)) == _key_words(jkey)
    attrs = {"seed": seed, "__step__": np.int32(step)}
    kd = _key_words(_rng_key(attrs))
    assert rng.op_seed(attrs) == kd[0] ^ kd[-1]


@pytest.mark.parametrize("seed", SEEDS)
def test_op_seed_without_a_step(seed):
    kd = _key_words(_rng_key({"seed": seed}))
    assert rng.op_seed({"seed": seed}) == kd[0] ^ kd[-1]


def test_threefry_known_answer():
    """The Random123 known-answer vector for threefry2x32, 20 rounds."""
    assert rng.threefry2x32((0x13198A2E, 0x03707344),
                            (0x243F6A88, 0x85A308D3)) == \
        (0xC4923A9C, 0x483DF7A0)


def test_splitmix32_matches_reference_on_edge_values():
    xs = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0x9E3779B9,
                   123456789], np.uint32)
    want = np.asarray(jfa._splitmix(jnp.asarray(xs)))
    got = rng.splitmix32(torch.from_numpy(xs.astype(np.int64)))
    assert got.tolist() == [int(w) for w in want]


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5, 0.999999, 1.0])
def test_keep_threshold(rate):
    assert rng.keep_threshold(rate) == min(int(rate * 4294967296.0),
                                           4294967295)


@pytest.mark.parametrize("seed,rate,b,n,sq,sk", [
    (0, 0.1, 2, 2, 64, 64), (0xFFFFFFFF, 0.5, 1, 3, 17, 40),
    (2654435769, 0.25, 3, 1, 128, 128), (7, 0.9, 2, 4, 5, 300)])
def test_attention_keep_mask_matches_reference_bitwise(seed, rate, b, n, sq,
                                                       sk):
    want = np.asarray(jfa._attn_keep_scale(
        jnp.uint32(seed), rate, (b, n, sq, sk), 0, 0, n, sq, sk)) != 0
    got = rng.attn_keep(seed, rate, b, n, sq, sk, "cpu").numpy()
    assert got.shape == want.shape and np.array_equal(got, want)
    assert abs(got.mean() - (1 - rate)) < 0.05


@pytest.mark.parametrize("shape,p,seed,step", [
    ((4, 64, 128), 0.1, 1, 0), ((3, 7), 0.5, 7000026, 12345),
    ((1000,), 0.9, 3, 1), ((2, 3, 5, 7), 0.25, 49, 2)])
def test_dropout_op_mask_and_output_match_reference(shape, p, seed, step):
    x = np.random.RandomState(seed % 1000).randn(*shape).astype(np.float32)
    attrs = {"dropout_prob": p, "is_test": False, "seed": seed,
             "dropout_implementation": "upscale_in_train",
             "__step__": np.int32(step)}
    want = jax_registry.get("dropout").forward({"X": [x]}, dict(attrs))
    got = pt_registry.get("dropout").forward(
        {"X": [torch.from_numpy(x)]}, dict(attrs))
    assert got["Mask"].dtype == torch.uint8
    assert np.array_equal(got["Mask"].numpy(), np.asarray(want["Mask"]))
    np.testing.assert_allclose(got["Out"].numpy(), np.asarray(want["Out"]),
                               rtol=1e-6, atol=0)


def test_dropout_mask_changes_with_the_step_and_not_with_a_rerun():
    a = rng.dropout_keep((64, 64), rng.op_seed({"seed": 5, "__step__": 0}),
                         0.5, "cpu")
    b = rng.dropout_keep((64, 64), rng.op_seed({"seed": 5, "__step__": 1}),
                         0.5, "cpu")
    a2 = rng.dropout_keep((64, 64), rng.op_seed({"seed": 5, "__step__": 0}),
                          0.5, "cpu")
    assert torch.equal(a, a2) and not torch.equal(a, b)


def test_dropout_past_the_uint32_lattice_raises():
    with pytest.raises(NotImplementedError):
        rng.dropout_keep((1 << 16, 1 << 16), 1, 0.5, "meta")
