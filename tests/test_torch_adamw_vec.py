"""The AdamW kernel's wrapper on the CPU.

* ``split``: the kernel updates a scalar head, a body of 16-byte vectors
  and a scalar tail; at odd lengths and element offsets of each stream the
  three cover every element exactly once, and every body vector starts on
  a 16-byte boundary in param, grad and both moments.
* The ``adamw`` op's lowering, whose one launch on the card also advances
  Beta1Pow and Beta2Pow, against the reference's ``adamw`` op over three
  steps: ParamOut and the moments within 1e-6, Beta1PowOut and
  Beta2PowOut bit for bit, fp32 and bf16 params (the reference through
  its fused Pallas kernel in interpret mode, ``PT_FUSED_ADAMW``; for fp32
  also through its unfused route).
* The wrapper advances the powers on every call, after the update has
  read them, even with nothing to update.

Everything on the CPU runs the plain version; the kernel itself runs in
tests/test_torch_cuda.py.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu.core import registry as jax_registry

from paddle_tpu_torch.core import registry as pt_registry
from paddle_tpu_torch.kernels import fused_adam as fad

torch.set_num_threads(2)


def _covered(numel, head, nvec, vec):
    """Element index -> how many times the kernel's three loops take it."""
    hits = np.zeros(numel, np.int64)
    hits[:head] += 1                                  # scalar head
    body = head + np.arange(nvec * vec)
    np.add.at(hits, body, 1)                          # 16-byte vectors
    hits[head + nvec * vec:] += 1                     # scalar tail
    return hits


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_covers_every_element_once(dtype):
    esz = 4 if dtype == torch.float32 else 2
    vec = fad.VEC[dtype]
    base = 1 << 20     # a 16-byte aligned address
    for numel in (0, 1, 3, 7, 8, 9, 31, 1000 * 33 + 5, 4096):
        for off in range(vec):             # param's (and grad's) offset
            for moff in (0, 1, 2, 3):       # the moments' own offset
                addrs = (base + off * esz, base + 64 + off * esz,
                         base + 128 + moff * 4, base + 256 + moff * 4)
                head, nvec = fad.split(numel, esz, vec, *addrs)
                assert (_covered(numel, head, nvec, vec) == 1).all()
                if nvec:
                    # every stream 16-byte aligned where the body starts
                    assert all((a + head * s) % 16 == 0 for a, s in zip(
                        addrs, (esz, esz, 4, 4)))
                    assert head < vec and numel - head - nvec * vec < vec
                # where every stream reaches a 16-byte boundary at p's
                # first one, only a short length leaves no body
                lead = (-addrs[0] % 16) // esz
                if numel - lead >= vec and all(
                        (a + lead * s) % 16 == 0
                        for a, s in zip(addrs, (esz, esz, 4, 4))):
                    assert (head, nvec) == (lead, (numel - lead) // vec)
    # grad on a different 16-byte phase than param: all scalar, once each
    head, nvec = fad.split(100, esz, vec, base, base + esz, base, base)
    assert (head, nvec) == (100, 0)


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.float().numpy().astype(ml_dtypes.bfloat16)
    return t.numpy()


# the reference's unfused route rounds a bf16 param twice (adam, then the
# decay), the port's kernel once, as the fused route does: bf16 takes the
# fused route only
@pytest.mark.parametrize("pdt,route", [(torch.float32, "fused"),
                                       (torch.float32, "unfused"),
                                       (torch.bfloat16, "fused")])
def test_adamw_op_matches_reference_over_three_steps(pdt, route,
                                                     monkeypatch):
    if route == "fused":
        monkeypatch.setenv("PT_PALLAS", "interpret")
        monkeypatch.setenv("PT_FUSED_ADAMW", "1")
    rng = np.random.RandomState(11)
    shape = (33, 71)
    p = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(pdt)
    state = {"Param": p,
             "LearningRate": torch.tensor([1e-2]),
             "Moment1": torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                         * 0.01),
             "Moment2": torch.from_numpy(rng.rand(*shape).astype(np.float32)
                                         * 1e-3),
             "Beta1Pow": torch.tensor([0.9 ** 4]),
             "Beta2Pow": torch.tensor([0.999 ** 4])}
    ref = {k: _np(v.clone()) for k, v in state.items()}
    attrs = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8, "coeff": 0.01,
             "with_decay": True, "lazy_mode": False}
    for step in range(3):
        g = torch.from_numpy(rng.randn(*shape).astype(np.float32)
                             * 0.1).to(pdt)
        got = pt_registry.get("adamw").forward(
            {**{k: [v] for k, v in state.items()}, "Grad": [g]},
            dict(attrs))
        want = jax_registry.get("adamw").forward(
            {**{k: [v] for k, v in ref.items()}, "Grad": [_np(g)]},
            dict(attrs))
        for slot in ("Param", "Moment1", "Moment2", "Beta1Pow", "Beta2Pow"):
            out = got[slot + "Out"]
            assert out is state[slot]        # updated in place
            w = np.asarray(want[slot + "Out"]).astype(np.float32)
            o = out.float().numpy()
            if slot.startswith("Beta"):
                assert o.tobytes() == w.tobytes(), (step, slot)
            else:
                np.testing.assert_allclose(o, w, rtol=1e-6, atol=1e-6,
                                           err_msg=f"step {step} {slot}")
            ref[slot] = np.asarray(want[slot + "Out"])


@pytest.mark.parametrize("numel", [0, 1, 1000 * 33 + 5])
def test_wrapper_advances_the_powers_after_the_update_reads_them(numel):
    """Every call advances b1^t and b2^t in place (one fp32 multiply
    each), after the update has read them, also with nothing to update:
    the route the card's one launch takes."""
    rng = np.random.RandomState(numel)
    p, g, m, v = (torch.from_numpy(rng.rand(numel).astype(np.float32))
                  for _ in range(4))
    lr = torch.tensor([1e-2])
    pows = [torch.tensor([0.9 ** 7]), torch.tensor([0.999 ** 7])]
    want = fad.plain_fused_adamw(p, g, m, v, lr, 0.9, 0.999, 1e-8, 0.01,
                                 *pows)
    before = [t.clone() for t in pows]
    fad.fused_adamw_(p, g, m, v, lr, 0.9, 0.999, 1e-8, 0.01, *pows)
    for got, w in zip((p, m, v), want):
        assert torch.equal(got, w)
    for got, b, f in zip(pows, before, (0.9, 0.999)):
        assert got.numpy().tobytes() == (b * f).numpy().tobytes()
        assert got.numpy().tobytes() == np.float32(
            b.numpy()[0] * np.float32(f)).tobytes()
