"""The bf16 tensor-core instances of the flash kernels, from the CPU.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Here:

* the alignment rule of their 16-byte copies: ``_stride_array`` takes a
  bf16 view whose strides are multiples of 8 elements and raises on one
  of 4 (which the fp32 instance still takes) or on an address off 16
  bytes;
* the launch split by dtype instance, and its reset;
* the build hash covers the shared header ``csrc/flash_tc.cuh``, so an
  edited header never loads a stale library;
* the sources route bf16 only to the tensor-core instances;
* a plain model of the forward kernel's tiled arithmetic (64-key tiles,
  the online softmax in log2 units, p rounded to bf16 per tile before p v,
  the empty-row sentinel) against the TPU kernel it replaces,
  ``_packed_fwd_kernel`` in Pallas interpret mode, in bf16 within the
  plain version's tolerance (2e-2), and against the plain version.
"""

import importlib
import math
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch import kernels
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as fa

jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

torch.set_num_threads(2)

B, N, HD = 2, 2, 64


def _strides(t, layout="bnsd", hd=HD):
    return list(fa._stride_array("flash forward", hd, layout, (("q", t),)))


@pytest.mark.parametrize("pad", [8, 16, 64])
def test_bf16_views_with_8_element_strides_pass(pad):
    buf = torch.zeros(B, N, 96, HD + pad, dtype=torch.bfloat16)
    view = buf[..., :HD]
    assert not view.is_contiguous()
    assert _strides(view) == [N * 96 * (HD + pad), HD + pad, 96 * (HD + pad)]


@pytest.mark.parametrize("pad", [4, 12, 2])
def test_bf16_views_off_8_element_strides_raise(pad):
    view = torch.zeros(B, N, 96, HD + pad, dtype=torch.bfloat16)[..., :HD]
    with pytest.raises(ValueError, match="multiple of 8 elements"):
        _strides(view)


def test_fp32_keeps_the_4_element_rule():
    view = torch.zeros(B, N, 96, HD + 4)[..., :HD]
    assert _strides(view)[1] == HD + 4
    with pytest.raises(ValueError, match="multiple of 4 elements"):
        _strides(torch.zeros(B, N, 96, HD + 2)[..., :HD])


def test_bf16_packed_column_slices_and_addresses():
    # q/k/v as column slices of one fused [B,S,3*n*hd] projection: the
    # slices start 16-byte aligned and keep the fused row stride
    w = N * HD
    fused = torch.zeros(B, 80, 3 * w, dtype=torch.bfloat16)
    for i in range(3):
        assert _strides(fused[..., i * w:(i + 1) * w], "packed") == \
            [80 * 3 * w, 3 * w, HD]
    # an address 8 bytes past a 16-byte boundary raises
    flat = torch.zeros(B * N * 96 * HD + 8, dtype=torch.bfloat16)
    off = flat[4:4 + B * N * 96 * HD].reshape(B, N, 96, HD)
    assert off.data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="16-byte"):
        _strides(off)


def test_launches_are_split_by_dtype_instance_and_reset():
    assert fa.INSTANCES == ("fp32_cuda_cores", "bf16_wgmma")
    fa.launches_by_dtype["bf16_wgmma"] = 3
    fa.bwd_launches_by_dtype["fp32_cuda_cores"] = 2
    assert kernels.dtype_counts() == {
        "flash_attention_fwd": {"fp32_cuda_cores": 0, "bf16_wgmma": 3},
        "flash_attention_bwd": {"fp32_cuda_cores": 2, "bf16_wgmma": 0}}
    kernels.reset_launch_counts()
    assert kernels.dtype_counts() == {
        k: dict.fromkeys(fa.INSTANCES, 0)
        for k in ("flash_attention_fwd", "flash_attention_bwd")}
    # the CPU route runs the plain versions and counts no launch
    q = torch.randn(1, 64, N * HD).bfloat16()
    fa.flash_fwd(q, q, q, N, 0.125, True)
    assert kernels.dtype_counts()["flash_attention_fwd"]["bf16_wgmma"] == 0


def test_build_hash_covers_the_shared_header(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.lib_path(n) for n in _build.SOURCES}
    (csrc / "flash_tc.cuh").write_text(
        (csrc / "flash_tc.cuh").read_text() + "\n// edited\n")
    after = {n: _build.lib_path(n) for n in _build.SOURCES}
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        assert before[name] != after[name], name


def test_sources_route_bf16_only_to_the_tensor_core_instances():
    header = (_build.CSRC / "flash_tc.cuh").read_text()
    assert "wgmma.mma_async.sync.aligned" in header
    for name, kernels_ in (("flash_attention_fwd", ("flash_fwd_tc",)),
                           ("flash_attention_bwd", ("dkv_tc", "dq_tc"))):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "flash_tc.cuh"' in src
        assert "launch<HD, bf16" not in src and "PT_BWD(bf16" not in src
        assert "launch_tc<HD, true>" in src and "launch_tc<HD, false>" in src
        for k in kernels_:
            assert f"{k}<HD, DROP>" in src


LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def _tiled_forward_model(q, k, v, scale, causal, bias, rate, seed, bn=64):
    """The bf16 forward kernel's arithmetic over [B,n,S,hd] heads: scores
    in log2 units, the online softmax over key tiles of ``bn``, dropout
    after the row sum, p rounded to bf16 per tile before p v."""
    b, n, sq, _ = q.shape
    sk = k.shape[2]
    s2 = torch.matmul(q.float(), k.float().transpose(-1, -2)) * \
        (scale * LOG2E)
    if bias is not None:
        s2 = s2 + (bias.float() * LOG2E).reshape(b, 1, 1, sk)
    if causal:
        rows = torch.arange(sq)[:, None] + (sk - sq)
        s2 = s2.masked_fill(torch.arange(sk)[None, :] > rows, float("-inf"))
    mult = None
    if rate:
        mult = rng.attn_keep(seed, rate, b, n, sq, sk, q.device).float() / \
            (1.0 - rate)
    m = torch.full((b, n, sq, 1), fa.NEG_INF)
    l = torch.zeros(b, n, sq, 1)
    o = torch.zeros(b, n, sq, q.shape[-1])
    for k0 in range(0, sk, bn):
        x = s2[..., k0:k0 + bn]
        mx = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2(m - mx)
        p = torch.exp2(x - mx)
        l = l * alpha + p.sum(-1, keepdim=True)
        if mult is not None:
            p = p * mult[..., k0:k0 + bn]
        o = o * alpha + torch.matmul(p.bfloat16().float(),
                                     v[:, :, k0:k0 + bn].float())
        m = mx
    out = (o / torch.where(l == 0, 1.0, l)).bfloat16()
    lse = torch.where(l == 0, fa.NEG_INF + math.log(1e-30),
                      m * LN2 + torch.log(l.clamp_min(1e-30))).squeeze(-1)
    return out, lse


def _bits(x):
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.uint16).view(np.int16).copy()) \
            .view(torch.bfloat16)
    return torch.from_numpy(x.copy())


@pytest.mark.parametrize("s,bias,causal,rate", [
    (128, True, False, 0.1), (128, False, True, 0.0), (128, True, True, 0.1),
    (64, False, False, 0.0)])
def test_tiled_model_matches_the_tpu_kernel_in_bf16(s, bias, causal, rate):
    r = np.random.RandomState(s + causal)
    q, k, v = (jnp.asarray(r.randn(B, s, N * HD).astype(np.float32),
                           jnp.bfloat16) for _ in range(3))
    kb = np.where(r.rand(B, s) < 0.25, -1e4, 0.0).astype(np.float32) \
        if bias else None
    seed, scale = 0x51ED, HD ** -0.5
    want_o, want_lse = jfa._fwd_pallas_packed(
        q, k, v, None if kb is None else jnp.asarray(kb), causal, scale,
        True, jnp.uint32(seed), rate, N)
    heads = [fa._heads(_bits(t), N, "packed") for t in (q, k, v)]
    tb = None if kb is None else torch.from_numpy(kb)
    out, lse = _tiled_forward_model(*heads, scale, causal, tb, rate, seed)
    np.testing.assert_allclose(fa._unheads(out, "packed").float().numpy(),
                               np.asarray(want_o, np.float32), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=1e-5,
                               atol=1e-5)
    plain_o, plain_lse = fa.plain_flash_fwd(*heads, None, scale, causal, tb,
                                            rate, seed, layout="bnsd")
    torch.testing.assert_close(out.float(), plain_o.float(), rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(lse, plain_lse, rtol=1e-5, atol=1e-5)


def test_tiled_model_keeps_the_empty_row_sentinel():
    # causal with Sq > Sk, bottom-right aligned: the first Sq - Sk rows see
    # no key; out 0 and lse NEG_INF + log(1e-30) in both versions
    r = np.random.RandomState(3)
    q = torch.from_numpy(r.randn(1, 2, 150, HD).astype(np.float32)).bfloat16()
    k, v = (torch.from_numpy(r.randn(1, 2, 70, HD).astype(np.float32))
            .bfloat16() for _ in range(2))
    out, lse = _tiled_forward_model(q, k, v, 0.125, True, None, 0.1, 5)
    plain_o, plain_lse = fa.plain_flash_fwd(q, k, v, None, 0.125, True, None,
                                            0.1, 5, layout="bnsd")
    assert torch.equal(out[:, :, :80], torch.zeros_like(out[:, :, :80]))
    assert torch.equal(lse[:, :, :80], plain_lse[:, :, :80])
    torch.testing.assert_close(out.float(), plain_o.float(), rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(lse, plain_lse, rtol=1e-5, atol=1e-5)
