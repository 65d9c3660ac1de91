"""AnalysisPredictor against the reference's, on the CPU.

* A BERT-tiny inference dir written by the reference goes through both
  predictors: NSP logits within 1e-5, the pass-applied op counts equal
  (one flash_attention a layer, no dropout, no softmax), and repeated
  runs of one signature (the port's entry replays it) give the same
  bits.
* The reference's own predictor cases of ``tests/test_inference.py``
  (LeNet round trip against the reference's executor, zero-copy handles,
  the LRU bound, the cache counters, output-handle shapes, the int64
  feed narrowing), imported and run as they are with the reference's
  ``create_predictor`` / ``AnalysisConfig`` / ``telemetry.counter_get``
  / ``flags.overrides`` pointed at the port's.
* The predictor raises without CUDA unless asked for the CPU; the
  per-signature entries keep their parameters on the predictor's device.
"""

import collections
import functools

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.core.flags as jflags
import paddle_tpu.core.telemetry as jtelemetry
import paddle_tpu.inference as jinference

import paddle_tpu_torch.inference as pinference
from paddle_tpu_torch.core import flags as pflags
from paddle_tpu_torch.core import telemetry as ptelemetry

import tests.test_inference as ref_inference
from tests.test_torch_inference_io import save_reference
from tests.test_torch_passes import NSP, TINY, bert_batch

torch.set_num_threads(2)


def _port_predictor(path):
    return pinference.create_predictor(
        pinference.AnalysisConfig(path, device="cpu"))


def test_bert_tiny_reference_dir_through_both_predictors(tmp_path):
    path = str(tmp_path / "bert")
    save_reference("bert", path)
    ref = jinference.create_predictor(jinference.AnalysisConfig(path))
    pred = _port_predictor(path)
    assert pred.get_input_names() == ref.get_input_names()
    assert pred.get_output_names() == ref.get_output_names() == [NSP]
    assert pred.feed_specs() == ref.feed_specs()
    counts = collections.Counter(o.type for o in
                                 pred.program.global_block().ops)
    assert counts == collections.Counter(o.type for o in
                                         ref.program.global_block().ops)
    assert counts["flash_attention"] == TINY["num_hidden_layers"]
    assert counts["dropout"] == counts["softmax"] == 0
    for b, seed in ((3, 0), (1, 1), (4, 2)):
        batch = bert_batch(b, seed)
        want, = ref.run(batch)
        got, = pred.run(batch)
        assert got.shape == (b, 2) and got.dtype == np.float32
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
        again, = pred.run(batch)
        assert again.tobytes() == got.tobytes()


@pytest.fixture
def port_in_reference(monkeypatch):
    """The reference's predictor cases, run against the port: the names
    they import at call time are pointed at the port's."""
    monkeypatch.setattr(jinference, "create_predictor",
                        pinference.create_predictor)
    monkeypatch.setattr(jinference, "AnalysisConfig", functools.partial(
        pinference.AnalysisConfig, device="cpu"))
    monkeypatch.setattr(jtelemetry, "counter_get", ptelemetry.counter_get)
    monkeypatch.setattr(jflags, "overrides", pflags.overrides)


PREDICTOR_CASES = [
    ("TestSaveLoadPredict", "test_lenet_roundtrip"),
    ("TestSaveLoadPredict", "test_zero_copy_handles"),
    ("TestPredictorCacheAndHandles", "test_cache_is_lru_bounded"),
    ("TestPredictorCacheAndHandles", "test_cache_hits_counted"),
    ("TestPredictorCacheAndHandles", "test_output_handle_shape"),
    ("TestPredictorCacheAndHandles",
     "test_int64_downcast_follows_x64_config")]


@pytest.mark.parametrize("cls,case", PREDICTOR_CASES,
                         ids=[c for _, c in PREDICTOR_CASES])
def test_reference_predictor_cases_on_the_port(cls, case, tmp_path,
                                               port_in_reference):
    getattr(getattr(ref_inference, cls)(), case)(tmp_path, pt.Scope())


def test_lru_evicts_the_coldest_signature(tmp_path):
    path = str(tmp_path / "mlp")
    save_reference("mlp", path)
    pred = _port_predictor(path)
    e0 = ptelemetry.counter_get("predictor.cache_evictions")
    with pflags.overrides(predictor_cache_capacity=2):
        for rows in (1, 2, 1, 3):       # 2 is the coldest when 3 arrives
            pred.run({"x": np.ones((rows, 6), np.float32)})
        assert [k[0][1][0] for k in pred._cache] == [1, 3]
    assert ptelemetry.counter_get("predictor.cache_evictions") - e0 == 1


def test_entry_point_needs_cuda_or_the_cpu(tmp_path, monkeypatch):
    path = str(tmp_path / "mlp")
    save_reference("mlp", path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pinference.create_predictor(pinference.AnalysisConfig(path))
    pred = pinference.create_predictor(pinference.AnalysisConfig(path),
                                       device="cpu")
    assert pred.device.type == "cpu"
    assert all(v.device.type == "cpu" for v in pred._params.values())
