"""Inference-model export across the two packages, on the CPU.

* ``save_inference_model`` in each package, loaded in the other, for
  BERT-tiny (2 layers, hidden 32, 2 heads, S 32, vocab 64) and the
  serving tests' MLP (``tests/test_serving.py:_save_mlp``), with one
  ``.npy`` a var and with one combined ``.npz``: equal program JSON,
  equal feed and fetch names and ``feed_specs``, equal parameters bit for
  bit.
* ``read_inference_model_meta`` agrees for format versions 1 (no stored
  specs: read off the program) and 2.
* ``prune_program`` gives the reference's JSON.
* The atomic writers leave the target untouched when the writer fails;
  ``load_vars`` refuses a shape the program does not declare.
"""

import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import io as jio
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu.models import bert as jbert

import paddle_tpu_torch as ptt
from paddle_tpu_torch import io as pio
from paddle_tpu_torch.core import unique_name as p_unique
from paddle_tpu_torch.core.executor import _to_numpy
from paddle_tpu_torch.models import bert as pbert

from tests.test_torch_passes import FEEDS, NSP, SEQ, TINY

torch.set_num_threads(2)


def _bert(pkg_bert):
    main, startup, _, _ = pkg_bert.build_pretraining_program(
        pkg_bert.BertConfig(**TINY), seq_len=SEQ, with_optimizer=False,
        is_test=True)
    return main, startup


def _mlp(pkg, layers):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = layers.data("x", [6])
        h = layers.fc(x, 8, act="relu")
        y = layers.fc(h, 4)
    return main, startup, ["x"], [y.name]


def reseed(startup, seed):
    """Give the startup program's random ops the seeds they would hold had
    it been built with ``random_seed = seed`` (the op seeds are drawn at
    build time as random_seed * 1000003 + a counter)."""
    for op in startup.global_block().ops:
        if op.attrs.get("seed"):
            op.attrs["seed"] = int(op.attrs["seed"]) + seed * 1000003


def save_reference(model, path, params_filename=None, seed=0):
    """Write ``model`` ("bert" or "mlp") with the reference, its weights
    drawn under ``seed``; returns the reference's scope."""
    from paddle_tpu import layers as jl

    j_unique.switch()
    if model == "bert":
        main, startup = _bert(jbert)
        feeds, fetches = FEEDS, [NSP]
    else:
        main, startup, feeds, fetches = _mlp(pt, jl)
    reseed(startup, seed)
    scope = pt.Scope()
    pt.Executor().run(startup, scope=scope, use_compiled=False)
    jio.save_inference_model(path, feeds, fetches, main_program=main,
                             scope=scope, params_filename=params_filename)
    return scope


def save_port(model, path, params_filename=None):
    from paddle_tpu_torch import layers as pl

    p_unique.switch()
    if model == "bert":
        main, startup = _bert(pbert)
        feeds, fetches = FEEDS, [NSP]
    else:
        main, startup, feeds, fetches = _mlp(ptt, pl)
    scope = ptt.Scope()
    ptt.Executor(device="cpu").run(startup, scope=scope, use_compiled=False)
    pio.save_inference_model(path, feeds, fetches, main_program=main,
                             scope=scope, params_filename=params_filename)
    return scope


def _doc(path):
    with open(os.path.join(path, "__model__.json")) as f:
        return json.load(f)


CASES = [(w, m, c) for w in ("reference", "port") for m in ("bert", "mlp")
         for c in (None, "params")]


@pytest.mark.parametrize("writer,model,combined", CASES,
                         ids=[f"{w}-{m}-{'npz' if c else 'npy'}"
                              for w, m, c in CASES])
def test_dir_written_by_either_package_loads_in_the_other(
        tmp_path, writer, model, combined):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    # the same model from both packages: the same descs and names
    save_reference(model, a if writer == "reference" else b, combined)
    save_port(model, b if writer == "reference" else a, combined)
    da, db = _doc(a), _doc(b)
    assert json.dumps(da["program"], sort_keys=True) == \
        json.dumps(db["program"], sort_keys=True)
    for key in ("feed_names", "fetch_names", "feed_specs", "format_version"):
        assert da[key] == db[key], key
    assert da["format_version"] == 2
    # the dir the writer made, loaded by both packages
    jscope, pscope = pt.Scope(), ptt.Scope()
    jprog, jfeeds, jfetch = jio.load_inference_model(
        a, scope=jscope, params_filename=combined)
    pprog, pfeeds, pfetch = pio.load_inference_model(
        a, scope=pscope, params_filename=combined)
    assert json.dumps(pprog.to_dict(), sort_keys=True) == \
        json.dumps(jprog.to_dict(), sort_keys=True)
    assert (pfeeds, pfetch) == (jfeeds, jfetch)
    names = sorted(n for n, _ in jscope.items())
    assert sorted(n for n, _ in pscope.items()) == names and names
    for n in names:
        want = np.asarray(jscope.find_var(n))
        got = _to_numpy(pscope.find_var(n))
        assert got.dtype == want.dtype and got.shape == want.shape, n
        assert got.tobytes() == want.tobytes(), n


@pytest.mark.parametrize("version", [1, 2])
def test_read_inference_model_meta_agrees(tmp_path, version):
    path = str(tmp_path / "m")
    save_reference("bert", path)
    if version == 1:
        doc = _doc(path)
        del doc["feed_specs"], doc["format_version"]
        with open(os.path.join(path, "__model__.json"), "w") as f:
            json.dump(doc, f)
    want = jio.read_inference_model_meta(path)
    got = pio.read_inference_model_meta(path)
    assert got == want
    assert got["format_version"] == version
    assert got["feed_specs"]["src_ids"]["shape"] == [-1, SEQ]


def test_prune_program_equals_the_reference():
    j_unique.switch()
    p_unique.switch()
    jmain, _ = _bert(jbert)
    pmain, _ = _bert(pbert)
    for fetch in ([NSP], ["layer_norm_2.tmp_2"]):
        jp = jio.prune_program(jmain, FEEDS, fetch)
        pp = pio.prune_program(pmain, FEEDS, fetch)
        assert json.dumps(pp.to_dict(), sort_keys=True) == \
            json.dumps(jp.to_dict(), sort_keys=True)
        assert 0 < len(pp.global_block().ops) < len(pmain.global_block().ops)


def test_atomic_write_failure_leaves_target(tmp_path):
    path = str(tmp_path / "f.npy")
    pio.atomic_save_npy(path, np.arange(4))

    def boom(f):
        f.write(b"partial")
        raise RuntimeError("writer died")

    with pytest.raises(RuntimeError):
        pio.atomic_write(path, boom)
    np.testing.assert_array_equal(np.load(path), np.arange(4))
    assert sorted(os.listdir(tmp_path)) == ["f.npy"]
    pio.atomic_write_json(str(tmp_path / "d.json"), {"a": 1})
    pio.atomic_savez(str(tmp_path / "z"), a=np.ones(2))
    assert sorted(os.listdir(tmp_path)) == ["d.json", "f.npy", "z.npz"]


def test_load_vars_checks_the_declared_shape(tmp_path):
    path = str(tmp_path / "m")
    save_port("mlp", path)
    doc = _doc(path)
    w = next(v for v in doc["program"]["blocks"][0]["vars"]
             if v["persistable"] and len(v["shape"]) == 2)
    w["shape"] = [w["shape"][0] + 1, w["shape"][1]]
    with open(os.path.join(path, "__model__.json"), "w") as f:
        json.dump(doc, f)
    with pytest.raises(RuntimeError, match="shape mismatch"):
        pio.load_inference_model(path, scope=ptt.Scope())
