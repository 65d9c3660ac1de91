"""hapi (``Model``, callbacks, summary), ``metric`` and ``reader`` of the
port against the reference's, on the CPU.

``Model.fit`` / ``evaluate`` / ``predict`` of one MLP in both packages
(the reference's weights loaded into the port's, the same batches in
the same order): every batch's logged loss and metrics, the eval logs
and the predictions within 1e-5. The metrics on the same seeded
predictions exactly (1e-12 for floats); the DataLoader's batches and
orders, every reader decorator's output, equal to the reference's. The
port's own parts: the telemetry sink's ``hapi.step_ms`` and
``hapi.train_steps``, ``fit(resume_from=)`` raising for ROADMAP A9 and a
mesh-sharded prefetch for A8.
"""

import json

import numpy as np
import pytest

import paddle_tpu as rpt
import paddle_tpu.hapi  # noqa: F401  (not imported by the package itself)
import paddle_tpu_torch as tpt
from paddle_tpu_torch.core import telemetry as pt_tm

R = np.random.RandomState(5)
XS = R.randn(40, 8).astype(np.float32)
YS = np.argmax(XS @ R.randn(8, 4), axis=1).astype(np.int64)[:, None]


def guard(pkg):
    return pkg.dygraph.guard() if pkg is rpt else pkg.dygraph.guard("cpu")


def mlp(P):
    return P.nn.Sequential(P.nn.Linear(8, 16), P.nn.ReLU(),
                           P.nn.Linear(16, 4))


def _logger(P):
    class Log(P.hapi.Callback):
        def __init__(self):
            super().__init__()
            self.train, self.evals = [], []

        def on_train_batch_end(self, step, logs=None):
            self.train.append(dict(logs))

        def on_eval_end(self, logs=None):
            self.evals.append(dict(logs))

    return Log()


def fit(P, state=None, tmp=None):
    with guard(P):
        net = mlp(P)
        if state is not None:
            net.set_state_dict(state)
        start = {k: v.numpy() for k, v in net.state_dict().items()}
    ds = P.reader.TensorDataset([XS, YS])
    model = P.hapi.Model(net, inputs=["x"], labels=["y"]) if P is rpt \
        else P.hapi.Model(net, inputs=["x"], labels=["y"], device="cpu")
    opt = P.optimizer.Adam(0.02, parameters=net.parameters())
    model.prepare(opt, P.nn.CrossEntropyLoss(),
                  [P.metric.Accuracy(topk=(1, 2))])
    log = _logger(P)
    model.fit(ds, eval_data=ds, batch_size=8, epochs=2, shuffle=False,
              verbose=0, callbacks=[log])
    ev = model.evaluate(ds, batch_size=16, verbose=0)
    pred = model.predict(ds, batch_size=16, stack_outputs=True)[0]
    if tmp is not None:
        model.save(str(tmp / "ckpt"))
    return start, log, ev, pred, model


def test_fit_evaluate_predict_match_the_reference(tmp_path):
    ref = fit(rpt)
    port = fit(tpt, ref[0], tmp_path)
    assert len(port[1].train) == len(ref[1].train) == 10
    for g, w in zip(port[1].train, ref[1].train):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
    assert len(port[1].evals) == len(ref[1].evals) == 2
    for g, w in zip(port[1].evals + [port[2]], ref[1].evals + [ref[2]]):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
    np.testing.assert_allclose(port[3], ref[3], rtol=1e-5, atol=1e-5)
    # the port's checkpoint loads into the reference's Model
    with guard(rpt):
        rnet = mlp(rpt)
    rmodel = rpt.hapi.Model(rnet, inputs=["x"], labels=["y"])
    rmodel.prepare(rpt.optimizer.Adam(0.02, parameters=rnet.parameters()),
                   rpt.nn.CrossEntropyLoss())
    rmodel.load(str(tmp_path / "ckpt"))
    with guard(rpt):
        for k, v in rnet.state_dict().items():
            np.testing.assert_array_equal(
                v.numpy(), port[4].network.state_dict()[k].numpy())


def test_model_runs_on_the_device_of_its_parameters():
    with guard(tpt):
        net = mlp(tpt)
    assert tpt.hapi.Model(net).device.type == "cpu"
    assert tpt.hapi.Model(net, device="cpu").device.type == "cpu"


def test_fit_resume_from_names_roadmap_a9(tmp_path):
    with guard(tpt):
        net = mlp(tpt)
    model = tpt.hapi.Model(net, inputs=["x"], labels=["y"])
    model.prepare(tpt.optimizer.SGD(0.1, parameters=net.parameters()),
                  tpt.nn.CrossEntropyLoss())
    with pytest.raises(NotImplementedError, match="A9"):
        model.fit(tpt.reader.TensorDataset([XS, YS]), batch_size=8,
                  resume_from=str(tmp_path))


def test_telemetry_logger_writes_step_ms_and_train_steps(tmp_path):
    log = tmp_path / "run.jsonl"
    pt_tm.configure(str(log))
    pt_tm.reset()
    try:
        with guard(tpt):
            net = mlp(tpt)
        model = tpt.hapi.Model(net, inputs=["x"], labels=["y"])
        model.prepare(tpt.optimizer.SGD(0.1, parameters=net.parameters()),
                      tpt.nn.CrossEntropyLoss())
        model.fit(tpt.reader.TensorDataset([XS, YS]), batch_size=8,
                  epochs=1, verbose=0, log_freq=2)
        snap = pt_tm.snapshot()
        pt_tm.flush()
    finally:
        pt_tm.configure(None)
        pt_tm.reset()
    assert snap["hists"]["hapi.step_ms"]["count"] == 5
    assert snap["counters"]["hapi.train_steps"] == 5
    recs = [json.loads(ln) for ln in log.read_text().splitlines()]
    steps = [r for r in recs if r["kind"] == "step" and r["name"] == "train"]
    assert [r["attrs"]["step"] for r in steps] == [0, 2, 4]
    assert all(np.isfinite(r["value"]) for r in steps)


def test_callbacks_checkpoint_and_early_stopping(tmp_path):
    for P in (rpt, tpt):
        with guard(P):
            net = mlp(P)
        kw = {} if P is rpt else {"device": "cpu"}
        model = P.hapi.Model(net, inputs=["x"], labels=["y"], **kw)
        model.prepare(P.optimizer.SGD(0.0, parameters=net.parameters()),
                      P.nn.CrossEntropyLoss())
        stop = P.hapi.EarlyStopping(monitor="loss", patience=1)
        d = tmp_path / P.__name__
        ds = P.reader.TensorDataset([XS, YS])
        model.fit(ds, eval_data=ds, batch_size=20, epochs=5, verbose=0,
                  save_dir=str(d), callbacks=[stop])
        assert stop.wait >= 1 and model.stop_training
        names = sorted(p.name for p in d.iterdir())
        assert "final.pdparams" in names and "0.pdparams" in names


def test_summary_matches_the_reference(capsys):
    out = []
    for P in (rpt, tpt):
        with guard(P):
            net = P.nn.Sequential(P.nn.Conv2D(3, 4, 3), P.nn.ReLU(),
                                  P.nn.Flatten(), P.nn.Linear(64, 5))
            out.append(P.summary(net, (1, 3, 6, 6)))
    assert out[0] == out[1] == {"total_params": 437,
                                "trainable_params": 437}


# -- metrics -------------------------------------------------------------------

MR = np.random.RandomState(9)
PRED = MR.rand(50, 5)
LBL = MR.randint(0, 5, (50, 1))
BIN = MR.rand(60, 2)
BLBL = MR.randint(0, 2, (60, 1))


@pytest.mark.parametrize("name,make,args", [
    ("acc_top1", lambda m: m.Accuracy(), (PRED, LBL)),
    ("acc_top13", lambda m: m.Accuracy(topk=(1, 3)), (PRED, LBL)),
    ("precision", lambda m: m.Precision(), (BIN[:, 1], BLBL)),
    ("recall", lambda m: m.Recall(), (BIN[:, 1], BLBL)),
    ("auc", lambda m: m.Auc(num_thresholds=255), (BIN, BLBL)),
])
def test_metric_matches_the_reference(name, make, args):
    res = []
    for P in (rpt, tpt):
        m = make(P.metric)
        for lo in (0, 20, 40):
            m.update(*(a[lo:lo + 20] for a in args))
        res.append((m.accumulate(), m.name()))
        m.reset()
    assert res[0][1] == res[1][1]
    np.testing.assert_allclose(res[1][0], res[0][0], rtol=1e-12)


def test_metric_reads_tensors_on_any_device():
    import torch

    m = tpt.metric.Accuracy()
    m.update(torch.tensor(PRED), torch.tensor(LBL))
    assert m.accumulate() == pytest.approx(
        float(np.mean(PRED.argmax(1) == LBL[:, 0])))


# -- reader ----------------------------------------------------------------------

class _Squares:
    """A map-style dataset of (x, x^2, {'i': i}) rows, in either package's
    Dataset kind."""

    @staticmethod
    def make(P, n=13):
        class Sq(P.reader.Dataset):
            def __len__(self):
                return n

            def __getitem__(self, i):
                return (np.array([i, i + 1], np.float32),
                        np.array(i * i, np.int64))

        return Sq()


def _batches(loader):
    out = []
    for b in loader:
        out.append([np.asarray(x) for x in b])
    return out


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


@pytest.mark.parametrize("kw", [
    dict(batch_size=4), dict(batch_size=4, drop_last=True),
    dict(batch_size=3, shuffle=True), dict(batch_size=5, num_workers=2,
                                           use_shared_memory=False),
    dict(batch_size=4, num_workers=2, use_shared_memory=True)],
    ids=["plain", "drop_last", "shuffle", "threads", "processes"])
def test_dataloader_batches_and_order_match_the_reference(kw):
    out = []
    for P in (rpt, tpt):
        np.random.seed(11)
        loader = P.reader.DataLoader(_Squares.make(P), **kw)
        out.append((_batches(loader), len(loader)))
    _same(out[1][0], out[0][0])
    assert out[1][1] == out[0][1]


def test_samplers_and_collate_match_the_reference():
    for P in (rpt, tpt):
        np.random.seed(2)
        ds = _Squares.make(P, 9)
        bs = P.reader.BatchSampler(
            sampler=P.reader.RandomSampler(ds, replacement=True,
                                           num_samples=7), batch_size=3)
        seq = list(P.reader.SequenceSampler(ds))
        got = (list(bs), seq, len(bs))
        col = P.reader.default_collate_fn([{"a": np.ones(2), "b": (1, 2)},
                                           {"a": np.zeros(2), "b": (3, 4)}])
        if P is rpt:
            want, wcol = got, col
    assert got == want
    np.testing.assert_array_equal(col["a"], wcol["a"])
    np.testing.assert_array_equal(col["b"][1], wcol["b"][1])


def test_iterable_and_compose_datasets_match_the_reference():
    out = []
    for P in (rpt, tpt):
        class It(P.reader.IterableDataset):
            def __iter__(self):
                for i in range(7):
                    yield np.array([i, -i], np.int64)

        comp = P.reader.ComposeDataset([P.reader.TensorDataset([XS[:6]]),
                                        P.reader.TensorDataset([YS[:6]])])
        out.append((_batches(P.reader.DataLoader(It(), batch_size=3)),
                    [comp[i] for i in range(len(comp))]))
    assert len(out[1][0]) == len(out[0][0]) == 3
    for a, b in zip(out[1][0], out[0][0]):
        np.testing.assert_array_equal(a[0], b[0])
    for a, b in zip(out[1][1], out[0][1]):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_reader_decorators_match_the_reference():
    def src():
        yield from range(11)

    def pairs():
        for i in range(11):
            yield (i, i * 10)

    out = []
    for P in (rpt, tpt):
        rd = P.reader
        got = {
            "batch": list(rd.batch(src, 4)()),
            "batch_drop": list(rd.batch(src, 4, drop_last=True)()),
            "shuffle": list(rd.shuffle(src, 4, seed=3)()),
            "buffered": list(rd.buffered(src, 2)()),
            "cache": list(rd.cache(src)()),
            "chain": list(rd.chain(src, src)()),
            "compose": list(rd.compose(src, pairs)()),
            "firstn": list(rd.firstn(src, 3)()),
            "map": list(rd.map_readers(lambda a, b: a + b[1], src,
                                       pairs)()),
            "xmap": list(rd.xmap_readers(lambda v: v * 2, src, 3, 4,
                                         order=True)()),
        }
        with pytest.raises(rd.ComposeNotAligned):
            list(rd.compose(src, lambda: iter(range(3)))())
        out.append(got)
    assert out[0] == out[1]


def test_from_generator_puts_batches_on_the_named_device():
    import torch

    def gen():
        for i in range(3):
            yield (np.full((2, 2), i, np.float64), np.arange(2) + i)

    loader = tpt.reader.DataLoader.from_generator(capacity=2,
                                                  return_list=True)
    loader.set_batch_generator(gen, places="cpu")
    got = list(loader)
    assert len(got) == 3
    for i, (a, b) in enumerate(got):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        assert a.dtype == torch.float32 and b.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.full((2, 2), i))
    loader.set_state({"batches": 2})
    assert len(list(loader)) == 1


def test_a_mesh_of_more_than_one_device_names_roadmap_a8():
    class Mesh:
        shape = {"dp": 2}

    with pytest.raises(NotImplementedError, match="A8"):
        tpt.reader._prefetch_device_put((np.zeros(2),), "cpu", Mesh())
