"""The 2.0 ``nn`` Layer classes and ``nn.functional`` entries of the port
against the reference's, eagerly on the CPU.

Each Layer is built in both packages; the reference's ``state_dict()``
(as numpy) goes into the port's ``set_state_dict``, whose structured
keys and shapes must equal the reference's exactly. The same seeded
inputs then run through both: outputs, the gradient of
sum(first output * a seeded cotangent) with respect to every parameter
(by structured name) and every float input, and, in train mode, the
running statistics. Dropout layers run with numpy's global RNG seeded
alike in both packages (each eager dropout draws its seed from it), so
their masks agree bit for bit. Tolerance: 1e-5 relative and absolute
(2e-4 for the convolutions, attention and the encoder, whose sums run in
another order). The reference's own table of activation classes
(``tests/test_nn_surface2.py`` ``TestActivationLayers.CASES``) runs on
the port against its numpy formulas at the reference's tolerance.
"""

import numpy as np
import pytest

import paddle_tpu as rpt
import paddle_tpu_torch as tpt
import tests.test_nn_surface2 as ref_surface2

TOL = 1e-5
LOOSE = 2e-4


def _guard(pkg):
    return pkg.dygraph.guard() if pkg is rpt else pkg.dygraph.guard("cpu")


def _f32(a):
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def run(pkg, make, inputs, call=None, state=None, train=False, seed=7):
    """Build ``make(pkg)`` under a guard (loading ``state``), run it on
    ``inputs`` (float inputs need gradients) and backward
    sum(first output * cotangent). Returns (layer state as numpy, outputs
    as numpy, parameter grads by name, input grads, state after)."""
    with _guard(pkg):
        np.random.seed(seed)
        layer = make(pkg)
        if state:
            missing, unexpected = layer.set_state_dict(state)
            assert not missing and not unexpected, (missing, unexpected)
        if hasattr(layer, "train"):
            layer.train() if train else layer.eval()
        before = {k: v.numpy() for k, v in layer.state_dict().items()} \
            if hasattr(layer, "state_dict") else {}
        vbs = [pkg.dygraph.VarBase(a, stop_gradient=not _f32(a))
               for a in inputs]
        np.random.seed(seed + 1)
        out = (call or (lambda l, *x: l(*x)))(layer, *vbs)
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        flat = []
        for o in outs:
            flat.extend(o if isinstance(o, (tuple, list)) else [o])
        first = flat[0]
        cot = np.asarray(np.random.RandomState(seed).randn(*first.shape),
                         np.float32)
        if not first.stop_gradient:
            (first * pkg.dygraph.VarBase(cot)).sum().backward()
        pgrads = {}
        if hasattr(layer, "named_parameters"):
            pgrads = {n: p.gradient() for n, p in layer.named_parameters()}
        igrads = [v.gradient() for v in vbs]
        after = {k: v.numpy() for k, v in layer.state_dict().items()} \
            if hasattr(layer, "state_dict") else {}
        return before, [o.numpy() for o in flat], pgrads, igrads, after


def both(make, inputs, call=None, train=False, tol=TOL):
    ref = run(rpt, make, inputs, call, train=train)
    port = run(tpt, make, inputs, call, state=ref[0], train=train)
    assert list(port[0]) == list(ref[0])
    for k in ref[0]:
        assert port[0][k].shape == ref[0][k].shape, k
    assert len(port[1]) == len(ref[1])
    for i, (g, w) in enumerate(zip(port[1], ref[1])):
        assert g.shape == w.shape, i
        if _f32(w):
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                       err_msg=f"output {i}")
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype))
    assert sorted(port[2]) == sorted(ref[2])
    for k, w in ref[2].items():
        if w is None:
            assert port[2][k] is None, k
        else:
            np.testing.assert_allclose(port[2][k], w, rtol=tol, atol=tol,
                                       err_msg=f"grad {k}")
    for i, w in enumerate(ref[3]):
        if w is not None:
            np.testing.assert_allclose(port[3][i], w, rtol=tol, atol=tol,
                                       err_msg=f"input grad {i}")
    for k, w in ref[4].items():
        np.testing.assert_allclose(port[4][k], w, rtol=tol, atol=tol,
                                   err_msg=f"state after {k}")
    return ref, port


R = np.random.RandomState(0)


def _x(*shape, lo=-1.0, hi=1.0):
    return (R.rand(*shape) * (hi - lo) + lo).astype(np.float32)


def _ids(hi, *shape):
    return R.randint(0, hi, shape).astype(np.int64)


def _t(P, a):
    return P.dygraph.VarBase(np.asarray(a))


W5, W4 = _x(5, lo=0.1), _x(4, lo=0.5)


# name -> (make(pkg) -> Layer, inputs, call or None, train, tol)
LAYERS = {
    "Linear": (lambda P: P.nn.Linear(4, 3), [_x(2, 4)], None, False, TOL),
    "Linear[no_bias]": (lambda P: P.nn.Linear(4, 3, bias_attr=False),
                        [_x(2, 4)], None, False, TOL),
    "Conv2D": (lambda P: P.nn.Conv2D(3, 4, 3, padding=1), [_x(2, 3, 5, 5)],
               None, False, LOOSE),
    "Conv2D[reflect_stride_groups]": (
        lambda P: P.nn.Conv2D(4, 4, 3, stride=2, padding=1, groups=2,
                              padding_mode="reflect"),
        [_x(1, 4, 6, 6)], None, False, LOOSE),
    "Conv2DTranspose": (lambda P: P.nn.Conv2DTranspose(3, 2, 3, stride=2,
                                                       padding=1),
                        [_x(1, 3, 4, 4)], None, False, LOOSE),
    "Embedding": (lambda P: P.nn.Embedding(10, 4), [_ids(10, 2, 3)], None,
                  False, TOL),
    "Embedding[padding_idx]": (lambda P: P.nn.Embedding(10, 4,
                                                        padding_idx=0),
                               [np.array([[0, 3], [0, 9]])], None, False,
                               TOL),
    "Dropout[train]": (lambda P: P.nn.Dropout(0.4), [_x(4, 6)], None, True,
                       TOL),
    "Dropout[eval]": (lambda P: P.nn.Dropout(0.4), [_x(4, 6)], None, False,
                      TOL),
    "Dropout[downscale]": (lambda P: P.nn.Dropout(
        0.3, mode="downscale_in_infer"), [_x(3, 5)], None, True, TOL),
    "BatchNorm[train]": (lambda P: P.nn.BatchNorm(3), [_x(4, 3, 2, 2)],
                         None, True, TOL),
    "BatchNorm[act_eval]": (lambda P: P.nn.BatchNorm(3, act="relu"),
                            [_x(4, 3, 2, 2)], None, False, TOL),
    "BatchNorm1D[train]": (lambda P: P.nn.BatchNorm1D(3), [_x(6, 3)], None,
                           True, TOL),
    "BatchNorm2D[train]": (lambda P: P.nn.BatchNorm2D(3),
                           [_x(2, 3, 3, 3)], None, True, TOL),
    "SyncBatchNorm[train]": (lambda P: P.nn.SyncBatchNorm(3),
                             [_x(2, 3, 3, 3)], None, True, TOL),
    "LayerNorm": (lambda P: P.nn.LayerNorm(4), [_x(2, 3, 4)], None, False,
                  TOL),
    "LayerNorm[2d]": (lambda P: P.nn.LayerNorm([3, 4]), [_x(2, 3, 4)],
                      None, False, TOL),
    "GroupNorm": (lambda P: P.nn.GroupNorm(2, 4), [_x(2, 4, 3, 3)], None,
                  False, TOL),
    "InstanceNorm2D": (lambda P: P.nn.InstanceNorm2D(3), [_x(2, 3, 4, 4)],
                       None, False, TOL),
    "PReLU[all]": (lambda P: P.nn.PReLU(), [_x(2, 3)], None, False, TOL),
    "PReLU[channel]": (lambda P: P.nn.PReLU(3), [_x(2, 3, 2, 2)], None,
                       False, TOL),
    "Softmax": (lambda P: P.nn.Softmax(axis=0), [_x(3, 4)], None, False,
                TOL),
    "LeakyReLU": (lambda P: P.nn.LeakyReLU(0.2), [_x(3, 4)], None, False,
                  TOL),
    "LogSoftmax": (lambda P: P.nn.LogSoftmax(), [_x(3, 4)], None, False,
                   TOL),
    "MaxPool2D": (lambda P: P.nn.MaxPool2D(2, 2), [_x(2, 3, 6, 6)], None,
                  False, TOL),
    "MaxPool2D[pad_ceil]": (lambda P: P.nn.MaxPool2D(3, 2, 1,
                                                     ceil_mode=True),
                            [_x(1, 2, 7, 7)], None, False, TOL),
    "AvgPool2D": (lambda P: P.nn.AvgPool2D(2, 2), [_x(2, 3, 6, 6)], None,
                  False, TOL),
    "AdaptiveAvgPool2D": (lambda P: P.nn.AdaptiveAvgPool2D(2),
                          [_x(2, 3, 5, 5)], None, False, TOL),
    "AdaptiveMaxPool2D": (lambda P: P.nn.AdaptiveMaxPool2D((2, 3)),
                          [_x(2, 3, 6, 6)], None, False, TOL),
    "Flatten": (lambda P: P.nn.Flatten(), [_x(2, 3, 2, 2)], None, False,
                TOL),
    "Pad2D[reflect]": (lambda P: P.nn.Pad2D([1, 1, 2, 0], mode="reflect"),
                       [_x(1, 2, 3, 4)], None, False, TOL),
    "ZeroPad2d": (lambda P: P.nn.ZeroPad2d(1), [_x(1, 2, 3, 3)], None, False,
                  TOL),
    "ConstantPad2d": (lambda P: P.nn.ConstantPad2d([0, 1, 1, 0], 0.5),
                      [_x(1, 2, 3, 3)], None, False, TOL),
    "Upsample[nearest]": (lambda P: P.nn.Upsample(scale_factor=2),
                          [_x(1, 2, 3, 3)], None, False, TOL),
    "UpsamplingNearest2d": (lambda P: P.nn.UpsamplingNearest2d(size=(5, 4)),
                            [_x(1, 2, 3, 3)], None, False, TOL),
    "UpsamplingBilinear2d": (lambda P: P.nn.UpsamplingBilinear2d(
        scale_factor=2), [_x(1, 2, 3, 3)], None, False, TOL),
    "PixelShuffle": (lambda P: P.nn.PixelShuffle(2), [_x(1, 8, 2, 3)], None,
                     False, TOL),
    "CosineSimilarity": (lambda P: P.nn.CosineSimilarity(axis=1),
                         [_x(3, 5), _x(3, 5)], None, False, TOL),
    "PairwiseDistance": (lambda P: P.nn.PairwiseDistance(),
                         [_x(3, 5), _x(3, 5)], None, False, TOL),
    "PairwiseDistance[p1]": (lambda P: P.nn.PairwiseDistance(p=1.0,
                                                             keepdim=True),
                             [_x(3, 5), _x(3, 5)], None, False, TOL),
    "LocalResponseNorm": (lambda P: P.nn.LocalResponseNorm(3),
                          [_x(1, 4, 3, 3)], None, False, TOL),
    "Dropout2D[train]": (lambda P: P.nn.Dropout2D(0.5), [_x(2, 3, 2, 2)],
                         None, True, TOL),
    "Dropout3D[train]": (lambda P: P.nn.Dropout3D(0.5),
                         [_x(2, 3, 2, 2, 2)], None, True, TOL),
    "Bilinear": (lambda P: P.nn.Bilinear(3, 4, 2), [_x(5, 3), _x(5, 4)],
                 None, False, TOL),
    "Sequential": (lambda P: P.nn.Sequential(P.nn.Linear(4, 5), P.nn.ReLU(),
                                             P.nn.Linear(5, 2)),
                   [_x(3, 4)], None, False, TOL),
    "Sequential[named]": (lambda P: P.nn.Sequential(
        [("fc", P.nn.Linear(4, 3)), ("act", P.nn.Tanh())]), [_x(2, 4)],
        None, False, TOL),
    "LayerList": (lambda P: P.nn.LayerList([P.nn.Linear(3, 3),
                                            P.nn.Linear(3, 2)]),
                  [_x(2, 3)], lambda l, x: l[1](l[0](x)), False, TOL),
    "CrossEntropyLoss": (lambda P: P.nn.CrossEntropyLoss(),
                         [_x(4, 5), _ids(5, 4, 1)], None, False, TOL),
    "CrossEntropyLoss[ignore]": (
        lambda P: P.nn.CrossEntropyLoss(ignore_index=2),
        [_x(6, 5), np.array([[2], [1], [2], [0], [4], [3]])], None, False,
        TOL),
    "CrossEntropyLoss[weight]": (
        lambda P: P.nn.CrossEntropyLoss(weight=_t(P, W5)),
        [_x(4, 5), _ids(5, 4)], None, False, TOL),
    "CrossEntropyLoss[soft]": (
        lambda P: P.nn.CrossEntropyLoss(soft_label=True, reduction="sum"),
        [_x(3, 4), np.full((3, 4), 0.25, np.float32)], None, False, TOL),
    "L1Loss[sum]": (lambda P: P.nn.L1Loss("sum"), [_x(3, 4), _x(3, 4)],
                    None, False, TOL),
    "NLLLoss": (lambda P: P.nn.NLLLoss(), [_x(4, 5), _ids(5, 4)], None,
                False, TOL),
    "NLLLoss[weight_ignore]": (
        lambda P: P.nn.NLLLoss(weight=_t(P, W5), ignore_index=1),
        [_x(6, 5), np.array([1, 0, 4, 1, 2, 3])], None, False, TOL),
    "BCEWithLogitsLoss": (lambda P: P.nn.BCEWithLogitsLoss(),
                          [_x(3, 4), (_x(3, 4) > 0).astype(np.float32)],
                          None, False, TOL),
    "BCEWithLogitsLoss[pos_weight]": (
        lambda P: P.nn.BCEWithLogitsLoss(pos_weight=_t(P, W4)),
        [_x(3, 4), (_x(3, 4) > 0).astype(np.float32)], None, False, TOL),
    "SmoothL1Loss": (lambda P: P.nn.SmoothL1Loss(), [_x(3, 4), _x(3, 4)],
                     None, False, TOL),
    "BCELoss": (lambda P: P.nn.BCELoss(), [_x(3, 4, lo=0.05, hi=0.95),
                                          (_x(3, 4) > 0).astype(np.float32)],
                None, False, TOL),
    "MarginRankingLoss": (lambda P: P.nn.MarginRankingLoss(0.1),
                          [_x(4, 1), _x(4, 1),
                           np.sign(_x(4, 1)).astype(np.float32)],
                          None, False, TOL),
    "CTCLoss": (lambda P: P.nn.CTCLoss(),
                [_x(2, 6, 5, lo=-2, hi=2),
                 np.array([[1, 2, 2], [3, 1, 0]], np.int32),
                 np.array([6, 5], np.int64), np.array([3, 2], np.int64)],
                None, False, 5e-5),
    "HSigmoidLoss": (lambda P: P.nn.HSigmoidLoss(3, 6),
                     [_x(4, 3), np.array([0, 5, 3, 2])], None, False, TOL),
    "LSTM": (lambda P: P.nn.LSTM(4, 5), [_x(2, 3, 4)], None, False, TOL),
    "GRU[reverse]": (lambda P: P.nn.GRU(4, 5, is_reverse=True),
                     [_x(2, 3, 4)], None, False, TOL),
    "SimpleRNNCell": (lambda P: P.nn.SimpleRNNCell(4, 3), [_x(2, 4)], None,
                      False, TOL),
    "LSTMCell": (lambda P: P.nn.LSTMCell(4, 3), [_x(2, 4)], None, False,
                 TOL),
    "GRUCell": (lambda P: P.nn.GRUCell(4, 3), [_x(2, 4), _x(2, 3)], None,
                False, TOL),
    "MultiHeadAttention": (lambda P: P.nn.MultiHeadAttention(8, 2),
                           [_x(2, 4, 8)], None, False, LOOSE),
    "MultiHeadAttention[key_bias]": (
        lambda P: P.nn.MultiHeadAttention(8, 2),
        [_x(2, 5, 8), np.where(np.arange(5)[None, None, None] < 3, 0.0,
                               -1e4).repeat(2, 0).astype(np.float32)],
        lambda l, x, m: l(x, attn_mask=m), False, LOOSE),
    "TransformerEncoderLayer[post_ln]": (
        lambda P: P.nn.TransformerEncoderLayer(8, 2, 16, dropout=0.0),
        [_x(2, 4, 8)], None, False, LOOSE),
    "TransformerEncoderLayer[pre_ln_relu]": (
        lambda P: P.nn.TransformerEncoderLayer(
            8, 2, 16, dropout=0.0, activation="relu",
            normalize_before=True), [_x(2, 4, 8)], None, False, LOOSE),
    "TransformerEncoder[dropout]": (
        lambda P: P.nn.TransformerEncoder(
            lambda: P.nn.TransformerEncoderLayer(8, 2, 16, dropout=0.1), 2),
        [_x(2, 4, 8)], None, True, LOOSE),
}
for _name in ("ReLU", "GELU", "Sigmoid", "Tanh", "Hardswish", "Silu", "ELU",
              "Hardshrink", "Hardsigmoid", "Hardtanh", "LogSigmoid", "ReLU6",
              "SELU", "Softplus", "Softshrink", "Softsign", "Swish",
              "Tanhshrink", "ThresholdedReLU"):
    LAYERS[_name] = (lambda P, n=_name: getattr(P.nn, n)(),
                     [np.linspace(-3, 3, 24).reshape(4, 6)
                      .astype(np.float32)], None, False, TOL)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_the_reference(name):
    make, inputs, call, train, tol = LAYERS[name]
    both(make, inputs, call, train, tol)


def test_every_reference_nn_class_has_a_case():
    import paddle_tpu.nn as rnn

    names = {n.split("[")[0] for n in LAYERS}
    classes = {n for n in rnn.__all__ if isinstance(getattr(rnn, n), type)
               and issubclass(getattr(rnn, n), rnn.Layer)}
    # ParameterList and the two losses have tests of their own below
    skip = {"Layer", "ParameterList", "MSELoss", "KLDivLoss",
            "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"}
    assert classes - skip <= names, sorted(classes - skip - names)
    assert set(tpt.nn.__all__) == set(rnn.__all__)


def test_parameter_list_and_named_keys():
    def make(P):
        pl = P.nn.ParameterList()
        lin = P.nn.Linear(2, 2)
        pl.append(lin.weight)
        pl.append(lin.bias)
        return pl
    ref = run(rpt, make, [], call=lambda l: l[0] * 2.0)
    port = run(tpt, make, [], call=lambda l: l[0] * 2.0, state=ref[0])
    assert list(port[0]) == list(ref[0]) == ["0", "1"]
    np.testing.assert_allclose(port[1][0], ref[1][0], rtol=TOL)
    np.testing.assert_allclose(port[2]["0"], ref[2]["0"], rtol=TOL)


@pytest.mark.parametrize("name,kw,ref",
                         ref_surface2.TestActivationLayers.CASES)
def test_reference_activation_table_on_the_port(name, kw, ref):
    with tpt.dygraph.guard("cpu"):
        x = np.linspace(-3, 3, 24).reshape(4, 6).astype(np.float32)
        got = np.asarray(getattr(tpt.nn, name)(**kw)(tpt.to_tensor(x)))
        np.testing.assert_allclose(got, ref(x.astype(np.float64)),
                                   rtol=2e-5, atol=1e-6, err_msg=name)


# -- nn.functional: name -> (fn(P, *vbs), inputs, train) -------------------

def _F(P):
    return P.nn.functional


FUNCTIONAL = {
    "linear": (lambda P, x, w, b: _F(P).linear(x, w, b),
               [_x(2, 3), _x(3, 4), _x(4)]),
    "conv2d": (lambda P, x, w: _F(P).conv2d(x, w, stride=2, padding=1),
               [_x(1, 2, 5, 5), _x(3, 2, 3, 3)]),
    "conv2d_transpose": (lambda P, x, w, b: _F(P).conv2d_transpose(
        x, w, b, stride=2), [_x(1, 2, 3, 3), _x(2, 3, 2, 2), _x(3)]),
    "embedding": (lambda P, i, w: _F(P).embedding(i, w, padding_idx=1),
                  [np.array([[1, 2], [0, 1]]), _x(4, 3)]),
    "layer_norm": (lambda P, x, w, b: _F(P).layer_norm(x, 4, w, b),
                   [_x(2, 3, 4), _x(4), _x(4)]),
    "dropout": (lambda P, x: _F(P).dropout(x, 0.25), [_x(5, 6)]),
    "batch_norm": (lambda P, x, w, b: _F(P).batch_norm(
        x, _t(P, np.zeros(3, np.float32)), _t(P, np.ones(3, np.float32)),
        w, b, training=True), [_x(4, 3), _x(3), _x(3)]),
    "sync_batch_norm": (lambda P, x, w, b: _F(P).sync_batch_norm(
        x, _t(P, np.zeros(3, np.float32)), _t(P, np.ones(3, np.float32)),
        w, b, training=True), [_x(4, 3, 2, 2), _x(3), _x(3)]),
    "group_norm": (lambda P, x: _F(P).group_norm(x, 2), [_x(2, 4, 3)]),
    "gelu[approx]": (lambda P, x: _F(P).gelu(x, approximate=True),
                     [_x(3, 4)]),
    "sqrt": (lambda P, x: _F(P).sqrt(x), [_x(3, 4, lo=0.1)]),
    "square": (lambda P, x: _F(P).square(x), [_x(3, 4)]),
    "elu": (lambda P, x: _F(P).elu(x, 0.5), [_x(3, 4)]),
    "prelu": (lambda P, x, w: _F(P).prelu(x, w), [_x(2, 3, 2), _x(3)]),
    "hardsigmoid": (lambda P, x: _F(P).hardsigmoid(x), [_x(3, 4, lo=-4,
                                                          hi=4)]),
    "log_softmax": (lambda P, x: _F(P).log_softmax(x, 0), [_x(3, 4)]),
    "swish": (lambda P, x: _F(P).swish(x), [_x(3, 4)]),
    "max_pool2d": (lambda P, x: _F(P).max_pool2d(x, 2), [_x(1, 2, 4, 4)]),
    "avg_pool2d": (lambda P, x: _F(P).avg_pool2d(x, 3, 1, 1,
                                                 exclusive=False),
                   [_x(1, 2, 4, 4)]),
    "adaptive_max_pool2d": (lambda P, x: _F(P).adaptive_max_pool2d(x, 1),
                            [_x(1, 2, 4, 4)]),
    "interpolate[bilinear]": (lambda P, x: _F(P).interpolate(
        x, size=(2, 3), mode="bilinear"), [_x(1, 2, 5, 6)]),
    "upsample": (lambda P, x: _F(P).upsample(x, scale_factor=[2.0, 1.0]),
                 [_x(1, 1, 2, 3)]),
    "pad[circular]": (lambda P, x: _F(P).pad(x, [1, 0, 0, 2],
                                             mode="circular"),
                      [_x(1, 1, 3, 3)]),
    "softmax_with_cross_entropy": (
        lambda P, x, l: _F(P).softmax_with_cross_entropy(
            x, l, return_softmax=True), [_x(3, 4), _ids(4, 3, 1)]),
    "cross_entropy[none]": (lambda P, x, l: _F(P).cross_entropy(
        x, l, reduction="none"), [_x(3, 4), _ids(4, 3, 1)]),
    "l1_loss[none]": (lambda P, x, y: _F(P).l1_loss(x, y, "none"),
                      [_x(3, 4), _x(3, 4)]),
    "binary_cross_entropy_with_logits[weight]": (
        lambda P, x, y, w: _F(P).binary_cross_entropy_with_logits(
            x, y, weight=w), [_x(3, 4), (_x(3, 4) > 0).astype(np.float32),
                              _x(4, lo=0.2)]),
    "smooth_l1_loss[delta]": (lambda P, x, y: _F(P).smooth_l1_loss(
        x, y, delta=0.5), [_x(3, 4), _x(3, 4)]),
    "nll_loss[none]": (lambda P, x, l: _F(P).nll_loss(x, l,
                                                      reduction="none"),
                       [_x(4, 5), _ids(5, 4)]),
    "one_hot": (lambda P, i: _F(P).one_hot(i, 5), [_ids(5, 2, 3)]),
    "label_smooth": (lambda P, x: _F(P).label_smooth(x, epsilon=0.2),
                     [_x(3, 4, lo=0.0)]),
    "normalize[p1]": (lambda P, x: _F(P).normalize(x, p=1, axis=0),
                      [_x(3, 4)]),
    "selu": (lambda P, x: _F(P).selu(x), [_x(3, 4)]),
    "hardtanh": (lambda P, x: _F(P).hardtanh(x, -0.5, 0.5), [_x(3, 4)]),
    "relu6": (lambda P, x: _F(P).relu6(x), [_x(3, 4, lo=-2, hi=8)]),
    "softplus[beta]": (lambda P, x: _F(P).softplus(x, beta=2.0,
                                                   threshold=5.0),
                       [_x(3, 4, lo=-5, hi=5)]),
    "thresholded_relu": (lambda P, x: _F(P).thresholded_relu(x, 0.3),
                         [_x(3, 4)]),
    "pixel_shuffle": (lambda P, x: _F(P).pixel_shuffle(x, 2),
                      [_x(1, 4, 2, 2)]),
    "local_response_norm": (lambda P, x: _F(P).local_response_norm(
        x, 3, alpha=0.1), [_x(1, 5, 2, 2)]),
    "cosine_similarity": (lambda P, x, y: _F(P).cosine_similarity(x, y, 0),
                          [_x(4, 3), _x(4, 3)]),
    "pairwise_distance[p3]": (lambda P, x, y: _F(P).pairwise_distance(
        x, y, p=3.0), [_x(4, 3), _x(4, 3)]),
    "dropout2d": (lambda P, x: _F(P).dropout2d(x, 0.5), [_x(2, 4, 2, 2)]),
    "bilinear": (lambda P, x, y, w, b: _F(P).bilinear(x, y, w, b),
                 [_x(2, 3), _x(2, 4), _x(5, 3, 4), _x(1, 5)]),
}


@pytest.mark.parametrize("name", sorted(FUNCTIONAL))
def test_functional_matches_the_reference(name):
    fn, inputs = FUNCTIONAL[name]
    tol = LOOSE if name.startswith("conv") else TOL
    both(lambda P: P, inputs, fn, False, tol)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_mse_and_kl_div_losses_the_reference_cannot_run(reduction):
    """The reference's mse_loss feeds square_error_cost slots X and Y (the
    op reads Input and Label) and its kl_div reads kldiv_loss's output
    as Out (the op writes Loss): both raise KeyError there. The port
    passes the op's own slots; held against numpy, with gradients."""
    x, y, t = _x(3, 4), _x(3, 4), _x(3, 4, lo=0.1)
    with rpt.dygraph.guard():
        for fn, args in ((rpt.nn.MSELoss(reduction), (x, y)),
                         (rpt.nn.KLDivLoss(reduction), (x, t))):
            with pytest.raises(KeyError):
                fn(*[rpt.dygraph.VarBase(a) for a in args])
    red = {"mean": np.mean, "sum": np.sum, "none": lambda v: v}[reduction]
    with tpt.dygraph.guard("cpu"):
        xv = tpt.dygraph.VarBase(x, stop_gradient=False)
        mse = tpt.nn.MSELoss(reduction)(xv, tpt.to_tensor(y))
        np.testing.assert_allclose(mse.numpy(), red((x - y) ** 2),
                                   rtol=TOL, atol=TOL)
        mse.sum().backward()
        scale = 1.0 / x.size if reduction == "mean" else 1.0
        np.testing.assert_allclose(xv.gradient(), 2 * (x - y) * scale,
                                   rtol=TOL, atol=TOL)
        kl = tpt.nn.KLDivLoss(reduction)(tpt.to_tensor(x), tpt.to_tensor(t))
        np.testing.assert_allclose(kl.numpy(), red(t * (np.log(t) - x)),
                                   rtol=TOL, atol=TOL)
