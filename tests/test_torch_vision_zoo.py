"""The 2.0 vision zoo, transforms and datasets of the port against the
reference's, on the CPU.

Every zoo model at its published widths is built in static mode in both
packages (Parameters with shapes, nothing allocated): the same structured
state-dict keys and shapes. At small inputs and widths the models run
eagerly from the reference's weights: outputs, every parameter's
gradient and the running statistics within 2e-4 (2e-3 for the deep
stacks, ``DEEP``: their convolutions sum in another order), in eval mode
and, with BatchNorm's batch statistics, in train mode. The transforms
and datasets give the reference's arrays exactly.
"""

import gzip
import struct

import numpy as np
import pytest

import paddle_tpu as rpt
import paddle_tpu.vision  # noqa: F401
import paddle_tpu_torch as tpt

TOL = 2e-4


def guard(pkg):
    return pkg.dygraph.guard() if pkg is rpt else pkg.dygraph.guard("cpu")


ZOO = ("LeNet", "vgg11", "vgg13", "vgg16", "vgg19", "vgg16_bn", "resnet18",
       "resnet34", "resnet50", "resnet101", "resnet152", "mobilenet_v1",
       "mobilenet_v2")


def _build(P, name, **kw):
    M = P.vision.models
    if name == "LeNet":
        return M.LeNet(**kw)
    if name.endswith("_bn"):
        return getattr(M, name[:-3])(batch_norm=True, **kw)
    return getattr(M, name)(**kw)


def _static_shapes(P, name):
    main, startup = P.Program(), P.Program()
    with P.program_guard(main, startup):
        net = _build(P, name)
    return {k: tuple(v.shape) for k, v in net.state_dict().items()}


@pytest.mark.parametrize("name", ZOO)
def test_zoo_keys_and_shapes_at_full_width_match_the_reference(name):
    want, got = _static_shapes(rpt, name), _static_shapes(tpt, name)
    assert list(got) == list(want)
    assert got == want


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# name -> (kwargs, input shape)
SMALL = {
    "LeNet": ({}, (2, 1, 28, 28)),
    "LeNet[features]": ({"num_classes": 0}, (2, 1, 28, 28)),
    "vgg11[features]": ({"num_classes": 0}, (1, 3, 32, 32)),
    "resnet18": ({"num_classes": 7}, (2, 3, 32, 32)),
    "mobilenet_v1": ({"scale": 0.25, "num_classes": 3}, (2, 3, 32, 32)),
    "mobilenet_v2": ({"scale": 0.25, "num_classes": 6}, (2, 3, 32, 32)),
    "resnet18[b4_64px]": ({"num_classes": 7}, (4, 3, 64, 64)),
}
# the deep stacks carry the two packages' differently ordered sums
# further
DEEP = {"mobilenet_v1": 2e-3, "mobilenet_v2": 2e-3, "resnet18": 2e-3,
        "resnet18[b4_64px]": 2e-3}
# train mode at 4 rows of 64 x 64: BatchNorm's batch variance
# (E[x^2] - mean^2) over the 2 rows of 1 x 1 a smaller input leaves in
# the last stage cancels to noise, where the two packages' gradients
# part. MobileNetV2's train-mode gradients are ill-conditioned at any
# size a test can afford: in the port alone, a relative change of 1e-6
# in its 4 x 3 x 64 x 64 input moves its first convolution's weight
# gradient by 2% of its largest element; it is held in eval mode only
TRAIN = ("resnet18[b4_64px]",)
EVAL = ("LeNet", "LeNet[features]", "vgg11[features]", "resnet18",
        "mobilenet_v1", "mobilenet_v2")


def _run(P, name, train, state=None):
    kw, shape = SMALL[name]
    with guard(P):
        net = _build(P, name.split("[")[0], **kw)
        if state is not None:
            missing, unexpected = net.set_state_dict(state)
            assert not missing and not unexpected
        start = {k: v.numpy() for k, v in net.state_dict().items()}
        net.train() if train else net.eval()
        np.random.seed(4)
        out = net(P.dygraph.VarBase(_x(shape)))
        cot = _x(out.shape, 1)
        (out * P.dygraph.VarBase(cot)).sum().backward()
        grads = {n: p.gradient() for n, p in net.named_parameters()}
        after = {k: v.numpy() for k, v in net.state_dict().items()}
        return start, out.numpy(), grads, after


CASES = [(n, False) for n in EVAL] + [(n, True) for n in TRAIN]


@pytest.mark.parametrize("name,train", CASES,
                         ids=[f"{n}-{'train' if t else 'eval'}"
                              for n, t in CASES])
def test_zoo_forward_and_gradients_match_the_reference(name, train):
    tol = DEEP.get(name, TOL)
    ref = _run(rpt, name, train)
    port = _run(tpt, name, train, ref[0])
    np.testing.assert_allclose(port[1], ref[1], rtol=tol, atol=tol)
    assert sorted(port[2]) == sorted(ref[2])
    for k, w in ref[2].items():
        np.testing.assert_allclose(port[2][k], w, rtol=tol, atol=tol,
                                   err_msg=k)
    for k, w in ref[3].items():
        np.testing.assert_allclose(port[3][k], w, rtol=tol, atol=tol,
                                   err_msg=k)


@pytest.mark.parametrize("ctor", ["vgg11", "resnet18", "mobilenet_v2"])
def test_pretrained_raises_as_in_the_reference(ctor):
    for P in (rpt, tpt):
        with pytest.raises(ValueError, match="pretrained"):
            getattr(P.vision.models, ctor)(pretrained=True)


# -- transforms and datasets -----------------------------------------------------

IMG = np.random.RandomState(7).randint(0, 256, (20, 24, 3)).astype(np.uint8)


def _transforms(T, seed):
    rng = np.random.RandomState(seed)
    return {
        "to_tensor_normalize": T.Compose([
            T.ToTensor(), T.Normalize([0.5, 0.4, 0.3], [0.2, 0.3, 0.4])]),
        "resize_hwc": T.Resize((11, 7)),
        "resize_chw": T.Compose([T.ToTensor(), T.Resize(9)]),
        "flip": T.RandomHorizontalFlip(prob=0.5, rng=rng),
        "crop_pad": T.RandomCrop(16, padding=2, rng=rng),
        "normalize_hwc": T.Normalize([1.0, 2.0, 3.0], [2.0, 2.0, 2.0],
                                     data_format="HWC"),
    }


@pytest.mark.parametrize("name", ["to_tensor_normalize", "resize_hwc",
                                  "resize_chw", "flip", "crop_pad",
                                  "normalize_hwc"])
def test_transform_matches_the_reference(name):
    want = [_transforms(rpt.vision.transforms, 3)[name](IMG)
            for _ in range(1)]
    rt, pt = (_transforms(rpt.vision.transforms, 3)[name],
              _transforms(tpt.vision.transforms, 3)[name])
    for _ in range(4):
        np.testing.assert_array_equal(pt(IMG), rt(IMG))
    assert want[0].dtype == pt(IMG).dtype


def test_fake_data_matches_the_reference():
    kw = dict(num_samples=6, image_shape=(3, 8, 8), num_classes=5, seed=2)
    r = rpt.vision.datasets.FakeData(**kw)
    p = tpt.vision.datasets.FakeData(
        transform=tpt.vision.transforms.ToTensor(), **kw)
    assert len(p) == len(r) == 6
    for i in range(6):
        np.testing.assert_array_equal(
            p[i][0], rpt.vision.transforms.ToTensor()(r[i][0]))
        np.testing.assert_array_equal(p[i][1], r[i][1])


def test_local_mnist_files_match_the_reference(tmp_path):
    imgs = np.random.RandomState(1).randint(0, 256, (3, 28, 28)).astype(
        np.uint8)
    labels = np.array([3, 1, 4], np.uint8)
    with gzip.open(tmp_path / "train-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 3, 28, 28) + imgs.tobytes())
    with gzip.open(tmp_path / "train-labels-idx1-ubyte.gz", "wb") as f:
        f.write(struct.pack(">II", 2049, 3) + labels.tobytes())
    r = rpt.vision.datasets.MNIST(backend_dir=str(tmp_path))
    p = tpt.vision.datasets.MNIST(backend_dir=str(tmp_path))
    for i in range(3):
        np.testing.assert_array_equal(p[i][0], r[i][0])
        np.testing.assert_array_equal(p[i][1], r[i][1])
    with pytest.raises(FileNotFoundError):
        tpt.vision.datasets.MNIST(backend_dir=str(tmp_path / "none"))
