"""MNIST LeNet (port of ``paddle_tpu/models/lenet.py``; the reference's
fixture is ``test_recognize_digits.py`` ``conv_net``): two conv + max-pool
stages, fc to 10 classes, softmax, cross entropy over the probabilities,
top-1 accuracy and Adam. Built with the port's layers, so both packages
produce the same program JSON."""

from __future__ import annotations

from .. import layers, optimizer
from ..core.ir import Program, program_guard


def build_lenet_program(batch_size=None, lr=0.01, with_optimizer=True):
    """Returns (main, startup, feeds{img,label}, fetch{loss,acc}).
    ``batch_size`` is accepted as the reference accepts it: the feeds
    keep a -1 batch dim."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        img = layers.data("img", [1, 28, 28])
        label = layers.data("label", [1], dtype="int64")
        conv1 = layers.conv2d(img, 20, 5, act="relu")
        pool1 = layers.pool2d(conv1, 2, "max", 2)
        conv2 = layers.conv2d(pool1, 50, 5, act="relu")
        pool2 = layers.pool2d(conv2, 2, "max", 2)
        logits = layers.fc(pool2, 10)
        prob = layers.softmax(logits)
        loss = layers.mean(layers.cross_entropy(prob, label))
        acc = layers.accuracy(prob, label)
        if with_optimizer:
            optimizer.AdamOptimizer(lr).minimize(loss)
    return main, startup, {"img": img, "label": label}, {"loss": loss,
                                                         "acc": acc}
