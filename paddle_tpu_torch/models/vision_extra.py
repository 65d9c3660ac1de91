"""VGG16, the second net of the book's image_classification pair
(tests/book/test_image_classification.py:78 vgg16_bn_drop; the ResNet
half is ``models/resnet.py``). The port of
``paddle_tpu/models/vision_extra.py``, built op for op as the
reference builds it: blocks of 3x3 conv + batch norm + relu (with
dropout between the convs) and a 2x2 max pool, then dropout, fc4096,
batch norm + relu, dropout, fc4096."""

from __future__ import annotations

import numpy as np

from .. import layers
from ..core.ir import Program, program_guard
from ..param_attr import ParamAttr


def _conv_block(x, num_filter, groups, dropouts, name, is_test=False):
    """fluid.nets.img_conv_group: conv3x3 + BN + relu ``groups`` times,
    each followed by its dropout, then a 2x2 max pool."""
    for i in range(groups):
        x = layers.conv2d(x, num_filter, 3, padding=1, bias_attr=False,
                          param_attr=ParamAttr(name=f"{name}_c{i}_w"))
        x = layers.batch_norm(x, act="relu", is_test=is_test,
                              param_attr=ParamAttr(name=f"{name}_c{i}_bns"),
                              bias_attr=ParamAttr(name=f"{name}_c{i}_bnb"),
                              moving_mean_name=f"{name}_c{i}_bnm",
                              moving_variance_name=f"{name}_c{i}_bnv")
        if dropouts[i] and not is_test:
            x = layers.dropout(x, dropout_prob=dropouts[i])
    return layers.pool2d(x, 2, "max", 2)


def vgg16_backbone(img, is_test=False):
    """64x2, 128x2, 256x3, 512x3, 512x3 conv blocks -> dropout ->
    fc4096 -> BN + relu -> dropout -> fc4096."""
    x = _conv_block(img, 64, 2, [0.3, 0], "vgg_b1", is_test)
    x = _conv_block(x, 128, 2, [0.4, 0], "vgg_b2", is_test)
    x = _conv_block(x, 256, 3, [0.4, 0.4, 0], "vgg_b3", is_test)
    x = _conv_block(x, 512, 3, [0.4, 0.4, 0], "vgg_b4", is_test)
    x = _conv_block(x, 512, 3, [0.4, 0.4, 0], "vgg_b5", is_test)
    if not is_test:
        x = layers.dropout(x, dropout_prob=0.5)
    fc1 = layers.fc(x, 4096, param_attr=ParamAttr(name="vgg_fc1_w"))
    bn = layers.batch_norm(fc1, act="relu", is_test=is_test,
                           param_attr=ParamAttr(name="vgg_fc1_bns"),
                           bias_attr=ParamAttr(name="vgg_fc1_bnb"),
                           moving_mean_name="vgg_fc1_bnm",
                           moving_variance_name="vgg_fc1_bnv")
    if not is_test:
        bn = layers.dropout(bn, dropout_prob=0.5)
    return layers.fc(bn, 4096, param_attr=ParamAttr(name="vgg_fc2_w"))


def build_vgg_program(num_classes=10, image_shape=(3, 32, 32),
                      batch_size=-1, lr=0.01, is_test=False,
                      with_optimizer=True):
    """(main, startup, feeds, fetches): pixel [B, 3, 32, 32], label
    [B, 1]; the mean softmax cross entropy and the accuracy, Adam at
    ``lr``."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        img = layers.static_data("pixel", [batch_size, *image_shape])
        label = layers.static_data("label", [batch_size, 1], "int64")
        feat = vgg16_backbone(img, is_test=is_test)
        logits = layers.fc(feat, num_classes,
                           param_attr=ParamAttr(name="vgg_out_w"))
        loss = layers.mean(
            layers.softmax_with_cross_entropy(logits, label))
        acc = layers.accuracy(layers.softmax(logits), label)
        if with_optimizer and not is_test:
            from ..optimizer import AdamOptimizer

            AdamOptimizer(lr).minimize(loss)
    return main, startup, {"pixel": img, "label": label}, \
        {"loss": loss, "acc": acc}


def synthetic_batch(batch_size, image_shape=(3, 32, 32), num_classes=10,
                    seed=0):
    rng = np.random.RandomState(seed)
    return {"pixel": rng.randn(batch_size, *image_shape).astype(np.float32),
            "label": rng.randint(0, num_classes,
                                 (batch_size, 1)).astype(np.int64)}
