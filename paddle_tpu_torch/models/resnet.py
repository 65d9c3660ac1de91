"""ResNet for ImageNet classification (port of
``paddle_tpu/models/resnet.py``): the ResNet-50 training step that the
reference's benchmark measures (``tools/bench_models.py:157``
``bench_resnet50``: batch 256, bf16 AMP, Momentum lr 0.1 / mu 0.9,
``fuse_bn_act_pass``).

Convolutions stay NCHW in the program and run through ``F.conv2d``;
batch norm keeps its running statistics as non-trainable persistable
vars; the classifier is one fc; the loss softmax_with_cross_entropy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from .. import layers
from ..core.ir import Program, program_guard
from ..initializer import Uniform
from ..param_attr import ParamAttr


@dataclass
class ResNetConfig:
    depth: int = 50
    num_classes: int = 1000
    image_shape: tuple = (3, 224, 224)
    # blocks per stage; from depth if empty
    stages: List[int] = field(default_factory=list)
    bottleneck: bool = True

    def __post_init__(self):
        table = {18: ([2, 2, 2, 2], False), 34: ([3, 4, 6, 3], False),
                 50: ([3, 4, 6, 3], True), 101: ([3, 4, 23, 3], True),
                 152: ([3, 8, 36, 3], True)}
        if not self.stages:
            self.stages, self.bottleneck = table[self.depth]


def resnet18(num_classes=1000, image_shape=(3, 224, 224)) -> ResNetConfig:
    return ResNetConfig(18, num_classes, image_shape)


def resnet50(num_classes=1000, image_shape=(3, 224, 224)) -> ResNetConfig:
    return ResNetConfig(50, num_classes, image_shape)


def _conv_bn(x, num_filters, filter_size, stride=1, act=None, name="",
             is_test=False):
    x = layers.conv2d(x, num_filters, filter_size, stride=stride,
                      padding=(filter_size - 1) // 2, bias_attr=False,
                      param_attr=ParamAttr(name=name + "_w"), name=name)
    return layers.batch_norm(x, act=act, is_test=is_test,
                             param_attr=ParamAttr(name=name + "_bn_scale"),
                             bias_attr=ParamAttr(name=name + "_bn_bias"),
                             moving_mean_name=name + "_bn_mean",
                             moving_variance_name=name + "_bn_var")


def _shortcut(x, c_out, stride, name, is_test):
    if x.shape[1] == c_out and stride == 1:
        return x
    return _conv_bn(x, c_out, 1, stride, name=name + "_sc", is_test=is_test)


def _basic_block(x, c, stride, name, is_test):
    y = _conv_bn(x, c, 3, stride, act="relu", name=name + "_c1",
                 is_test=is_test)
    y = _conv_bn(y, c, 3, 1, name=name + "_c2", is_test=is_test)
    return layers.relu(y + _shortcut(x, c, stride, name, is_test))


def _bottleneck_block(x, c, stride, name, is_test):
    y = _conv_bn(x, c, 1, 1, act="relu", name=name + "_c1", is_test=is_test)
    y = _conv_bn(y, c, 3, stride, act="relu", name=name + "_c2",
                 is_test=is_test)
    y = _conv_bn(y, c * 4, 1, 1, name=name + "_c3", is_test=is_test)
    return layers.relu(y + _shortcut(x, c * 4, stride, name, is_test))


def resnet_backbone(img, cfg: ResNetConfig, is_test=False):
    """conv1 -> 4 stages -> global average pool: [B, C, 1, 1] features."""
    x = _conv_bn(img, 64, 7, 2, act="relu", name="conv1", is_test=is_test)
    x = layers.pool2d(x, 3, "max", 2, pool_padding=1)
    block = _bottleneck_block if cfg.bottleneck else _basic_block
    filters = [64, 128, 256, 512]
    for stage, (n_blocks, c) in enumerate(zip(cfg.stages, filters)):
        for i in range(n_blocks):
            stride = 2 if i == 0 and stage > 0 else 1
            x = block(x, c, stride, f"res{stage + 2}{chr(97 + i)}", is_test)
    return layers.pool2d(x, 7, "avg", global_pooling=True)


def build_classifier_program(cfg: ResNetConfig, batch_size: int = -1,
                             optimizer_name: str = "momentum", lr: float = 0.1,
                             is_test: bool = False, with_optimizer: bool = True,
                             amp: bool = False, fuse_bn_act: bool = True):
    """The ImageNet classification step. Feeds img [B,3,H,W] and label
    [B,1]; fetches loss, acc1 and acc5. ``fuse_bn_act`` rewrites the
    batch_norm(+add)+relu chains into fused_bn_add_act before the
    backward is built; ``amp`` wraps the optimizer in the static bf16
    AMP decorator (no loss scaling). Optimizers: momentum (mu 0.9), sgd,
    adam."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        img = layers.static_data("img", [batch_size, *cfg.image_shape])
        label = layers.static_data("label", [batch_size, 1], "int64")
        feat = resnet_backbone(img, cfg, is_test=is_test)
        feat = layers.reshape(feat, [0, int(feat.shape[1])])
        stdv = 1.0 / np.sqrt(feat.shape[1])
        logits = layers.fc(feat, cfg.num_classes,
                           param_attr=ParamAttr(name="fc_out_w",
                                                initializer=Uniform(-stdv,
                                                                    stdv)),
                           bias_attr=ParamAttr(name="fc_out_b"))
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        prob = layers.softmax(logits)
        acc1 = layers.accuracy(prob, label, k=1)
        acc5 = layers.accuracy(prob, label, k=min(5, cfg.num_classes))
        if fuse_bn_act and not is_test:
            from ..core.passes import apply_passes

            apply_passes(main, ["fuse_bn_act_pass"])
        if with_optimizer:
            from .. import optimizer as opt_mod

            if optimizer_name == "momentum":
                opt = opt_mod.MomentumOptimizer(lr, 0.9)
            elif optimizer_name == "sgd":
                opt = opt_mod.SGDOptimizer(lr)
            elif optimizer_name == "adam":
                opt = opt_mod.AdamOptimizer(lr)
            else:
                raise ValueError(f"unknown optimizer '{optimizer_name}'")
            if amp:
                from ..contrib.mixed_precision import decorate

                opt = decorate(opt, use_dynamic_loss_scaling=False)
            opt.minimize(loss)
    feeds = dict(img=img, label=label)
    fetches = dict(loss=loss, acc1=acc1, acc5=acc5)
    return main, startup, feeds, fetches


def synthetic_batch(cfg: ResNetConfig, batch_size: int, seed: int = 0):
    """Normal images and uniform labels from ``seed``."""
    rng = np.random.RandomState(seed)
    img = rng.randn(batch_size, *cfg.image_shape).astype(np.float32)
    label = rng.randint(0, cfg.num_classes, (batch_size, 1)).astype(np.int64)
    return dict(img=img, label=label)
