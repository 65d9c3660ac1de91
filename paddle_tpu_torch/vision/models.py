"""paddle.vision.models: the 2.0 model zoo (port of
``paddle_tpu/vision/models.py``): LeNet, VGG 11-19, ResNet 18-152 and
MobileNet V1/V2, built from the port's ``nn`` layers; num_classes <= 0
drops the classifier head. There are no pretrained weights (nothing is
downloaded): ``pretrained=True`` raises, as in the reference."""

from __future__ import annotations

from .. import nn

__all__ = [
    "LeNet", "VGG", "vgg11", "vgg13", "vgg16", "vgg19",
    "ResNet", "BasicBlock", "BottleneckBlock",
    "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
    "MobileNetV1", "mobilenet_v1", "MobileNetV2", "mobilenet_v2",
]


def _no_pretrained(pretrained):
    if pretrained:
        raise ValueError(
            "pretrained=True is unsupported: there is no weight hub; load "
            "a checkpoint with dygraph.load_dygraph / set_state_dict")


class LeNet(nn.Layer):
    """reference: vision/models/lenet.py — conv(6)-pool-conv(16)-pool →
    fc 120-84-classes, on 28x28 inputs."""

    def __init__(self, num_classes=10):
        super().__init__()
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1), nn.ReLU(),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(6, 16, 5, stride=1, padding=0), nn.ReLU(),
            nn.MaxPool2D(2, 2))
        if num_classes > 0:
            self.flatten = nn.Flatten(1)
            self.fc = nn.Sequential(
                nn.Linear(400, 120), nn.Linear(120, 84),
                nn.Linear(84, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.flatten(x)
            x = self.fc(x)
        return x


_VGG_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
          512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
          512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


def _vgg_features(cfg, batch_norm):
    layers = []
    c_in = 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(2, 2))
        else:
            layers.append(nn.Conv2D(c_in, v, 3, padding=1))
            if batch_norm:
                layers.append(nn.BatchNorm2D(v))
            layers.append(nn.ReLU())
            c_in = v
    return nn.Sequential(*layers)


class VGG(nn.Layer):
    """reference: vision/models/vgg.py — features + 4096-4096-classes
    head over a 7x7 adaptive pool."""

    def __init__(self, features, num_classes=1000):
        super().__init__()
        self.features = features
        self.num_classes = num_classes
        if num_classes > 0:
            self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
            self.flatten = nn.Flatten(1)
            self.classifier = nn.Sequential(
                nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Dropout(),
                nn.Linear(4096, 4096), nn.ReLU(), nn.Dropout(),
                nn.Linear(4096, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.avgpool(x)
            x = self.flatten(x)
            x = self.classifier(x)
        return x


def _vgg(cfg, pretrained, batch_norm, **kw):
    _no_pretrained(pretrained)
    return VGG(_vgg_features(_VGG_CFGS[cfg], batch_norm), **kw)


def vgg11(pretrained=False, batch_norm=False, **kw):
    return _vgg("A", pretrained, batch_norm, **kw)


def vgg13(pretrained=False, batch_norm=False, **kw):
    return _vgg("B", pretrained, batch_norm, **kw)


def vgg16(pretrained=False, batch_norm=False, **kw):
    return _vgg("D", pretrained, batch_norm, **kw)


def vgg19(pretrained=False, batch_norm=False, **kw):
    return _vgg("E", pretrained, batch_norm, **kw)


class BasicBlock(nn.Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2D(inplanes, planes, 3, stride=stride,
                               padding=1, bias_attr=False)
        self.bn1 = nn.BatchNorm2D(planes)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1,
                               bias_attr=False)
        self.bn2 = nn.BatchNorm2D(planes)
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2D(inplanes, planes, 1, bias_attr=False)
        self.bn1 = nn.BatchNorm2D(planes)
        self.conv2 = nn.Conv2D(planes, planes, 3, stride=stride,
                               padding=1, bias_attr=False)
        self.bn2 = nn.BatchNorm2D(planes)
        self.conv3 = nn.Conv2D(planes, planes * self.expansion, 1,
                               bias_attr=False)
        self.bn3 = nn.BatchNorm2D(planes * self.expansion)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Layer):
    """reference: vision/models/resnet.py — 7x7/s2 stem, 4 stages,
    adaptive avg pool + fc."""

    def __init__(self, block, depth, num_classes=1000, with_pool=True):
        super().__init__()
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3],
                     50: [3, 4, 6, 3], 101: [3, 4, 23, 3],
                     152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.inplanes = 64
        self.conv1 = nn.Conv2D(3, 64, 7, stride=2, padding=3,
                               bias_attr=False)
        self.bn1 = nn.BatchNorm2D(64)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.flatten = nn.Flatten(1)
            self.fc = nn.Linear(512 * block.expansion, num_classes)

    def _make_layer(self, block, planes, blocks, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias_attr=False),
                nn.BatchNorm2D(planes * block.expansion))
        layers = [block(self.inplanes, planes, stride, downsample)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.flatten(x)
            x = self.fc(x)
        return x


def _resnet(depth, pretrained, **kw):
    _no_pretrained(pretrained)
    block = BasicBlock if depth in (18, 34) else BottleneckBlock
    return ResNet(block, depth, **kw)


def resnet18(pretrained=False, **kw):
    return _resnet(18, pretrained, **kw)


def resnet34(pretrained=False, **kw):
    return _resnet(34, pretrained, **kw)


def resnet50(pretrained=False, **kw):
    return _resnet(50, pretrained, **kw)


def resnet101(pretrained=False, **kw):
    return _resnet(101, pretrained, **kw)


def resnet152(pretrained=False, **kw):
    return _resnet(152, pretrained, **kw)


def _conv_bn(c_in, c_out, k, stride=1, padding=0, groups=1):
    return nn.Sequential(
        nn.Conv2D(c_in, c_out, k, stride=stride, padding=padding,
                  groups=groups, bias_attr=False),
        nn.BatchNorm2D(c_out), nn.ReLU())


class MobileNetV1(nn.Layer):
    """reference: vision/models/mobilenetv1.py — depthwise-separable
    stacks with a width multiplier (scale)."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            return max(1, int(ch * scale))

        cfg = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
               (256, 256, 1), (256, 512, 2)] + [(512, 512, 1)] * 5 + \
              [(512, 1024, 2), (1024, 1024, 1)]
        blocks = [_conv_bn(3, c(32), 3, stride=2, padding=1)]
        for c_in, c_out, s in cfg:
            blocks.append(_conv_bn(c(c_in), c(c_in), 3, stride=s,
                                   padding=1, groups=c(c_in)))  # depthwise
            blocks.append(_conv_bn(c(c_in), c(c_out), 1))       # pointwise
        self.features = nn.Sequential(*blocks)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.flatten = nn.Flatten(1)
            self.fc = nn.Linear(c(1024), num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.flatten(x)
            x = self.fc(x)
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kw):
    _no_pretrained(pretrained)
    return MobileNetV1(scale=scale, **kw)


class _InvertedResidual(nn.Layer):
    def __init__(self, c_in, c_out, stride, expand_ratio):
        super().__init__()
        hidden = int(round(c_in * expand_ratio))
        self.use_res = stride == 1 and c_in == c_out
        layers = []
        if expand_ratio != 1:
            layers.append(nn.Conv2D(c_in, hidden, 1, bias_attr=False))
            layers.append(nn.BatchNorm2D(hidden))
            layers.append(nn.ReLU6())
        layers += [
            nn.Conv2D(hidden, hidden, 3, stride=stride, padding=1,
                      groups=hidden, bias_attr=False),
            nn.BatchNorm2D(hidden), nn.ReLU6(),
            nn.Conv2D(hidden, c_out, 1, bias_attr=False),
            nn.BatchNorm2D(c_out),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Layer):
    """reference: vision/models/mobilenetv2.py — inverted residuals with
    linear bottlenecks, ReLU6, width multiplier (scale)."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            # reference _make_divisible: round to the nearest multiple
            # of 8, never dropping below 90% of the requested width
            v = ch * scale
            new_v = max(8, int(v + 4) // 8 * 8)
            if new_v < 0.9 * v:
                new_v += 8
            return new_v

        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
               (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
               (6, 320, 1, 1)]
        c_in = c(32)
        last = max(c(1280), 1280) if scale > 1.0 else 1280
        feats = [nn.Conv2D(3, c_in, 3, stride=2, padding=1,
                           bias_attr=False),
                 nn.BatchNorm2D(c_in), nn.ReLU6()]
        for t, ch, n, s in cfg:
            c_out = c(ch)
            for i in range(n):
                feats.append(_InvertedResidual(
                    c_in, c_out, s if i == 0 else 1, t))
                c_in = c_out
        feats += [nn.Conv2D(c_in, last, 1, bias_attr=False),
                  nn.BatchNorm2D(last), nn.ReLU6()]
        self.features = nn.Sequential(*feats)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.flatten = nn.Flatten(1)
            self.classifier = nn.Sequential(
                nn.Dropout(0.2), nn.Linear(last, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.flatten(x)
            x = self.classifier(x)
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kw):
    _no_pretrained(pretrained)
    return MobileNetV2(scale=scale, **kw)
