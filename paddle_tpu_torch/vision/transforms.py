"""Image transforms (port of ``paddle_tpu/vision/transforms.py``):
numpy, composable, applied on the host before the batch goes to the
device."""

from __future__ import annotations

import numpy as np


def _is_chw(img):
    """Heuristic shared by the spatial transforms: 3-D with a small leading
    channel dim ⇒ CHW, else HWC/HW."""
    img = np.asarray(img)
    return (img.ndim == 3 and img.shape[0] in (1, 3)
            and img.shape[0] < img.shape[-1])


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


class ToTensor:
    """HWC uint8 [0,255] → CHW float32 [0,1]."""

    def __call__(self, img):
        img = np.asarray(img)
        if img.ndim == 2:
            img = img[:, :, None]
        img = img.astype(np.float32) / 255.0
        return np.transpose(img, (2, 0, 1))


class Normalize:
    def __init__(self, mean, std, data_format="CHW"):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.data_format = data_format

    def __call__(self, img):
        img = np.asarray(img, np.float32)
        shape = (-1, 1, 1) if self.data_format == "CHW" else (1, 1, -1)
        return (img - self.mean.reshape(shape)) / self.std.reshape(shape)


class Resize:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        img = np.asarray(img)
        chw = _is_chw(img)
        h_ax = 1 if chw else 0
        th, tw = self.size
        h, w = img.shape[h_ax], img.shape[h_ax + 1]
        ri = (np.arange(th) * h / th).astype(np.int64).clip(0, h - 1)
        ci = (np.arange(tw) * w / tw).astype(np.int64).clip(0, w - 1)
        if chw:
            return img[:, ri][:, :, ci]
        return img[ri][:, ci]


class RandomHorizontalFlip:
    def __init__(self, prob=0.5, rng=None):
        self.prob = prob
        self.rng = rng or np.random

    def __call__(self, img):
        img = np.asarray(img)
        if self.rng.rand() < self.prob:
            # width axis: last for CHW/HW, second-to-last only for HWC
            w_ax = img.ndim - 1 if (img.ndim == 2 or _is_chw(img)) \
                else img.ndim - 2
            return np.flip(img, axis=w_ax).copy()
        return img


class RandomCrop:
    def __init__(self, size, padding=0, rng=None):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding
        self.rng = rng or np.random

    def __call__(self, img):
        img = np.asarray(img)
        chw = _is_chw(img)
        h_ax = 1 if chw else 0
        if self.padding:
            pad = [(0, 0)] * img.ndim
            pad[h_ax] = (self.padding, self.padding)
            pad[h_ax + 1] = (self.padding, self.padding)
            img = np.pad(img, pad, mode="constant")
        th, tw = self.size
        h, w = img.shape[h_ax], img.shape[h_ax + 1]
        if h < th or w < tw:
            raise ValueError(
                f"RandomCrop target {self.size} larger than image "
                f"({h}, {w}) — pad first (padding=) or resize")
        y = self.rng.randint(0, h - th + 1)
        x = self.rng.randint(0, w - tw + 1)
        if chw:
            return img[:, y:y + th, x:x + tw]
        return img[y:y + th, x:x + tw]
