"""Vision datasets (port of ``paddle_tpu/vision/datasets.py``): nothing
is downloaded; MNIST reads local IDX files, and FakeData is a seeded
synthetic stand-in for tests and smoke training."""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

# the map-style Dataset base the DataLoader/hapi Model recognise
from ..reader import Dataset


class FakeData(Dataset):
    """Deterministic synthetic images (reference: tests' fake datasets)."""

    def __init__(self, num_samples=1000, image_shape=(1, 28, 28),
                 num_classes=10, transform=None, seed=0):
        self.num_samples = num_samples
        self.image_shape = tuple(image_shape)  # (C, H, W) like the reference
        self.num_classes = num_classes
        self.transform = transform
        self._rng = np.random.RandomState(seed)
        c, h, w = self.image_shape
        # raw samples are HWC uint8 (what ToTensor expects, like PIL input)
        self._images = self._rng.randint(
            0, 256, (num_samples, h, w, c)).astype(np.uint8)
        self._labels = self._rng.randint(
            0, num_classes, (num_samples, 1)).astype(np.int64)

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        img = self._images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, self._labels[idx]


class MNIST(Dataset):
    """IDX-format MNIST from local files (reference:
    vision/datasets/mnist.py; image_path/label_path point at the
    train-images-idx3-ubyte.gz etc. files)."""

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, backend_dir=None):
        root = backend_dir or os.environ.get("MNIST_DATA_DIR", "")
        tag = "train" if mode == "train" else "t10k"
        image_path = image_path or os.path.join(
            root, f"{tag}-images-idx3-ubyte.gz")
        label_path = label_path or os.path.join(
            root, f"{tag}-labels-idx1-ubyte.gz")
        if not (os.path.exists(image_path) and os.path.exists(label_path)):
            raise FileNotFoundError(
                f"MNIST files not found ({image_path}); nothing is "
                f"downloaded — provide local files or use FakeData")
        self.images = self._read_idx(image_path, expect_magic=2051)
        self.labels = self._read_idx(label_path, expect_magic=2049)
        self.transform = transform

    @staticmethod
    def _read_idx(path, expect_magic):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            magic, n = struct.unpack(">II", f.read(8))
            if magic != expect_magic:
                raise ValueError(f"bad IDX magic {magic} in {path}")
            if expect_magic == 2051:
                h, w = struct.unpack(">II", f.read(8))
                data = np.frombuffer(f.read(), np.uint8).reshape(n, h, w)
            else:
                data = np.frombuffer(f.read(), np.uint8).reshape(n, 1) \
                    .astype(np.int64)
        return data

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]
