"""paddle.vision: transforms, datasets and the model zoo (port of
``paddle_tpu/vision``)."""

from . import datasets, models, transforms  # noqa: F401
