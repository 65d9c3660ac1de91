"""hapi: the Keras-like high-level API (port of ``paddle_tpu/hapi``)."""

from .callbacks import (Callback, EarlyStopping, ModelCheckpoint,  # noqa: F401
                        ProgBarLogger, TelemetryLogger)
from .model import Model  # noqa: F401
from .model_summary import summary  # noqa: F401
