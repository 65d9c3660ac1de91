"""Inference engine: load, optimize, capture, predict (port of
``paddle_tpu/inference``). ``create_predictor(AnalysisConfig(model_dir))``
loads an ``io.save_inference_model`` dir, applies ``DEFAULT_PASSES`` and
runs each feed signature as one captured CUDA graph on the card."""

from .predictor import (DEFAULT_PASSES, AnalysisConfig,  # noqa: F401
                        AnalysisPredictor, Config, PredictorTensor,
                        create_predictor)

__all__ = ["DEFAULT_PASSES", "AnalysisConfig", "AnalysisPredictor", "Config",
           "PredictorTensor", "create_predictor"]
