from .infer import TileInferenceEngine

__all__ = ["TileInferenceEngine"]
