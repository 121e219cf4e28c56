from .base import EmbeddingModel
from .registry import get_all_models, get_model

__all__ = ["EmbeddingModel", "get_all_models", "get_model"]
