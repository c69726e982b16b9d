from .models_bundle import ModelBundle
from .rolled import RolledFeatureExtractor

__all__ = ["ModelBundle", "RolledFeatureExtractor"]
