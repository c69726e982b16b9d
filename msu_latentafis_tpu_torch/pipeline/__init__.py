from .latent import LatentFeatureExtractor
from .models_bundle import ModelBundle
from .rolled import RolledFeatureExtractor

__all__ = ["LatentFeatureExtractor", "ModelBundle", "RolledFeatureExtractor"]
