from .models_bundle import ModelBundle

__all__ = ["ModelBundle"]
