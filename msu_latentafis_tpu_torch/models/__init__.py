from .compnet import CompNet, compnet_from_flax

__all__ = ["CompNet", "compnet_from_flax"]
