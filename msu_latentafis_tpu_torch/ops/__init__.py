from . import pq

__all__ = ["pq"]
