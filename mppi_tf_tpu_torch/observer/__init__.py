from .observer import Observer

__all__ = ["Observer"]
