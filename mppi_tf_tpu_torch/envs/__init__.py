from .analytic import PointMassEnv

__all__ = ["PointMassEnv"]
