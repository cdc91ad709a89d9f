from .analytic import AUVEnv, PointMassEnv

__all__ = ["AUVEnv", "PointMassEnv"]
