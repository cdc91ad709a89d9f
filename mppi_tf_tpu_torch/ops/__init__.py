from . import noise, rollout, update

__all__ = ["noise", "rollout", "update"]
