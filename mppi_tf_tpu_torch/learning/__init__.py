"""Learning utilities of the port: the transition replay buffer (numpy
ring or the native C++ datastore), the learner and its checkpoints."""

from .learner import Learner
from .replay import ReplayBuffer

__all__ = ["ReplayBuffer", "Learner", "get_learner"]


def get_learner(model, **kwargs):
    """Factory passthrough. Reference: scripts/src/learner.py:1-18."""
    return Learner(model, **kwargs)
