"""Learning utilities of the port: the transition replay buffer (the
learner itself is ROADMAP item 11)."""

from .replay import ReplayBuffer

__all__ = ["ReplayBuffer"]
