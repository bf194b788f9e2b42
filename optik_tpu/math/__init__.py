"""Lie-group math (SO(3)/SE(3)) for the batched IK engine."""

from . import se3, so3

__all__ = ["so3", "se3"]
