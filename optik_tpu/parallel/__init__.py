"""Mesh/sharding utilities (multi-device IK)."""
