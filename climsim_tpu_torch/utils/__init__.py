"""Utilities of the port: the flax -> torch weight porter."""
