"""Seeded inputs: the RGB-D walk through a room, and the served map."""
