"""Idle device ms a frame while the area map reads a batch of frames
from the pack: the port's ``area.read`` range."""

from portbench.trace import idle


def read(view):
    return idle.per_count_ms(view, ("area.read",), "frames")
