"""Idle device ms a frame while the builder sets up: the port's
``build.setup`` range (the resume read, the pack's match, the
accumulator, the step and the loader), before the first batch."""

from portbench.trace import idle


def read(view):
    return idle.per_count_ms(view, ("build.setup",), "frames")
