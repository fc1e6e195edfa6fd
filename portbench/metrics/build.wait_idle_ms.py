"""Idle device ms a frame while the step waits on the producer thread
for its next batch: the port's ``build.wait_input`` range."""

from portbench.trace import idle


def read(view):
    return idle.per_count_ms(view, ("build.wait_input",), "frames")
