"""Idle device ms a frame while CLIP resizes and normalises a batch of
images on the host: the port's ``clip.preprocess`` range."""

from portbench.trace import idle


def read(view):
    return idle.per_count_ms(view, ("clip.preprocess",), "frames")
