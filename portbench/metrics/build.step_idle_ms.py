"""Idle device ms a frame while the launching thread is inside a step:
the port's ``build.step`` range and the ranges inside it, the card
waiting on the host that launches its kernels."""

from portbench.trace import idle

SPANS = ("build.step", "build.geometry", "build.sample", "build.lseg",
         "build.colour", "build.fuse", "lseg.vit", "lseg.dpt", "lseg.head")


def read(view):
    return idle.per_count_ms(view, SPANS, "frames")
