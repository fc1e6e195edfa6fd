"""Idle device ms a frame while the built map is exported to the host
and written: the port's ``build.export`` and ``build.save`` ranges."""

from portbench.trace import idle


def read(view):
    return idle.per_count_ms(view, ("build.export", "build.save"),
                             "frames")
