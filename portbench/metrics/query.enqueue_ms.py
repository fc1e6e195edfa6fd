"""Host ms until the query call returns, before the fetch waits: the
mean over the untraced window's queries (the harness's span)."""


def read(view):
    return view.window.get("counts", {}).get("enqueue_ms")
