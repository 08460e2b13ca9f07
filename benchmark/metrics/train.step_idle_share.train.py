"""Share of the window in which the card ran no kernel or copy while the
host was inside the program's ``train.step`` span: the idle time the
step's own launches leave, as against the feed and the loss's read."""

from benchmark.core import program


def read(view):
    idle = program.idle_inside(view, program.spans(view, "train.step") or [])
    window = view.trace.window_s()
    if idle is None or not window:
        return None
    return 100.0 * idle / window
