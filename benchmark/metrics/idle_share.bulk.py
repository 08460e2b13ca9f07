"""Share of the traced window in which no kernel or copy ran on the card
(the union of device intervals in the profiler's timeline)."""


def read(view):
    return view.trace.idle_share()
