"""Share of the window the host spends inside the program's
``engine.upload`` spans (every host-to-device copy of a group: the uint8
crops and the fp32 mel, pageable, behind the previous group's forward on
one stream), over ``result["elapsed"]``."""

from benchmark.core import program


def read(view):
    uploads = program.spans(view, "engine.upload")
    if not uploads:
        return None
    return 100.0 * program.host_s(uploads) / view.result["elapsed"]
