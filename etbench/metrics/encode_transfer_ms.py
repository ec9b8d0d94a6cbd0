"""The encode's transfers per call, ms: the program's stages ``input_upload``
(the document to the card), ``sizing_fetch`` (the plane's size back) and
``device_fetch`` (the packed words back)."""

from etbench.reduce import stage_ms


def read(r):
    return stage_ms(r, ("input_upload", "sizing_fetch", "device_fetch"))
