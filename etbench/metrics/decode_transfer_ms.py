"""The decode's transfers per call, ms: the program's stages ``body_upload``
(the body to the card) and ``device_sym_fetch`` (the compacted plane back)."""

from etbench.reduce import stage_ms


def read(r):
    return stage_ms(r, ("body_upload", "device_sym_fetch"))
