"""The encode host tail per call, ms: the program's stages ``code_table``,
``host_assemble``, ``stitch`` and ``serialize``."""

from etbench.reduce import stage_ms


def read(r):
    return stage_ms(r, ("code_table", "host_assemble", "stitch", "serialize"))
