"""The plane route's compaction per call, ms: the program's stage
``plane_compact`` (the real-byte mask, the cap's readback and the
compaction kernel with its int32 copy of the slots, once per tile of the
one-pass route at m > 3). None on a program without the stage, and on the
packed route (m <= 3), which records none."""

from etbench.reduce import stage_ms


def read(r):
    return stage_ms(r, ("plane_compact",))
