"""The sharded decode's copies between cards per call, ms: the program's
stage ``mesh_copy`` (a rank taking the other ranks' exit states onto its
card, joining them, and the synchronize after it), its slowest rank's. None
on a program without the stage."""

from etbench.reduce import stage_ms


def read(r):
    return stage_ms(r, ("mesh_copy",))
