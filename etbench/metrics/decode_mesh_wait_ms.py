"""The sharded decode's waits per call, ms: the program's stage
``mesh_wait`` (a rank waiting at an exchange for the other ranks: both
barriers of a local mesh's exchange, one exchange of exit states per pass),
its slowest rank's. None on a program without the stage."""

from etbench.reduce import stage_ms


def read(r):
    return stage_ms(r, ("mesh_wait",))
