"""The decode host tail per call, ms: the program's stages ``host_extract``
(symbols out of the fetched plane), ``host_validate`` (the lanes'
accept/reject), ``host_join`` (the local mesh's join) and ``host_check_bits``
(the exact-bit check). On a local mesh each stage is its slowest rank's."""

from etbench.reduce import stage_ms


def read(r):
    return stage_ms(r, ("host_extract", "host_validate", "host_join", "host_check_bits"))
