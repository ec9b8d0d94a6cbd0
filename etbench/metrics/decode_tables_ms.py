"""The decode tables per call, ms: the program's stage ``decode_tables``
(the byte automaton and its device tables, built per call in NumPy)."""

from etbench.reduce import stage_ms


def read(r):
    return stage_ms(r, ("decode_tables",))
