"""The share of the encode window in which a card ran no kernel, copy or
set, %; on several cards the mean over them (profiler)."""

from etbench.reduce import idle_pct


def read(r):
    return idle_pct(r)
