"""Seconds from the harness's first line to the window's start: imports,
documents and their reference files, the card's context, the kernels' build
(first run in a checkout) and one warm call per document."""


def read(w):
    return w.setup_s
