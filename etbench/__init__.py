"""etbench: the benchmark of ``entreepy_tpu_torch`` (the PyTorch and CUDA
port) on NVIDIA H100 cards.

    python3 -m etbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (see ``run``). The cells, configurations, mixes
and metrics are named in ``BENCHMARK.json`` beside this folder; ``cells``
finds the files of each by its name, and ``traffic`` what each call is given.
``reference`` is the plain NumPy codec that decides ``correct``; ``sets`` and
``control`` are the tools that set the bounds and the limits. This package imports nothing of JAX or of the JAX
package, and of the program only its public API and its stage record.
"""
