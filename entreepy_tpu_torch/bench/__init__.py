"""The port's bench: ``python -m entreepy_tpu_torch.bench [scale | weak]``.

Counterpart of the JAX repo's ``bench.py`` and ``benchmarks/{scale,
weak_scaling, multihost_bench, _mh_bench_worker}.py``, on the port alone
(torch, numpy; never JAX nor any module of ``entreepy_tpu``):

* no subcommand — the headline (``headline``): decode throughput of the
  5.2 MB text through auto, one JSON line, with the device and host
  backends' rows and, on the card, the kernels' figures (``probe``);
* ``scale`` — the corpus-size sweep (``scale``), one JSON row per size,
  corpus, backend and route;
* ``weak`` — weak scaling over gloo process worlds (``weak``).

Every run is on the card unless ``--device cpu`` is given; without a card
that flag is required. The corpora (``corpus``) and the clocks and bounds
(``timing``) are shared with ``chip_smoke.py`` and
``tools/torch_kernel_ab.py``.
"""

from .corpus import KINDS, TEXT_BYTES, build_corpus, extras, make_corpus, text_path
from .timing import HBM_BYTES_PER_MS, bound_ms, kernel_ms, peak_bytes, tensor_bytes, wall

__all__ = [
    "HBM_BYTES_PER_MS",
    "KINDS",
    "TEXT_BYTES",
    "bound_ms",
    "build_corpus",
    "extras",
    "kernel_ms",
    "make_corpus",
    "peak_bytes",
    "tensor_bytes",
    "text_path",
    "wall",
]
