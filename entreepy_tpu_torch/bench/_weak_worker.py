"""One rank of a weak-scaling world (``bench.weak``), run as

    python -m entreepy_tpu_torch.bench._weak_worker PORT WORLD RANK PER_RANK_MB DEVICE CORE [TEXT]

Counterpart of ``benchmarks/_mh_bench_worker.py``. Pins itself to CPU core
``CORE`` (``-1``: no pinning) before torch starts its threads, joins a gloo
group of ``WORLD`` ranks through a TCP store on 127.0.0.1:``PORT``, makes
``PER_RANK_MB`` MB x ``WORLD`` of text (``corpus.make_corpus``), and times
``parallel.multihost.compress`` and ``decompress`` on ``DEVICE`` (one
warm call, then the median, min and max of three), the ``.et`` checked
against the host codec's and the round trip exact. Prints one JSON line.
Importing this module does nothing.
"""

from __future__ import annotations

import json
import os
import sys

TIMED_CALLS = 3  # _mh_bench_worker.py's best of 3


def main(argv: list[str]) -> int:
    port, world, rank = int(argv[0]), int(argv[1]), int(argv[2])
    per_rank_mb, device, core = float(argv[3]), argv[4], int(argv[5])
    text = argv[6] if len(argv) > 6 else None
    if core >= 0:
        os.sched_setaffinity(0, {core})
    import torch

    from ..format import compress_host
    from ..parallel import multihost
    from .corpus import make_corpus
    from .headline import launch_counts, reset_launches
    from .timing import wall

    if core >= 0:
        torch.set_num_threads(1)  # the same one-core budget at every world size
    multihost.init(backend="gloo", init_method=f"tcp://127.0.0.1:{port}",
                   world_size=world, rank=rank)
    try:
        data = make_corpus("text", int(per_rank_mb * 1e6) * world, text)
        host_et = compress_host(data)
        reset_launches()
        blob, enc = wall(lambda: multihost.compress(data, device=device), iters=TIMED_CALLS)
        out, dec = wall(lambda: multihost.decompress(host_et, device=device),
                        iters=TIMED_CALLS)
        print(json.dumps({"rank": rank, "bytes": len(data), "encode": enc, "decode": dec,
                          "et_equals_host": blob == host_et, "round_trip": out == data,
                          "launches": launch_counts()}), flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
