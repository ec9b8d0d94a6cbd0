"""``python -m entreepy_tpu_torch.bench [scale | weak] [options]``.

    python -m entreepy_tpu_torch.bench [--bytes N]                 # the headline
    python -m entreepy_tpu_torch.bench scale [--sizes 5,20,100] [--corpora ...]
        [--backends auto,host,device,sharded] [--routes onepass] [--stages]
    python -m entreepy_tpu_torch.bench weak [--per-rank-mb 3] [--worlds 1,2,4]

Each takes ``--device cuda|cpu`` (default ``cuda``; without a card the run
exits 1 unless ``--device cpu`` is given) and ``--text PATH``, the text
corpus's source file (default: the checkout's
``tests/data/a_midsummer_nights_dream.txt``; required outside a checkout).
Results go to stdout as JSON lines; notes, and the check that no module of
JAX or of ``entreepy_tpu`` was imported, go to stderr. Importing this
module does nothing.
"""

from __future__ import annotations

import argparse
import sys

from ..ops.decode8 import EXPAND_MODES
from . import headline, scale, weak
from .corpus import KINDS, TEXT_BYTES, NoTextError
from .timing import NoCardError, bench_device

FOREIGN = ("jax", "entreepy_tpu")


def _csv(kind):
    return lambda s: tuple(kind(x) for x in s.split(",") if x)


def parser() -> argparse.ArgumentParser:
    def common(p, default):
        p.add_argument("--device", default=default,
                       help="cuda (default) or cpu: the kernels' plain versions")
        p.add_argument("--text", default=default, metavar="PATH",
                       help="the text corpus's source file (default: the checkout's "
                            "tests/data/a_midsummer_nights_dream.txt)")

    top = argparse.ArgumentParser(prog="python -m entreepy_tpu_torch.bench",
                                  description=__doc__.split("\n\n")[0])
    common(top, None)
    top.add_argument("--bytes", type=int, default=TEXT_BYTES,
                     help=f"headline corpus size (default {TEXT_BYTES})")
    sub = top.add_subparsers(dest="cmd")
    sc = sub.add_parser("scale", help="the corpus-size sweep")
    common(sc, argparse.SUPPRESS)  # so a flag given before the subcommand stays
    sc.add_argument("--sizes", type=_csv(float), default=scale.SIZES_MB, help="MB, comma-separated")
    sc.add_argument("--corpora", type=_csv(str), default=KINDS)
    sc.add_argument("--backends", type=_csv(str), default=scale.BACKENDS)
    sc.add_argument("--routes", type=_csv(str), default=("onepass",),
                    help=f"the device and sharded decompress's routes, of {','.join(EXPAND_MODES)}")
    sc.add_argument("--stages", action="store_true",
                    help="add each row's stages, from one more traced call each way")
    wk = sub.add_parser("weak", help="weak scaling over process worlds")
    common(wk, argparse.SUPPRESS)
    wk.add_argument("--per-rank-mb", type=float, default=3.0)
    wk.add_argument("--worlds", type=_csv(int), default=(1, 2, 4))
    return top


def main(argv: list[str] | None = None) -> int:
    args = parser().parse_args(argv)
    try:
        dev = bench_device(args.device)
        if args.cmd == "scale":
            rc = scale.main(dev, args.sizes, args.corpora, args.backends, args.routes,
                            args.stages, args.text)
        elif args.cmd == "weak":
            rc = weak.main(dev, args.worlds, args.per_rank_mb, args.text)
        else:
            rc = headline.main(dev, args.bytes, args.text)
    except (NoCardError, NoTextError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    foreign = sorted(n for n in sys.modules if n.split(".")[0] in FOREIGN)
    print(f"[bench] modules of {' or '.join(FOREIGN)} imported: {foreign}", file=sys.stderr)
    return rc or int(bool(foreign))


if __name__ == "__main__":
    sys.exit(main())
