"""entreepy-compatible command-line interface of the PyTorch port.

``python -m entreepy_tpu_torch`` has the reference surface of
``entreepy_tpu.cli``: commands ``c``/``d``, the flags ``-p/-t/-d/-o`` and
their long forms, the default output names, the size summary on stderr, the
``-d`` dictionary dump and the progress bar. Parsing, naming, the help
text's reference part and the dump are imported from ``entreepy_tpu.cli``
(which imports no JAX); :func:`main` runs the port's ``api``. ``--backend``
takes ``host`` or ``device``; ``sharded`` is not ported yet and exits 1.
"""

from __future__ import annotations

import sys
import time

from entreepy_tpu.cli import (
    REFERENCE_HELP_TEXT,
    CliError,
    _dump_dictionary,
    parse_args,
)
from entreepy_tpu.format import DegenerateInputError, FormatError
from entreepy_tpu.utils.fmt import format_file_size
from entreepy_tpu.utils.progress import ProgressBar

from . import api

HELP_TEXT = REFERENCE_HELP_TEXT + """
PyTorch/CUDA extensions:
    --backend       force a codec backend: host | device
                    (default: auto — device on a CUDA card for large inputs;
                    sharded is not ported yet)
"""


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        opts = parse_args(argv)
    except CliError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    if opts.mode == "none":
        sys.stdout.write(HELP_TEXT)
        return 0

    try:
        data = open(opts.file_in, "rb").read()
    except OSError as e:
        print(f"error: cannot read {opts.file_in}: {e.strerror}", file=sys.stderr)
        return 1

    encode = opts.mode == "compress"
    bar = ProgressBar(theme=0 if encode else 1)
    show_bar = not opts.print_output and (not opts.debug if encode else True)
    if not show_bar:
        bar.enabled = False
    bar.start()
    bar.update(5, "Reading file..." if encode else "Reading file header...")

    t0 = time.perf_counter_ns()
    try:
        if encode:
            out = api.compress(data, backend=opts.backend, progress=bar.update)
        else:
            out = api.decompress(data, backend=opts.backend, progress=bar.update)
        bar.update(95, "Writing compressed text..." if encode else "Writing decoded text...")
    except (FormatError, DegenerateInputError, ValueError, NotImplementedError,
            api.NoCudaDeviceError) as e:
        bar.finish("Failed.")
        print(f"error: {e}", file=sys.stderr)
        return 1
    elapsed_us = (time.perf_counter_ns() - t0) // 1000

    if not opts.dry:
        try:
            with open(opts.file_out, "wb") as f:
                f.write(out)
        except OSError as e:
            bar.finish("Failed.")
            print(f"error: cannot write {opts.file_out}: {e.strerror}", file=sys.stderr)
            return 1

    bar.finish("Done compressing!" if encode else "Done decompressing!")

    if opts.print_output and not encode:
        sys.stdout.buffer.write(out)
        sys.stdout.flush()

    if opts.debug:
        if encode:
            _dump_dictionary(data)
            print(f"\nbits in output: {len(out) * 8}")
        print(f"time taken: {elapsed_us}μs")

    print(
        f"{format_file_size(len(data))} => {format_file_size(len(out))}",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
