"""entreepy-compatible command-line interface of the PyTorch port.

``python -m entreepy_tpu_torch`` has the reference surface of the JAX
package's CLI: commands ``c``/``d``, the flags ``-p/-t/-d/-o`` and their
long forms, the default output names, the size summary on stderr, the ``-d``
dictionary dump and the progress bar. The parser, the naming, the help
text's reference part and the dump are the port's own copies of the JAX
package's; :func:`main` runs the port's ``api``. ``--backend`` takes
``host``, ``device`` or ``sharded`` (in one process, every card it sees,
one rank per card; in a ``torch.distributed`` group, e.g. one process per
card under ``torchrun``, one rank per process). A backend that cannot run, such as a device backend without a
CUDA device, exits 1 with ``error: ...``.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from pathlib import PurePath

from . import api
from .format import DegenerateInputError, FormatError
from .utils.fmt import format_file_size
from .utils.progress import ProgressBar

# Byte-exact copy of the reference's help text (``main.zig:45-67``); the
# port's additions live in a separate section appended below so the
# reference surface stays byte-identical.
REFERENCE_HELP_TEXT = """Entreepy - Text compression tool

Usage: entreepy [options] [command] [file] [command options]

Options:
    -h, --help     show help
    -p, --print    print decompressed text to stdout
    -t, --test     test/dry run, does not write to file
    -d, --debug    print huffman code dictionary and performance times to stdout

Commands:
    c    compress a file
    d    decompress a file

Command Options:
    -o, --output    output file (default: [file].et or decoded_[file])

Examples:
    entreepy -d c text.txt -o text.txt.et
    entreepy -ptd d text.txt.et -o decoded_text.txt
"""

HELP_TEXT = REFERENCE_HELP_TEXT + """
PyTorch/CUDA extensions:
    --backend       force a codec backend: host | device | sharded
                    (sharded: every CUDA card of this process, one rank
                    per card; default: auto — for large inputs, sharded
                    where there is more than one card or rank, else device
                    on a CUDA card)
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


class CliError(Exception):
    """Invalid command line; message already user-formatted."""


@dataclass
class Options:
    print_output: bool = False
    debug: bool = False
    dry: bool = False
    mode: str = "none"  # none | compress | decompress
    file_in: str = ""
    file_out: str = ""
    backend: str | None = None
    extra: dict = field(default_factory=dict)


LONG_FLAGS = {"help", "print", "debug", "test", "output", "backend"}


def parse_args(argv: list[str]) -> Options:
    """argv (without program name) -> Options. Raises CliError; mode='none'
    with no error means help was requested/printed-by-caller."""
    opts = Options()
    if not argv:
        return opts  # help

    state = "normal"  # normal | in_path | out_path | backend
    for arg in argv:
        if state == "in_path":
            opts.file_in = arg
            state = "normal"
            continue
        if state == "out_path":
            opts.file_out = arg
            state = "normal"
            continue
        if state == "backend":
            if arg not in ("host", "device", "sharded"):
                raise CliError(f"invalid backend: {arg} (want host, device or sharded)")
            opts.backend = arg
            state = "normal"
            continue
        if arg.startswith("--"):
            name = arg[2:]
            if name == "help":
                opts.mode = "none"
                opts.extra["help"] = True
                return opts
            if name == "print":
                opts.print_output = True
            elif name == "debug":
                opts.debug = True
            elif name == "test":
                opts.dry = True
            elif name == "output":
                state = "out_path"
            elif name == "backend":
                state = "backend"
            else:
                raise CliError(f"invalid option: {arg}")
        elif arg.startswith("-"):
            for c in arg[1:]:
                if c == "h":
                    opts.mode = "none"
                    opts.extra["help"] = True
                    return opts
                if c == "p":
                    opts.print_output = True
                elif c == "d":
                    opts.debug = True
                elif c == "t":
                    opts.dry = True
                elif c == "o":
                    state = "out_path"
                else:
                    raise CliError(f"invalid option: {arg}")
        elif arg in ("c", "d"):
            opts.mode = "compress" if arg == "c" else "decompress"
            state = "in_path"
        else:
            raise CliError(f"invalid command: {arg}")

    if state == "out_path":
        raise CliError("missing value after --output")
    if state == "backend":
        raise CliError("missing value after --backend")

    if opts.mode != "none" and not opts.file_in:
        raise CliError("no input file")

    if opts.mode != "none" and not opts.file_out:
        opts.file_out = default_output_name(opts.mode, opts.file_in)
    return opts


def default_output_name(mode: str, file_in: str) -> str:
    """Reference naming (``main.zig:154-170``), minus its Linux segfault."""
    if mode == "compress":
        return file_in + ".et"
    p = PurePath(file_in)
    name = p.name
    if name.endswith(".et"):
        name = name[: -len(".et")]
    return str(p.parent / f"decoded_{name}") if str(p.parent) != "." else f"decoded_{name}"


def _dump_dictionary(data: bytes) -> None:
    """-d dict dump: one ``{char} {byte} - {code bits}`` line per symbol in
    the reference's DFS emission order (``encode.zig:205-211``: right child
    pushed before left, so leaves print left-first — lexicographic order of
    the code bit-strings), followed by the reference's runtime
    prefix-collision audit (``encode.zig:221-247``)."""
    from .format import build_code_table, histogram

    try:
        table = build_code_table(histogram(data))
    except DegenerateInputError:
        return
    entries = [
        (format(int(table.codes[s]), f"0{int(table.lengths[s])}b"), s)
        for s in range(256)
        if table.lengths[s] > 0
    ]
    for bits, sym in sorted(entries):  # lexicographic bits == DFS left-first
        _write_raw(bytes([sym]) + f" {sym} - {bits}\n".encode("ascii"))
    _prefix_audit(table)


def _write_raw(payload: bytes) -> None:
    """Write raw bytes to stdout: the reference prints the symbol as its raw
    byte ({c} in Zig), which chr()+print would UTF-8-encode for values >=
    128 (or crash under a non-UTF-8 stdout). Falls back to a lossy text
    write when stdout has no binary buffer (in-process capture)."""
    buf = getattr(sys.stdout, "buffer", None)
    if buf is not None:
        sys.stdout.flush()
        buf.write(payload)
        buf.flush()
    else:
        sys.stdout.write(payload.decode("latin-1"))


def _prefix_audit(table) -> None:
    """Reference-faithful O(n^2) pairwise prefix audit (``encode.zig:221-247``,
    debug flag only there too). Never fires on a well-formed Huffman table;
    kept user-reachable for parity — message bytes match the reference
    (including its missing trailing newline)."""
    import numpy as np

    present = np.flatnonzero(np.asarray(table.lengths) > 0)
    if present.size == 0:
        return
    lens = np.asarray(table.lengths, dtype=np.int64)[present]
    codes = np.asarray(table.codes, dtype=np.int64)[present]
    # bit(i, k) = (code_i >> ((len_i - k) & 31)) & 1 depends on (i, k) only,
    # so the O(n^2 * L) pairwise audit vectorizes to one [n, n, L] compare.
    # The u5 shift truncation is the reference's (k=0 compares the bit above
    # the code's MSB, always 0 == 0 unless len=32).
    ks = np.arange(33, dtype=np.int64)[None, :]
    bits = (codes[:, None] >> ((lens[:, None] - ks) & 31)) & 1  # [n, 33]
    shorter = np.minimum(lens[:, None], lens[None, :])  # [n, n]
    in_range = ks[None, :, :] <= shorter[:, :, None]  # [n, n, 33]
    diff = bits[:, None, :] != bits[None, :, :]
    is_prefix = ~np.any(diff & in_range, axis=2)
    np.fill_diagonal(is_prefix, False)
    for a, b in np.argwhere(is_prefix):  # row-major == the reference's i, j order
        i, j = int(present[a]), int(present[b])
        _write_raw(
            b"Found colliding prefix codes for "
            + f"{i} ".encode("ascii") + bytes([i])
            + f" and {j} ".encode("ascii") + bytes([j])
        )


if __name__ == "__main__":
    sys.exit(main())
