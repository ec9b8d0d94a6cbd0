"""entreepy_tpu_torch — the Huffman codec of ``entreepy_tpu`` on PyTorch and CUDA.

Same ``.et`` format and public API as ``entreepy_tpu``; the single-device
``device`` backend runs hand-written CUDA kernels for Hopper (``csrc/``),
bundled in a wheel built with ``nvcc``, else built with ``nvcc`` at first use. The host layers are the port's own copies
of the JAX package's framework-free modules (``format``, ``runtime`` with its
C++ host runtime, ``utils``): this package imports nothing of ``entreepy_tpu``
and never imports JAX.

    >>> import entreepy_tpu_torch as et
    >>> packed = et.compress(b"an example body of text")            # on cuda
    >>> et.decompress(packed)
    b'an example body of text'
"""

__version__ = "0.1.0"

from .api import (  # noqa: E402
    compress,
    compress_file,
    decompress,
    decompress_file,
    inspect,
)

__all__ = [
    "compress",
    "compress_file",
    "decompress",
    "decompress_file",
    "inspect",
    "__version__",
]
