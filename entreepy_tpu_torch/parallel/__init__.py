"""Multi-device and multi-process block parallelism over ``torch.distributed``.

Counterpart of ``entreepy_tpu/parallel``: inputs split into independent
blocks, data-parallel over the ranks of a process group; the code table is
the same on every rank, per-block bitstreams and lengths are gathered and
stitched in order. Decoding splits the body into chunks over the ranks and
chains their entry states across ranks.
"""

from .mesh import make_mesh
from .dist import compress_sharded, decompress_sharded
from . import multihost

__all__ = ["make_mesh", "compress_sharded", "decompress_sharded", "multihost"]
