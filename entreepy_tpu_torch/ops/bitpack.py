"""Device-side encode pieces: histogram and plane compaction of the packed words.

Counterpart of ``entreepy_tpu/ops/bitpack.py``. The block pack itself is
``ops/cuda_pack.pack_blocks``; the compaction runs through
``ops/cuda_compact.compact_rows``. The TPU's sort-based twins do not come
across. The single-device encode compacts the plane
(:func:`compact_plane_rows`) and stitches it into the ``.et`` body's bytes
on the card (``ops/cuda_stitch``); the sharded encode packs the plane into
one flat stream on the device first (:func:`compact_payload_flat`), so only
about the compressed size crosses to the host and between ranks, and
stitches it on the host. :func:`assemble_plane_payload`, the host's slicing
of a fetched plane, serves the tests' comparison with the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda_compact import compact_rows

CAP_G_ROUND = 16  # subgroup payload caps round up to this
PLANE_SUB = 256  # plane-compaction subgroup width (slots); must divide the block size


def histogram_device(data: torch.Tensor) -> torch.Tensor:
    """256-bin histogram of a uint8 tensor -> int64[256] on its device. (The
    JAX version's compare-reduce over padded columns only avoided TPU
    scatters.)"""
    return torch.bincount(data, minlength=256)


def plane_sub_for(steps: int) -> int:
    return PLANE_SUB if steps % PLANE_SUB == 0 else steps


def grouped_counts_plane(emitted: torch.Tensor) -> torch.Tensor:
    """Per-(lane, plane-subgroup) emitted-word counts int32[lanes, G] — the
    tiny sizing fetch for :func:`compact_payload_plane`'s cap."""
    lanes, steps = emitted.shape
    sub = plane_sub_for(steps)
    return emitted.reshape(lanes, steps // sub, sub).sum(2, dtype=torch.int32)


def plane_cap_g(max_g: int, steps: int) -> int:
    """Subgroup payload width covering the fullest subgroup, rounded up to
    CAP_G_ROUND columns."""
    sub = plane_sub_for(steps)
    return min(-(-max(max_g, 1) // CAP_G_ROUND) * CAP_G_ROUND, sub)


def compact_plane_rows(words: torch.Tensor, emitted: torch.Tensor, cap_g: int):
    """The compaction kernel over the pack's words, per (PLANE_SUB-slot
    subgroup, lane), as it writes them: (plane_k int32[G*cap, lanes] —
    row g*cap + j of lane l is block l's j-th emitted word of subgroup g,
    counts_k int32[G, lanes]), cap = min(``cap_g``, the subgroup width).
    ``words`` and ``emitted`` are the pack's transposed [lanes, steps] views,
    so their k-major layout goes to the kernel without a copy."""
    steps = words.shape[1]
    sub = plane_sub_for(steps)
    wk = words.view(torch.int32).t().contiguous()  # [steps, lanes]
    ek = emitted.t().contiguous()
    return compact_rows(wk, ek, sub, min(cap_g, sub))


def compact_payload_plane(words: torch.Tensor, emitted: torch.Tensor,
                          acc: torch.Tensor, nbits: torch.Tensor, cap_g: int):
    """Per-(lane, PLANE_SUB-slot subgroup) stable compaction of the emitted
    words, lane-major, whose live prefixes :func:`compact_payload_flat`
    selects on the device (and :func:`assemble_plane_payload` on the host).

    words uint32[lanes, steps], emitted bool[lanes, steps] (the pack's
    transposed k-major views), acc uint32[lanes], nbits int32[lanes].
    ``cap_g`` must cover the fullest subgroup (size it with
    :func:`grouped_counts_plane` + :func:`plane_cap_g`); if it does not,
    ``bit_lens`` are poisoned to -1 and the stitch raises.

    Returns (plane uint32[lanes, G*cap_g + 1] — the final partial word in the
    last column, counts_g int32[lanes, G], bit_lens int32[lanes])."""
    lanes, _ = words.shape
    plane_k, counts_k = compact_plane_rows(words, emitted, cap_g)
    g = counts_k.shape[0]
    cg = plane_k.shape[0] // g
    pay = plane_k.reshape(g, cg, lanes).permute(2, 0, 1).reshape(lanes, g * cg)
    counts_g = counts_k.t()
    overflow = counts_g.max() > cg
    plane = torch.cat([pay, acc.view(torch.int32)[:, None]], dim=1)
    bit_lens = torch.where(overflow, -1, counts_g.sum(1, dtype=torch.int32) * 32 + nbits)
    return plane.view(torch.uint32), counts_g, bit_lens


def compact_payload_flat(words: torch.Tensor, emitted: torch.Tensor, acc: torch.Tensor,
                         nbits: torch.Tensor, cap_g: int):
    """Two-stage device compaction to ONE flat word stream.

    Stage 1 is :func:`compact_payload_plane` (the compaction kernel; size
    ``cap_g`` with :func:`grouped_counts_plane` + :func:`plane_cap_g`, and
    an overflow poisons ``bit_lens`` to -1). Stage 2 selects every lane's
    live prefix of each subgroup and its final partial word, in (lane,
    subgroup, slot) order, into one stream: what leaves the device is the
    compressed stream, not the plane's per-subgroup cap slack.

    Returns (flat uint32[sum(nwords)], nwords int32[lanes] = count + 1 per
    lane, bit_lens int32[lanes]). Lane l's words live at
    ``flat[sum(nwords[:l]) : sum(nwords[:l+1])]``."""
    plane, counts_g, bit_lens = compact_payload_plane(words, emitted, acc, nbits, cap_g)
    lanes, g = counts_g.shape
    cg = (plane.shape[1] - 1) // g
    slot = torch.arange(cg, device=plane.device)
    live = torch.cat([(slot[None, None, :] < counts_g[:, :, None]).reshape(lanes, g * cg),
                      torch.ones(lanes, 1, dtype=torch.bool, device=plane.device)], dim=1)
    flat = torch.masked_select(plane.view(torch.int32), live)
    return flat.view(torch.uint32), counts_g.sum(1, dtype=torch.int32) + 1, bit_lens


def assemble_plane_payload(
    plane: np.ndarray, counts_g: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Host tail of :func:`compact_payload_plane`: slice each subgroup's
    live prefix (+ the per-lane final partial word) out of the fetched plane
    in one boolean extraction. Returns (flat uint32 — every block's words
    back to back, nwords int64[lanes] = count + 1) for
    ``stitch_flat_payload``."""
    lanes, g = counts_g.shape
    cap_g = (plane.shape[1] - 1) // g if g else 0
    jmask = (
        np.arange(cap_g, dtype=np.int64)[None, None, :]
        < counts_g[:, :, None]
    ).reshape(lanes, g * cap_g)
    mask = np.concatenate([jmask, np.ones((lanes, 1), bool)], axis=1)
    flat = np.ascontiguousarray(plane)[mask]  # row-major == (lane, subgroup, slot)
    nwords = counts_g.sum(axis=1).astype(np.int64) + 1
    return flat, nwords
