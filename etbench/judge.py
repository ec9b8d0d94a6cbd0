"""The comparison that decides ``correct``.

Every output the window keeps (:class:`Sample`, at most ``KEEP`` of them,
drawn from the seed) is compared byte for byte with what the plain
reference says it must be: the document for a ``decompress`` (under the
call's own labels, ``traffic``), the reference writer's ``.et`` file for a
``compress``. The numbers compared,
each with its limit (exact comparisons, so 0):

* ``mismatched_bytes`` — over the compared outputs, the positions where an
  output and its reference differ, plus the difference of their lengths;
* ``failed_calls`` — calls that raised, in the window or in the warm-up.
"""

from __future__ import annotations

import random

import numpy as np

KEEP = 64
LIMITS = {"mismatched_bytes": 0, "failed_calls": 0}


class Sample:
    """A uniform sample of at most ``keep`` of the window's outputs
    (reservoir sampling driven by the run's seed), so a long window holds a
    bounded number of them."""

    def __init__(self, seed: int, keep: int = KEEP):
        self.rng = random.Random(seed)
        self.keep = keep
        self.items: list = []
        self.seen = 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.keep:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.keep:
                self.items[j] = item


def mismatched(out: bytes, ref: bytes) -> int:
    """Positions at which ``out`` and ``ref`` differ, plus their length gap."""
    if out == ref:
        return 0
    n = min(len(out), len(ref))
    a = np.frombuffer(out, dtype=np.uint8, count=n)
    b = np.frombuffer(ref, dtype=np.uint8, count=n)
    return int(np.count_nonzero(a != b)) + abs(len(out) - len(ref))


def judge(outputs, reference, failed: int) -> dict:
    """``{number: {"value", "limit"}}`` of the outputs ``[(key, bytes)]``
    against ``reference[key]`` (``traffic.Feed``: a key names the call's
    document and its labels), with ``failed`` calls that raised."""
    bad = sum(mismatched(out, reference[k]) for k, out in outputs)
    return {"mismatched_bytes": {"value": bad, "limit": LIMITS["mismatched_bytes"]},
            "failed_calls": {"value": failed, "limit": LIMITS["failed_calls"]}}


def is_correct(checks: dict, compared: int) -> bool:
    return compared > 0 and all(c["value"] <= c["limit"] for c in checks.values())
