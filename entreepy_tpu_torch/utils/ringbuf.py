"""Fixed-capacity ring-buffer FIFO (reference parity: ``queue.zig:9-42``).

The reference's two-queue Huffman tree build runs on a generic comptime
``Queue(T, length)`` — a preallocated circular buffer with ``enqueue`` /
``dequeue`` / ``peek`` and ``QueueFull`` / ``QueueEmpty`` errors. This is the
framework's equivalent: a preallocated Python ring (no per-element
allocation, capacity fixed at construction) with the same operation set and
failure semantics. ``format/huffman.py`` builds its leaf/sapling queues on
it, mirroring the reference's fixed ``[513]?Node`` arena discipline
(``encode.zig:82``).

Behavioral contract (the JAX package's tests/test_ringbuf.py pins its
original, mirroring the six reference unit tests ``queue.zig:45-112``):
  * ``enqueue`` on a full queue raises :class:`QueueFull`.
  * ``dequeue`` on an empty queue raises :class:`QueueEmpty`.
  * ``peek`` returns ``None`` when empty (the reference returns ``null``).
  * FIFO order survives wrap-around across arbitrary enqueue/dequeue cycles.
"""

from __future__ import annotations

from typing import Generic, Optional, TypeVar

T = TypeVar("T")


class QueueError(Exception):
    """Base class for ring-queue failures (``queue.zig:3-7``)."""


class QueueFull(QueueError):
    """enqueue() on a queue holding ``capacity`` items (``queue.zig:19``)."""


class QueueEmpty(QueueError):
    """dequeue() on an empty queue (``queue.zig:28-30``)."""


class RingQueue(Generic[T]):
    """Fixed-capacity FIFO over one preallocated buffer.

    Unlike :class:`collections.deque`, capacity is a hard bound chosen up
    front — exceeding it is an error, not a growth — which is the property
    the reference's tree build relies on (a ``[513]`` arena can never need
    more than 256 leaves + 255 internal nodes + the final root; overflow
    would mean the build logic itself is wrong).
    """

    __slots__ = ("_buf", "_front", "_count")

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self._buf: list[Optional[T]] = [None] * capacity
        self._front = 0
        self._count = 0

    @property
    def capacity(self) -> int:
        return len(self._buf)

    def __len__(self) -> int:
        return self._count

    def __bool__(self) -> bool:
        return self._count > 0

    def enqueue(self, value: T) -> None:
        if self._count == len(self._buf):
            raise QueueFull(f"queue at capacity {len(self._buf)}")
        self._buf[(self._front + self._count) % len(self._buf)] = value
        self._count += 1

    def dequeue(self) -> T:
        if self._count == 0:
            raise QueueEmpty("dequeue from empty queue")
        value = self._buf[self._front]
        self._buf[self._front] = None  # drop the reference for GC
        self._front = (self._front + 1) % len(self._buf)
        self._count -= 1
        return value  # type: ignore[return-value]

    def peek(self) -> Optional[T]:
        """Front element without consuming it; ``None`` when empty."""
        if self._count == 0:
            return None
        return self._buf[self._front]
