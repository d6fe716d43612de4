"""Copy of ``uigc_tpu/runtime/shm_ring.py`` (pure Python).  What differs:
``_ring_dir`` puts the ring segments in ``$TMPDIR`` when the caller set
one, and in ``/dev/shm`` (else the system temp dir) otherwise, so a
process given a temp dir of its own keeps its segments there.

Single-producer/single-consumer shared-memory byte rings for
co-located node pairs.

When two ``NodeFabric`` processes share a host, every frame still paid
the full socket toll: two syscalls, two kernel copies, and the TCP
stack, per flush.  This module is the transport the co-location
negotiation (runtime/node.py, the ``"shm"`` hello capability) rides
instead: an mmap-backed byte ring per link *direction*, written only by
that direction's writer thread and read only by the peer's ring-reader
thread — SPSC by construction, so the hot path is two counter loads, a
memcpy and a counter store, with no lock and no atomic RMW (the same
coordination-free handoff discipline as the writer queue's deque).

The ring carries the *exact same wire bytes* the socket would (length-
prefixed units, ``"fb"`` batches and all), so sequence numbers,
FaultPlan verdicts, dead letters and codec negotiation are untouched —
the ring replaces only the syscall, never the protocol.

Layout (offsets in bytes):

    0   magic    4s   b"UR1\\n"
    4   capacity I    data-region size
    8   tail     Q    monotonic bytes produced (producer-owned)
    16  head     Q    monotonic bytes consumed (consumer-owned)
    24  flags    I    bit0 = poisoned (producer or consumer renounced)
    28  pad to 64
    64  data     capacity bytes, records wrap byte-wise
    record := ">I"(len) payload

Monotonic head/tail counters (never wrapped themselves) make full/empty
unambiguous: ``used = tail - head``, full at ``used + need > capacity``.
Each counter has exactly one writing side; 8-byte aligned stores are
not torn on the platforms this runs on, and in-process pairs (the test
and bench topology) additionally serialize under the GIL.

Backing is a file mapped with ``mmap`` — ``/dev/shm`` when present —
rather than ``multiprocessing.shared_memory``: attach-by-name is a
plain ``open``, no resource-tracker process, and the mapping survives
an early unlink (POSIX), so a crashing creator can never strand the
peer on a vanished name mid-read.

Poisoning is the ring's only control signal: either side sets the flag
to renounce the ring (producer: falling back to the socket; owner:
``die()``/teardown).  Data already in the ring stays readable after
poison — the recovery drain depends on that.
"""

from __future__ import annotations

import mmap
import os
import struct
import tempfile
from typing import Optional

MAGIC = b"UR1\n"
_HDR = struct.Struct(">4sI")  # magic, capacity
_OFF_TAIL = 8
_OFF_HEAD = 16
_OFF_FLAGS = 24
_DATA = 64
_LEN = struct.Struct(">I")
_CTR = struct.Struct(">Q")
_FLAGS = struct.Struct(">I")

_POISONED = 1


def _ring_dir() -> str:
    if os.environ.get("TMPDIR"):
        return tempfile.gettempdir()
    return "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()


class RingError(Exception):
    """The segment is missing, malformed, or of the wrong version."""


class ShmRing:
    """One direction of a co-located link.  ``write`` is producer-only,
    ``read`` consumer-only; the owning threads enforce that contract
    (runtime/node.py: the peer writer produces, the ring reader — or
    the recovery drain, under the rx lock — consumes)."""

    __slots__ = ("name", "capacity", "_mm", "_file", "_creator", "_closed")

    def __init__(self, name: str, mm: mmap.mmap, capacity: int, creator: bool):
        self.name = name
        self.capacity = capacity
        self._mm = mm
        self._creator = creator
        self._closed = False

    # -- lifecycle --------------------------------------------------- #

    @classmethod
    def create(cls, capacity: int) -> "ShmRing":
        capacity = max(4096, int(capacity))
        fd, path = tempfile.mkstemp(prefix="uigc-ring-", dir=_ring_dir())
        try:
            os.ftruncate(fd, _DATA + capacity)
            mm = mmap.mmap(fd, _DATA + capacity)
        finally:
            os.close(fd)
        mm[0:_HDR.size] = _HDR.pack(MAGIC, capacity)
        return cls(path, mm, capacity, creator=True)

    @classmethod
    def attach(cls, name: str) -> "ShmRing":
        try:
            fd = os.open(name, os.O_RDWR)
        except OSError as exc:
            raise RingError(f"cannot open ring segment {name!r}: {exc}") from exc
        try:
            size = os.fstat(fd).st_size
            if size < _DATA:
                raise RingError(f"ring segment {name!r} too small ({size}B)")
            mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        magic, capacity = _HDR.unpack_from(mm, 0)
        if magic != MAGIC or size < _DATA + capacity:
            mm.close()
            raise RingError(f"ring segment {name!r} is not a UR1 ring")
        return cls(name, mm, capacity, creator=False)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._mm.close()
        except (BufferError, ValueError):  # pragma: no cover - defensive
            pass
        if self._creator:
            try:
                os.unlink(self.name)
            except OSError:
                pass

    # -- control ----------------------------------------------------- #

    @property
    def poisoned(self) -> bool:
        if self._closed:
            return True
        return bool(_FLAGS.unpack_from(self._mm, _OFF_FLAGS)[0] & _POISONED)

    def poison(self) -> None:
        """Renounce the ring.  Idempotent; readable data survives."""
        if self._closed:
            return
        flags = _FLAGS.unpack_from(self._mm, _OFF_FLAGS)[0]
        _FLAGS.pack_into(self._mm, _OFF_FLAGS, flags | _POISONED)

    # -- data plane --------------------------------------------------- #

    def _tail(self) -> int:
        return _CTR.unpack_from(self._mm, _OFF_TAIL)[0]

    def _head(self) -> int:
        return _CTR.unpack_from(self._mm, _OFF_HEAD)[0]

    def used(self) -> int:
        return self._tail() - self._head()

    def write(self, data: bytes) -> bool:
        """Append one record.  False when the record does not fit
        (ring full — the producer's backpressure signal) or the record
        could never fit at all (caller splits or falls back)."""
        if self._closed:
            return False
        need = _LEN.size + len(data)
        if need > self.capacity:
            return False
        mm = self._mm
        tail = self._tail()
        if need > self.capacity - (tail - self._head()):
            return False
        self._copy_in(tail, _LEN.pack(len(data)))
        self._copy_in(tail + _LEN.size, data)
        _CTR.pack_into(mm, _OFF_TAIL, tail + need)
        return True

    def read(self) -> Optional[bytes]:
        """Pop one record, or None when the ring is empty."""
        if self._closed:
            return None
        head = self._head()
        if self._tail() - head < _LEN.size:
            return None
        n = _LEN.unpack(self._copy_out(head, _LEN.size))[0]
        data = self._copy_out(head + _LEN.size, n)
        _CTR.pack_into(self._mm, _OFF_HEAD, head + _LEN.size + n)
        return data

    def _copy_in(self, pos: int, data: bytes) -> None:
        mm = self._mm
        cap = self.capacity
        off = pos % cap
        first = min(len(data), cap - off)
        mm[_DATA + off : _DATA + off + first] = data[:first]
        if first < len(data):
            rest = len(data) - first
            mm[_DATA : _DATA + rest] = data[first:]

    def _copy_out(self, pos: int, n: int) -> bytes:
        mm = self._mm
        cap = self.capacity
        off = pos % cap
        first = min(n, cap - off)
        data = mm[_DATA + off : _DATA + off + first]
        if first < n:
            data += mm[_DATA : _DATA + (n - first)]
        return data


def pid_alive(pid: int) -> bool:
    """Best-effort peer-process liveness (the ring's crash detector).
    A pid we may not signal still EXISTS (EPERM), so only ESRCH — and a
    nonsensical pid — read as dead."""
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:  # pragma: no cover - exists, not ours
        return True
    except OSError:  # pragma: no cover - defensive
        return False
    return True


def selfcheck(verbose: bool = False) -> bool:
    """Standalone exerciser for the verify pass: create/attach a pair,
    prove FIFO integrity across many wraparounds, full-ring refusal,
    poison visibility and post-poison drainability."""
    ring = ShmRing.create(8192)
    try:
        peer = ShmRing.attach(ring.name)
        try:
            # FIFO across wraparound: far more bytes than capacity.
            import hashlib

            seed = 0
            sent = []
            received = []
            for round_no in range(200):
                data = hashlib.blake2b(
                    str(seed).encode(), digest_size=32
                ).digest() * (1 + round_no % 7)
                seed += 1
                if not ring.write(data):
                    # full: drain everything, then retry
                    while True:
                        got = peer.read()
                        if got is None:
                            break
                        received.append(got)
                    if not ring.write(data):
                        return False
                sent.append(data)
            while True:
                got = peer.read()
                if got is None:
                    break
                received.append(got)
            if received != sent:
                return False
            # Full-ring refusal: an over-capacity record never fits.
            if ring.write(b"x" * 9000):
                return False
            # Poison: visible to both sides, data still drains.
            if not ring.write(b"tail-record"):
                return False
            ring.poison()
            if not peer.poisoned:
                return False
            if peer.read() != b"tail-record":
                return False
            if verbose:
                print(
                    f"shm_ring selfcheck OK: {len(sent)} records, "
                    f"{sum(len(d) for d in sent)} bytes through an "
                    f"8KiB ring at {ring.name}"
                )
            return True
        finally:
            peer.close()
    finally:
        ring.close()


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(0 if selfcheck(verbose=True) else 1)
