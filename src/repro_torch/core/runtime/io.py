"""I/O syscall bypass (paper §V-D): target fds map to host-side files.

The fd table links target descriptors to host ``FileImage`` objects (the
same page-cached files the VM mmap path uses) or to the capture streams for
stdin/stdout/stderr.  Threads share one table (CLONE_FILES semantics).
Host-blocking reads are served through :class:`AsyncHostIO`, the auxiliary
host thread of Fig 7(b): the runtime parks the calling thread instead of
blocking the whole simulation, and completion is delivered on a later
scheduler pass.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .vm import FileImage


@dataclass
class OpenFile:
    file: FileImage
    pos: int = 0
    writable: bool = False


class FdTable:
    def __init__(self):
        self.fds: dict[int, object] = {}
        self.next_fd = 3
        self.stdout = bytearray()
        self.stderr = bytearray()
        self.stdin = bytearray()   # pre-seeded input
        self.files: dict[str, FileImage] = {}   # host "filesystem"

    # -- host-side filesystem -------------------------------------------
    def add_file(self, name: str, data: bytes) -> FileImage:
        f = FileImage(name, bytearray(data))
        self.files[name] = f
        return f

    def openat(self, path: str, flags: int) -> int:
        O_WRONLY, O_RDWR, O_CREAT = 1, 2, 0x40
        writable = bool(flags & (O_WRONLY | O_RDWR))
        f = self.files.get(path)
        if f is None:
            if not (flags & O_CREAT):
                return -2   # -ENOENT
            f = self.add_file(path, b"")
        fd = self.next_fd
        self.next_fd += 1
        self.fds[fd] = OpenFile(f, 0, writable)
        return fd

    def close(self, fd: int) -> int:
        return 0 if self.fds.pop(fd, None) is not None else -9

    def write(self, fd: int, data: bytes) -> int:
        if fd == 1:
            self.stdout += data
            return len(data)
        if fd == 2:
            self.stderr += data
            return len(data)
        of = self.fds.get(fd)
        if of is None or not of.writable:
            return -9
        end = of.pos + len(data)
        if end > len(of.file.data):
            of.file.data.extend(b"\0" * (end - len(of.file.data)))
        of.file.data[of.pos:end] = data
        of.pos = end
        return len(data)

    def read(self, fd: int, count: int) -> bytes | None:
        """None => would block (stdin with no data)."""
        if fd == 0:
            if not self.stdin:
                return None
            data = bytes(self.stdin[:count])
            del self.stdin[:count]
            return data
        of = self.fds.get(fd)
        if of is None:
            return b""
        data = bytes(of.file.data[of.pos:of.pos + count])
        of.pos += len(data)
        return data

    def lseek(self, fd: int, off: int, whence: int) -> int:
        of = self.fds.get(fd)
        if of is None:
            return -9
        if whence == 0:
            of.pos = off
        elif whence == 1:
            of.pos += off
        else:
            of.pos = len(of.file.data) + off
        return of.pos

    def fstat_size(self, fd: int) -> int:
        of = self.fds.get(fd)
        return len(of.file.data) if of is not None else 0


class AsyncHostIO:
    """Auxiliary host thread for blockable syscalls (paper Fig 7(b)).

    Deterministic model: a blocked read is parked with the data-arrival
    condition; ``poll`` completes it once the condition holds (e.g. stdin
    got data from the testbench between scheduler passes)."""

    def __init__(self, fdt: FdTable):
        self.fdt = fdt
        self.parked: list[tuple] = []   # (tid, fd, count, callback)

    def submit_read(self, tid: int, fd: int, count: int, callback):
        self.parked.append((tid, fd, count, callback))

    def poll(self):
        still = []
        for tid, fd, count, cb in self.parked:
            data = self.fdt.read(fd, count)
            if data is None:
                still.append((tid, fd, count, cb))
            else:
                cb(tid, data)
        self.parked = still

    @property
    def busy(self):
        return bool(self.parked)
