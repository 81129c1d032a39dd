"""
BGZF (blocked gzip) reading and writing.

BGZF is the container format of BAM and bgzipped VCF: a series of
concatenated gzip members, each at most 64 KiB of uncompressed payload, with
the compressed block size recorded in a gzip extra field (BC), terminated by
a fixed 28-byte EOF block.  Python's zlib is all we need; no htslib.
"""

import struct
import zlib
from typing import BinaryIO, Iterator, Optional

BGZF_MAGIC = b"\x1f\x8b\x08\x04"
# Fixed EOF marker block (empty payload), as specified in the SAM spec.
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)
MAX_BLOCK_SIZE = 65536


def is_gzip(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"\x1f\x8b"


def is_bgzf(path: str) -> bool:
    with open(path, "rb") as f:
        head = f.read(4)
    return head == BGZF_MAGIC


class BGZFReader:
    """Random-access BGZF reader with virtual file offsets.

    A virtual offset packs (compressed block start << 16 | intra-block
    offset), as used by BAI/TBI indexes.
    """

    def __init__(self, path: str):
        self._f: BinaryIO = open(path, "rb")
        self._block_start = 0  # compressed offset of current block
        self._buf = b""
        self._buf_pos = 0
        self._started = False

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()

    def _read_block_info(self, offset: int):
        """Return (bsize, xlen) of the block at the given offset, or None."""
        self._f.seek(offset)
        header = self._f.read(12)
        if len(header) < 12:
            return None
        if header[:4] != BGZF_MAGIC:
            raise ValueError("not a BGZF block")
        xlen = struct.unpack("<H", header[10:12])[0]
        extra = self._f.read(xlen)
        i = 0
        while i + 4 <= xlen:
            si1, si2 = extra[i], extra[i + 1]
            slen = struct.unpack("<H", extra[i + 2 : i + 4])[0]
            if si1 == 0x42 and si2 == 0x43 and slen == 2:
                bsize = struct.unpack("<H", extra[i + 4 : i + 6])[0] + 1
                return bsize, xlen
            i += 4 + slen
        raise ValueError("BGZF block without BC subfield")

    def _read_block_at(self, compressed_offset: int) -> Optional[bytes]:
        info = self._read_block_info(compressed_offset)
        if info is None:
            return None
        bsize, xlen = info
        # block = 12-byte header + xlen extra + cdata + 8-byte trailer
        cdata_len = bsize - xlen - 20
        self._f.seek(compressed_offset + 12 + xlen)
        cdata = self._f.read(cdata_len)
        return zlib.decompress(cdata, wbits=-15)

    def seek_virtual(self, voffset: int) -> None:
        block_offset = voffset >> 16
        intra = voffset & 0xFFFF
        payload = self._read_block_at(block_offset)
        if payload is None:
            payload = b""
        self._block_start = block_offset
        self._buf = payload
        self._buf_pos = intra
        self._started = True

    def tell_virtual(self) -> int:
        return (self._block_start << 16) | self._buf_pos

    def _advance_block(self) -> bool:
        # next block begins where the previous one ended
        next_offset = self._next_block_offset()
        payload = self._read_block_at(next_offset)
        if payload is None:
            return False
        self._block_start = next_offset
        self._buf = payload
        self._buf_pos = 0
        return True

    def _next_block_offset(self) -> int:
        info = self._read_block_info(self._block_start)
        assert info is not None
        return self._block_start + info[0]

    def read(self, n: int) -> bytes:
        out = bytearray()
        while n > 0:
            if self._buf_pos >= len(self._buf):
                if not self._started:
                    payload = self._read_block_at(0)
                    self._started = True
                    if payload is None:
                        break
                    self._buf, self._buf_pos = payload, 0
                elif not self._advance_block():
                    break
                continue
            take = min(n, len(self._buf) - self._buf_pos)
            out += self._buf[self._buf_pos : self._buf_pos + take]
            self._buf_pos += take
            n -= take
        return bytes(out)


class BGZFWriter:
    """Streaming BGZF writer (used for BAM output and .vcf.gz)."""

    def __init__(self, fileobj: BinaryIO, compresslevel: int = 6):
        self._f = fileobj
        self._level = compresslevel
        self._buf = bytearray()

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= 0xFF00:
            self._flush_block(self._buf[:0xFF00])
            del self._buf[:0xFF00]

    def _flush_block(self, payload: bytes) -> None:
        co = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        cdata = co.compress(bytes(payload)) + co.flush()
        # header(12) + extra(6) + cdata + crc(4) + isize(4)
        bsize = len(cdata) + 26
        header = (
            BGZF_MAGIC
            + b"\x00\x00\x00\x00"  # mtime
            + b"\x00\xff"  # XFL, OS
            + struct.pack("<H", 6)  # XLEN
            + b"BC"
            + struct.pack("<H", 2)
            + struct.pack("<H", bsize - 1)
        )
        crc = zlib.crc32(bytes(payload)) & 0xFFFFFFFF
        self._f.write(header + cdata + struct.pack("<II", crc, len(payload)))

    def flush(self) -> None:
        if self._buf:
            self._flush_block(self._buf)
            self._buf.clear()

    def close(self) -> None:
        self.flush()
        self._f.write(BGZF_EOF)
        self._f.flush()


def open_maybe_gzipped(path: str, mode: str = "rt"):
    """Open plain or gzip/bgzip-compressed text transparently (read)."""
    import gzip

    if is_gzip(str(path)):
        return gzip.open(path, mode)
    return open(path, mode)


def iter_bgzf_text_lines(path: str) -> Iterator[str]:
    import gzip

    with gzip.open(path, "rt") as f:
        yield from f
