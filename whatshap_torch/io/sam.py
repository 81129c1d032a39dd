"""
Native BAM/SAM reading and BAM writing with a pysam-like surface
(AlignmentFile / AlignedSegment).  No htslib.

BAM layout (SAM spec section 4): BGZF stream; magic ``BAM\\1``; SAM header
text; reference dictionary; then one binary record per alignment.  Sequences
are 4-bit packed, qualities raw phred, tags typed.

Region fetch requires an index to exist (.bai/.csi, like htslib).  When a
.bai is present its linear index is used to seek to the first candidate
BGZF block for the region (see ``fetch``), falling back to a full scan with
filtering for .csi or missing linear-index entries.
"""

import binascii
import os
import re
import struct
from typing import Dict, Iterator, List, Optional, Tuple

from .bgzf import BGZFReader, BGZFWriter

BAM_MAGIC = b"BAM\x01"


def __getattr__(name):
    # convenience: expose the VCF layer under this module too, so code
    # written against a single pysam-like namespace keeps working
    if name == "VariantFile":
        from .vcflib import VariantFile

        return VariantFile
    raise AttributeError(name)

CIGAR_OPS = "MIDNSHP=X"
CIGAR_OP_CODE = {c: i for i, c in enumerate(CIGAR_OPS)}
# ops that consume reference positions
_REF_CONSUMING = {0, 2, 3, 7, 8}
_QUERY_CONSUMING = {0, 1, 4, 7, 8}

SEQ_DECODE = "=ACMGRSVTWYHKDBN"
SEQ_ENCODE = {c: i for i, c in enumerate(SEQ_DECODE)}
_SEQ_HEX_TRANS = bytes.maketrans(b"0123456789abcdef", SEQ_DECODE.encode())

# encode direction: base byte -> hex digit of its 4-bit code (lowercase
# bases map like their uppercase forms; anything else -> 15, as the dict
# lookup with default did)
_SEQ_ENC_TRANS = bytearray(b"f" * 256)
for _c, _i in SEQ_ENCODE.items():
    _SEQ_ENC_TRANS[ord(_c)] = b"0123456789abcdef"[_i]
    _SEQ_ENC_TRANS[ord(_c.lower())] = b"0123456789abcdef"[_i]
_SEQ_ENC_TRANS = bytes(_SEQ_ENC_TRANS)


# Process-wide cache of native-decoded BAM pools, keyed by
# (path, size, mtime_ns).  Bounded by total decoded bytes; oldest entries
# evict first.  clear_bam_pool_cache() exists so benchmarks can charge each
# timed run the full fresh-process decode cost.
_BAM_POOL_CACHE: "dict[tuple, tuple]" = {}
_BAM_POOL_CACHE_MAX_BYTES = 1 << 30


def _bam_pool_cache_put(key, value):
    if len(value[0]) > _BAM_POOL_CACHE_MAX_BYTES:
        return
    _BAM_POOL_CACHE[key] = value
    total = sum(len(v[0]) for v in _BAM_POOL_CACHE.values())
    for k in list(_BAM_POOL_CACHE):
        if total <= _BAM_POOL_CACHE_MAX_BYTES:
            break
        if k == key:
            continue
        total -= len(_BAM_POOL_CACHE[k][0])
        del _BAM_POOL_CACHE[k]


def clear_bam_pool_cache():
    _BAM_POOL_CACHE.clear()


class AlignmentFileNotIndexedError(Exception):
    pass


class AlignedSegment:
    __slots__ = (
        "query_name",
        "flag",
        "reference_id",
        "reference_start",
        "mapping_quality",
        "cigartuples",
        "next_reference_id",
        "next_reference_start",
        "template_length",
        "query_sequence",
        "query_qualities",
        "tags",
        "header",
    )

    def __init__(self, header: Optional["AlignmentHeader"] = None):
        self.query_name: str = ""
        self.flag: int = 0
        self.reference_id: int = -1
        self.reference_start: int = -1
        self.mapping_quality: int = 0
        self.cigartuples: Optional[List[Tuple[int, int]]] = None
        self.next_reference_id: int = -1
        self.next_reference_start: int = -1
        self.template_length: int = 0
        self.query_sequence: Optional[str] = None
        self.query_qualities: Optional[List[int]] = None
        self.tags: Dict[str, object] = {}
        self.header = header

    # --- flags ----------------------------------------------------------
    def _set_flag_bit(self, bit: int, value: bool) -> None:
        if value:
            self.flag |= bit
        else:
            self.flag &= ~bit

    @property
    def is_paired(self) -> bool:
        return bool(self.flag & 1)

    @property
    def is_proper_pair(self) -> bool:
        return bool(self.flag & 2)

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & 4)

    @property
    def mate_is_unmapped(self) -> bool:
        return bool(self.flag & 8)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & 16)

    @property
    def is_read1(self) -> bool:
        return bool(self.flag & 64)

    @property
    def is_read2(self) -> bool:
        return bool(self.flag & 128)

    @property
    def is_secondary(self) -> bool:
        return bool(self.flag & 256)

    @property
    def is_qcfail(self) -> bool:
        return bool(self.flag & 512)

    @property
    def is_duplicate(self) -> bool:
        return bool(self.flag & 1024)

    @is_duplicate.setter
    def is_duplicate(self, value: bool) -> None:
        self._set_flag_bit(1024, value)

    @property
    def is_supplementary(self) -> bool:
        return bool(self.flag & 2048)

    @is_supplementary.setter
    def is_supplementary(self, value: bool) -> None:
        self._set_flag_bit(2048, value)

    # --- derived --------------------------------------------------------
    @property
    def mapq(self) -> int:
        return self.mapping_quality

    @property
    def reference_name(self) -> Optional[str]:
        if self.reference_id < 0 or self.header is None:
            return None
        return self.header.references[self.reference_id]

    @property
    def next_reference_name(self) -> Optional[str]:
        if self.next_reference_id < 0 or self.header is None:
            return None
        return self.header.references[self.next_reference_id]

    @property
    def reference_end(self) -> Optional[int]:
        if self.reference_start < 0 or not self.cigartuples:
            return None
        length = sum(l for op, l in self.cigartuples if op in _REF_CONSUMING)
        return self.reference_start + length

    @property
    def reference_length(self) -> Optional[int]:
        end = self.reference_end
        if end is None:
            return None
        return end - self.reference_start

    @property
    def query_length(self) -> int:
        if self.query_sequence is None:
            return 0
        return len(self.query_sequence)

    def infer_query_length(self) -> Optional[int]:
        """Query length inferred from the CIGAR (excluding hard clips)."""
        if not self.cigartuples:
            return None
        return sum(l for op, l in self.cigartuples if op in _QUERY_CONSUMING)

    @property
    def cigarstring(self) -> Optional[str]:
        if not self.cigartuples:
            return None
        return "".join(f"{l}{CIGAR_OPS[op]}" for op, l in self.cigartuples)

    @property
    def pos(self) -> int:
        return self.reference_start

    @property
    def qual(self) -> Optional[str]:
        """Base qualities as a phred+33 string (legacy pysam attribute)."""
        if self.query_qualities is None:
            return None
        return "".join(chr(q + 33) for q in self.query_qualities)

    # --- tags -----------------------------------------------------------
    def has_tag(self, tag: str) -> bool:
        return tag in self.tags

    def get_tag(self, tag: str):
        return self.tags[tag]

    def set_tag(self, tag: str, value, value_type=None) -> None:
        if value is None:
            self.tags.pop(tag, None)
        else:
            self.tags[tag] = value

    def get_tags(self):
        return list(self.tags.items())

    def opt(self, tag: str):
        """Legacy pysam alias for get_tag."""
        return self.tags[tag]

    def __repr__(self):
        return (
            f"AlignedSegment({self.query_name!r}, flag={self.flag}, "
            f"ref={self.reference_name}, pos={self.reference_start})"
        )


class AlignmentHeader:
    def __init__(self, text: str = "", references=(), lengths=()):
        self.text = text
        self.references: List[str] = list(references)
        self.lengths: List[int] = list(lengths)
        self._ref_to_id = {name: i for i, name in enumerate(self.references)}

    def get_reference_id(self, name: str) -> int:
        return self._ref_to_id.get(name, -1)

    def to_dict(self) -> Dict[str, object]:
        out: Dict[str, object] = {}
        for line in self.text.splitlines():
            if not line.startswith("@"):
                continue
            kind = line[1:3]
            if kind == "CO":
                out.setdefault("CO", []).append(line[4:])
                continue
            fields = line.split("\t")[1:]
            d = {}
            for f in fields:
                if ":" in f:
                    k, v = f.split(":", 1)
                    d[k] = v
            if kind == "HD":
                out["HD"] = d
            else:
                out.setdefault(kind, []).append(d)
        # ensure SQ entries exist even if text header lacks them
        if "SQ" not in out and self.references:
            out["SQ"] = [
                {"SN": n, "LN": str(l)} for n, l in zip(self.references, self.lengths)
            ]
        return out

    def get(self, key, default=None):
        return self.to_dict().get(key, default)

    def __contains__(self, key):
        return key in self.to_dict()

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "AlignmentHeader":
        lines = []
        references = []
        lengths = []
        if "HD" in d:
            lines.append("@HD\t" + "\t".join(f"{k}:{v}" for k, v in d["HD"].items()))
        for kind in ("SQ", "RG", "PG"):
            for entry in d.get(kind, []):
                lines.append(
                    f"@{kind}\t" + "\t".join(f"{k}:{v}" for k, v in entry.items())
                )
                if kind == "SQ":
                    references.append(entry["SN"])
                    lengths.append(int(entry["LN"]))
        for comment in d.get("CO", []):
            lines.append(f"@CO\t{comment}")
        text = "\n".join(lines) + ("\n" if lines else "")
        return cls(text, references, lengths)


def _parse_tags(buf: bytes) -> Dict[str, object]:
    tags: Dict[str, object] = {}
    off = 0
    n = len(buf)
    while off + 3 <= n:
        tag = buf[off : off + 2].decode()
        typ = chr(buf[off + 2])
        off += 3
        if typ == "A":
            tags[tag] = chr(buf[off])
            off += 1
        elif typ == "c":
            tags[tag] = struct.unpack_from("<b", buf, off)[0]
            off += 1
        elif typ == "C":
            tags[tag] = buf[off]
            off += 1
        elif typ == "s":
            tags[tag] = struct.unpack_from("<h", buf, off)[0]
            off += 2
        elif typ == "S":
            tags[tag] = struct.unpack_from("<H", buf, off)[0]
            off += 2
        elif typ == "i":
            tags[tag] = struct.unpack_from("<i", buf, off)[0]
            off += 4
        elif typ == "I":
            tags[tag] = struct.unpack_from("<I", buf, off)[0]
            off += 4
        elif typ == "f":
            tags[tag] = struct.unpack_from("<f", buf, off)[0]
            off += 4
        elif typ in ("Z", "H"):
            end = buf.index(b"\x00", off)
            tags[tag] = buf[off:end].decode()
            off = end + 1
        elif typ == "B":
            sub = chr(buf[off])
            (cnt,) = struct.unpack_from("<I", buf, off + 1)
            off += 5
            fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I", "f": "f"}[sub]
            size = struct.calcsize(fmt)
            vals = list(struct.unpack_from(f"<{cnt}{fmt}", buf, off))
            off += size * cnt
            tags[tag] = vals
        else:
            raise ValueError(f"unknown tag type {typ!r}")
    return tags


def _encode_tags(tags: Dict[str, object]) -> bytes:
    out = bytearray()
    for tag, value in tags.items():
        t = tag.encode()
        if isinstance(value, str) and len(value) == 1 and tag in ("XT",):
            out += t + b"A" + value.encode()
        elif isinstance(value, bool):
            out += t + b"i" + struct.pack("<i", int(value))
        elif isinstance(value, int):
            out += t + b"i" + struct.pack("<i", value)
        elif isinstance(value, float):
            out += t + b"f" + struct.pack("<f", value)
        elif isinstance(value, str):
            out += t + b"Z" + value.encode() + b"\x00"
        elif isinstance(value, (list, tuple)):
            if all(isinstance(v, int) for v in value):
                out += t + b"B" + b"i" + struct.pack("<I", len(value))
                out += struct.pack(f"<{len(value)}i", *value)
            else:
                out += t + b"B" + b"f" + struct.pack("<I", len(value))
                out += struct.pack(f"<{len(value)}f", *[float(v) for v in value])
        else:
            raise ValueError(f"cannot encode tag {tag}={value!r}")
    return bytes(out)


def parse_bam_record(data: bytes, header: AlignmentHeader) -> AlignedSegment:
    seg = AlignedSegment(header)
    (
        ref_id,
        pos,
        l_read_name,
        mapq,
        _bin,
        n_cigar,
        flag,
        l_seq,
        next_ref_id,
        next_pos,
        tlen,
    ) = struct.unpack_from("<iiBBHHHiiii", data, 0)
    seg.reference_id = ref_id
    seg.reference_start = pos
    seg.mapping_quality = mapq
    seg.flag = flag
    seg.next_reference_id = next_ref_id
    seg.next_reference_start = next_pos
    seg.template_length = tlen
    off = 32
    seg.query_name = data[off : off + l_read_name - 1].decode()
    off += l_read_name
    if n_cigar:
        raw = struct.unpack_from(f"<{n_cigar}I", data, off)
        seg.cigartuples = [(c & 0xF, c >> 4) for c in raw]
        off += 4 * n_cigar
    else:
        seg.cigartuples = None
    if l_seq:
        nbytes = (l_seq + 1) // 2
        # 4-bit codes -> hex digits -> bases, all in C
        seg.query_sequence = (
            binascii.hexlify(data[off : off + nbytes])
            .translate(_SEQ_HEX_TRANS)[:l_seq]
            .decode()
        )
        off += nbytes
        quals = data[off : off + l_seq]
        if quals and quals[0] != 0xFF:
            # kept as bytes (indexing/iteration yield ints, same as pysam's
            # array view) — avoids materializing one Python int per base
            seg.query_qualities = quals
        else:
            seg.query_qualities = None
        off += l_seq
    else:
        seg.query_sequence = None
        seg.query_qualities = None
    seg.tags = _parse_tags(data[off:])
    return seg


def encode_bam_record(seg: AlignedSegment) -> bytes:
    name = seg.query_name.encode() + b"\x00"
    cig = seg.cigartuples or []
    seq = seg.query_sequence or ""
    l_seq = len(seq)
    # one hex digit per base (a base outside SEQ_DECODE, in either case, is
    # 15), two bases a byte, high nibble first, a 0 nibble after an odd one
    digits = seq.encode("ascii", "replace").translate(_SEQ_ENC_TRANS)
    packed = bytes.fromhex((digits + b"0" * (l_seq & 1)).decode())
    if seg.query_qualities is not None:
        quals = bytes(seg.query_qualities)
    else:
        quals = b"\xff" * l_seq
    tags = _encode_tags(seg.tags)
    body = bytearray()
    body += struct.pack(
        "<iiBBHHHiiii",
        seg.reference_id,
        seg.reference_start,
        len(name),
        seg.mapping_quality,
        _reg2bin(seg.reference_start, seg.reference_end or seg.reference_start + 1),
        len(cig),
        seg.flag,
        l_seq,
        seg.next_reference_id,
        seg.next_reference_start,
        seg.template_length,
    )
    body += name
    for op, l in cig:
        body += struct.pack("<I", (l << 4) | op)
    body += packed
    body += quals
    body += tags
    return struct.pack("<i", len(body)) + bytes(body)


def _reg2bin(beg: int, end: int) -> int:
    """BAI bin number for a region (SAM spec section 5.3)."""
    if beg < 0:
        return 0
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


class AlignmentFile:
    """Read a BAM or SAM file, or write a BAM file (mode 'wb')."""

    def __init__(
        self,
        path,
        mode: str = "r",
        header: Optional[AlignmentHeader] = None,
        template: Optional["AlignmentFile"] = None,
        reference_filename: Optional[str] = None,
        threads: int = 1,
        require_index: bool = False,
        check_sq: bool = True,
    ):
        self._path = os.fspath(path) if not hasattr(path, "read") else path
        self._writer = None
        if "w" in mode:
            if template is not None:
                header = template.header
            assert header is not None
            self.header = header
            self._open_write(self._path)
            return
        self._open_read(self._path, reference_filename)
        if require_index and not self._has_index():
            raise OSError(f"index for alignment file {self._path} not found")

    # -- reading ---------------------------------------------------------
    def _open_read(self, path, reference_filename) -> None:
        with open(path, "rb") as f:
            magic2 = f.read(2)
        if magic2 == b"\x1f\x8b":
            self._mode = "bam"
            self._read_bam_header(path)
        elif magic2 == b"CR":
            self._mode = "cram"
            self._read_cram(path, reference_filename)
        else:
            self._mode = "sam"
            self._read_sam_header(path)

    def _read_cram(self, path, reference_filename) -> None:
        from .cram import CramReader

        reader = CramReader(path, reference_filename)
        text = reader.header_text
        references = []
        lengths = []
        rg_ids = []
        for line in text.split("\n"):
            if line.startswith("@SQ"):
                d = dict(f.split(":", 1) for f in line.split("\t")[1:] if ":" in f)
                references.append(d.get("SN"))
                lengths.append(int(d.get("LN", 0)))
            elif line.startswith("@RG"):
                d = dict(f.split(":", 1) for f in line.split("\t")[1:] if ":" in f)
                rg_ids.append(d.get("ID"))
        self.header = AlignmentHeader(text, references, lengths)
        self._cram_segments = [
            self._cram_to_segment(rec, cigar, rg_ids) for rec, cigar in reader.records
        ]

    def _cram_to_segment(self, rec, cigar, rg_ids) -> AlignedSegment:
        seg = AlignedSegment(self.header)
        seg.query_name = rec.name
        flag = rec.flag
        if rec.mate_flags & 0x1:
            flag |= 0x20  # mate reverse strand
        if rec.mate_flags & 0x2:
            flag |= 0x8  # mate unmapped
        seg.flag = flag
        seg.reference_id = rec.ref_id
        seg.reference_start = rec.pos - 1
        seg.mapping_quality = rec.mapq
        seg.cigartuples = [(op, ln) for op, ln in cigar] or None
        seg.next_reference_id = rec.mate_ref_id
        seg.next_reference_start = rec.mate_pos - 1
        seg.template_length = rec.template_len
        seg.query_sequence = rec.seq or None
        seg.query_qualities = list(rec.quals) if rec.quals is not None else None
        seg.tags = dict(rec.tags)
        if rec.read_group >= 0 and rec.read_group < len(rg_ids) and "RG" not in seg.tags:
            seg.tags["RG"] = rg_ids[rec.read_group]
        return seg

    def _read_bam_header(self, path) -> None:
        r = BGZFReader(path)
        magic = r.read(4)
        if magic != BAM_MAGIC:
            raise ValueError(f"{path}: not a BAM file")
        (l_text,) = struct.unpack("<i", r.read(4))
        text = r.read(l_text).rstrip(b"\x00").decode()
        (n_ref,) = struct.unpack("<i", r.read(4))
        references = []
        lengths = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", r.read(4))
            name = r.read(l_name)[:-1].decode()
            (l_ref,) = struct.unpack("<i", r.read(4))
            references.append(name)
            lengths.append(l_ref)
        self.header = AlignmentHeader(text, references, lengths)
        self._body_voffset = r.tell_virtual()
        self._bgzf = r

    def _read_sam_header(self, path) -> None:
        header_lines = []
        self._sam_body_offset = 0
        with open(path) as f:
            off = 0
            for line in f:
                if line.startswith("@"):
                    header_lines.append(line.rstrip("\n"))
                    off += len(line)
                else:
                    break
            self._sam_body_offset = off
        text = "\n".join(header_lines) + ("\n" if header_lines else "")
        references = []
        lengths = []
        for line in header_lines:
            if line.startswith("@SQ"):
                d = dict(
                    f.split(":", 1) for f in line.split("\t")[1:] if ":" in f
                )
                references.append(d.get("SN"))
                lengths.append(int(d.get("LN", 0)))
        self.header = AlignmentHeader(text, references, lengths)

    @property
    def is_cram(self) -> bool:
        return self._mode in ("cram", "cram-write")

    @property
    def references(self) -> List[str]:
        return list(self.header.references)

    @property
    def lengths(self) -> List[int]:
        return list(self.header.lengths)

    def get_reference_length(self, name: str) -> int:
        return self.header.lengths[self.header.get_reference_id(name)]

    def _has_index(self) -> bool:
        if self._mode == "sam":
            return False
        for ext in (".bai", ".csi", ".crai"):
            if os.path.exists(str(self._path) + ext):
                return True
        base, fext = os.path.splitext(str(self._path))
        if fext == ".bam" and (
            os.path.exists(base + ".bai") or os.path.exists(base + ".csi")
        ):
            return True
        if fext == ".cram" and os.path.exists(base + ".crai"):
            return True
        return False

    _NATIVE_SCAN_MAX_BYTES = 512 * 1024 * 1024

    def _native_pool(self):
        """Whole-file decode through the C++ loader (csrc/host/bamlib.cpp):
        one BGZF inflation pass and record splitting in C.  The decoded
        pool is cached process-wide keyed by (path, size, mtime) so a file
        opened several times in one run (header probe + record pass, or one
        pass per chromosome) inflates exactly once."""
        if getattr(self, "_native_handle", None) is not None:
            return self._native_cache
        from ..hostlib import bamlib

        if bamlib is None:
            return None
        try:
            path = os.fspath(self._path)
            st = os.stat(path)
        except (OSError, TypeError):
            return None
        if st.st_size > self._NATIVE_SCAN_MAX_BYTES:
            return None
        key = (path, st.st_size, st.st_mtime_ns)
        cached = _BAM_POOL_CACHE.get(key)
        if cached is not None:
            self._native_handle = True
            self._native_cache = cached
            return cached
        import ctypes as _ct

        h = bamlib._lib.wh_bam_load(path.encode())
        if not h:
            return None
        n = bamlib._lib.wh_bam_n_records(h)
        pool_size = bamlib._lib.wh_bam_pool_size(h)
        pool = bytes(_ct.cast(bamlib._lib.wh_bam_pool(h), _ct.POINTER(_ct.c_char * pool_size)).contents) if pool_size else b""
        offsets = list(
            _ct.cast(
                bamlib._lib.wh_bam_offsets(h), _ct.POINTER(_ct.c_uint64 * (n + 1))
            ).contents
        )
        bamlib._lib.wh_bam_free(h)
        self._native_handle = True
        self._native_cache = (pool, offsets)
        _bam_pool_cache_put(key, self._native_cache)
        return self._native_cache

    def _iter_all(self) -> Iterator[AlignedSegment]:
        if self._mode == "cram":
            yield from self._cram_segments
            return
        if self._mode == "sam":
            with open(self._path) as f:
                for line in f:
                    if line.startswith("@") or not line.strip():
                        continue
                    yield self._parse_sam_line(line)
            return
        native = self._native_pool() if not hasattr(self._path, "write") else None
        if native is not None:
            pool, offsets = native
            header = self.header
            for i in range(len(offsets) - 1):
                yield parse_bam_record(pool[offsets[i] : offsets[i + 1]], header)
            return
        r = BGZFReader(self._path)
        r.seek_virtual(self._body_voffset)
        while True:
            raw = r.read(4)
            if len(raw) < 4:
                return
            (block_size,) = struct.unpack("<i", raw)
            data = r.read(block_size)
            if len(data) < block_size:
                return
            yield parse_bam_record(data, self.header)

    def _bai_path(self) -> Optional[str]:
        for cand in (str(self._path) + ".bai",):
            if os.path.exists(cand):
                return cand
        base, bamext = os.path.splitext(str(self._path))
        if bamext == ".bam" and os.path.exists(base + ".bai"):
            return base + ".bai"
        return None

    def _load_bai(self):
        """Parse the .bai index (SAM spec section 5.2): per reference a
        bin -> chunk list map plus the 16kb-window linear index. Returns
        None when unavailable or empty (e.g. our own minimal indexes), in
        which case fetch() falls back to scanning."""
        if getattr(self, "_bai", None) is not None:
            return self._bai if self._bai else None
        self._bai = ()
        path = self._bai_path()
        if path is None:
            return None
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] != b"BAI\x01":
            return None
        off = 4
        (n_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        refs = []
        total_chunks = 0
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            bins = {}
            for _ in range(n_bin):
                bin_no, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                chunks = []
                for _ in range(n_chunk):
                    cb, ce = struct.unpack_from("<QQ", data, off)
                    off += 16
                    chunks.append((cb, ce))
                if bin_no != 37450:  # skip the metadata pseudo-bin
                    bins[bin_no] = chunks
                    total_chunks += len(chunks)
            (n_intv,) = struct.unpack_from("<i", data, off)
            off += 4
            linear = list(struct.unpack_from(f"<{n_intv}Q", data, off))
            off += 8 * n_intv
            refs.append((bins, linear))
        if total_chunks == 0:
            return None
        self._bai = refs
        return refs

    @staticmethod
    def _reg2bins(beg: int, end: int):
        """Candidate bins overlapping [beg, end) (SAM spec reg2bins)."""
        end -= 1
        yield 0
        for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
            for k in range(base + (beg >> shift), base + (end >> shift) + 1):
                yield k

    def _iter_region_indexed(self, ref_id: int, beg: int, endq: int):
        """Yield records overlapping [beg, endq) using the BAI index:
        candidate-bin chunks filtered by the linear index, merged, then
        scanned with early exit (records are coordinate sorted)."""
        bins, linear = self._bai[ref_id]
        min_off = 0
        if linear:
            win = min(beg >> 14, len(linear) - 1)
            # some windows can be zero (no reads start there); find the
            # closest preceding non-zero offset like htslib does
            while win >= 0 and linear[win] == 0:
                win -= 1
            if win >= 0:
                min_off = linear[win]
        chunks = []
        for b in self._reg2bins(beg, endq):
            for cb, ce in bins.get(b, ()):
                if ce > min_off:
                    chunks.append((max(cb, min_off), ce))
        if not chunks:
            return
        chunks.sort()
        merged = [list(chunks[0])]
        for cb, ce in chunks[1:]:
            if cb <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], ce)
            else:
                merged.append([cb, ce])
        r = BGZFReader(self._path)
        try:
            for cb, ce in merged:
                r.seek_virtual(cb)
                while r.tell_virtual() < ce:
                    raw = r.read(4)
                    if len(raw) < 4:
                        return
                    (block_size,) = struct.unpack("<i", raw)
                    data = r.read(block_size)
                    if len(data) < block_size:
                        return
                    seg = parse_bam_record(data, self.header)
                    if seg.reference_id != ref_id:
                        if seg.reference_id > ref_id or seg.reference_id < 0:
                            return
                        continue
                    s = seg.reference_start
                    if s >= endq:
                        return
                    e = seg.reference_end if seg.reference_end is not None else s + 1
                    if e <= beg:
                        continue
                    yield seg
        finally:
            r.close()

    def _parse_sam_line(self, line: str) -> AlignedSegment:
        fields = line.rstrip("\n").split("\t")
        seg = AlignedSegment(self.header)
        seg.query_name = fields[0]
        seg.flag = int(fields[1])
        seg.reference_id = (
            self.header.get_reference_id(fields[2]) if fields[2] != "*" else -1
        )
        seg.reference_start = int(fields[3]) - 1
        seg.mapping_quality = int(fields[4])
        if fields[5] != "*":
            seg.cigartuples = [
                (CIGAR_OP_CODE[m.group(2)], int(m.group(1)))
                for m in re.finditer(r"(\d+)([MIDNSHP=X])", fields[5])
            ]
        seg.next_reference_id = (
            seg.reference_id
            if fields[6] == "="
            else (self.header.get_reference_id(fields[6]) if fields[6] != "*" else -1)
        )
        seg.next_reference_start = int(fields[7]) - 1
        seg.template_length = int(fields[8])
        seg.query_sequence = None if fields[9] == "*" else fields[9]
        if fields[10] != "*":
            seg.query_qualities = [ord(c) - 33 for c in fields[10]]
        for tagfield in fields[11:]:
            parts = tagfield.split(":", 2)
            if len(parts) != 3:
                continue
            tag, typ, value = parts
            if typ == "i":
                seg.tags[tag] = int(value)
            elif typ == "f":
                seg.tags[tag] = float(value)
            elif typ == "A":
                seg.tags[tag] = value
            elif typ == "B":
                sub = value[0]
                vals = value[1:].lstrip(",").split(",")
                seg.tags[tag] = [
                    float(v) if sub == "f" else int(v) for v in vals if v
                ]
            else:
                seg.tags[tag] = value
        return seg

    def fetch(
        self,
        contig: Optional[str] = None,
        start: Optional[int] = None,
        stop: Optional[int] = None,
        reference=None,
        end=None,
        multiple_iterators: bool = False,
        until_eof: bool = False,
    ) -> Iterator[AlignedSegment]:
        if contig is None and reference is not None:
            contig = reference
        if stop is None and end is not None:
            stop = end
        if until_eof:
            return self._iter_all()
        if not self._has_index():
            raise ValueError(f"fetch requires an index for {self._path}")
        if contig == "*":
            # htslib convention: only reads without coordinates
            def gen_unplaced():
                for seg in self._iter_all():
                    if seg.reference_id < 0:
                        yield seg

            return gen_unplaced()
        ref_id = self.header.get_reference_id(contig) if contig is not None else None

        if contig is not None and ref_id is not None and self._mode == "bam":
            bai = self._load_bai()
            if bai is not None and 0 <= ref_id < len(bai):
                beg = start if start is not None else 0
                # htslib uses the maximum representable coordinate when no
                # stop is given (reads may sit beyond the declared contig
                # length), not the header length
                endq = stop if stop is not None else (1 << 29)
                return self._iter_region_indexed(ref_id, beg, endq)

        def gen():
            for seg in self._iter_all():
                if contig is None and seg.is_unmapped:
                    # plain fetch(): all mapped reads
                    continue
                if ref_id is not None and seg.reference_id != ref_id:
                    continue
                if contig is not None:
                    # placed-but-unmapped reads are part of region queries
                    s = seg.reference_start
                    e = seg.reference_end if seg.reference_end is not None else s + 1
                    if stop is not None and s >= stop:
                        continue
                    if start is not None and e <= start:
                        continue
                yield seg

        return gen()

    def __iter__(self):
        return self._iter_all()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._raw.close()
            self._writer = None

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()

    # -- writing ---------------------------------------------------------
    def _open_write(self, path) -> None:
        name = None
        if not hasattr(path, "write"):
            name = str(path)
        elif hasattr(path, "name"):
            name = str(getattr(path, "name"))
        if (name and name.endswith(".cram")) or "c" in getattr(self, "_req_mode", ""):
            from .cram import CramWriter

            self._mode = "cram-write"
            self._raw = path if hasattr(path, "write") else open(path, "wb")
            self._writer = CramWriter(self._raw, self.header.text)
            return
        self._mode = "bam-write"
        if hasattr(path, "write"):
            self._raw = path
        else:
            self._raw = open(path, "wb")
        self._writer = BGZFWriter(self._raw)
        text = self.header.text.encode()
        self._writer.write(BAM_MAGIC)
        self._writer.write(struct.pack("<i", len(text)))
        self._writer.write(text)
        self._writer.write(struct.pack("<i", len(self.header.references)))
        for name, length in zip(self.header.references, self.header.lengths):
            bname = name.encode() + b"\x00"
            self._writer.write(struct.pack("<i", len(bname)))
            self._writer.write(bname)
            self._writer.write(struct.pack("<i", length))

    def write(self, seg: AlignedSegment) -> None:
        assert self._writer is not None
        if self._mode == "cram-write":
            self._writer.write(seg)
        else:
            self._writer.write(encode_bam_record(seg))


class FastxRecord:
    __slots__ = ("name", "comment", "sequence", "quality")

    def __init__(self, name, comment, sequence, quality):
        self.name = name
        self.comment = comment
        self.sequence = sequence
        self.quality = quality

    def __str__(self) -> str:
        header = self.name if not self.comment else f"{self.name} {self.comment}"
        if self.quality is not None:
            return f"@{header}\n{self.sequence}\n+\n{self.quality}"
        return f">{header}\n{self.sequence}"


class FastxFile:
    """Minimal FASTQ/FASTA reader (plain or gzipped), pysam-like."""

    def __init__(self, path):
        import gzip as _gzip

        with open(path, "rb") as f:
            gz = f.read(2) == b"\x1f\x8b"
        self._handle = _gzip.open(path, "rt") if gz else open(path, "rt")

    def __iter__(self):
        first = self._handle.readline()
        while first:
            first = first.rstrip("\n")
            if not first:
                first = self._handle.readline()
                continue
            if first.startswith("@"):
                seq = self._handle.readline().rstrip("\n")
                self._handle.readline()  # '+'
                qual = self._handle.readline().rstrip("\n")
            elif first.startswith(">"):
                seq = self._handle.readline().rstrip("\n")
                qual = None
            else:
                raise ValueError(f"Malformed FASTX record: {first!r}")
            fields = first[1:].split(None, 1)
            name = fields[0]
            comment = fields[1] if len(fields) > 1 else None
            yield FastxRecord(name, comment, seq, qual)
            first = self._handle.readline()

    def close(self):
        self._handle.close()

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()


def sam_to_bam(sam_path: str, bam_path: str) -> None:
    """Convert a SAM text file to BAM (replacement for `samtools view -b`)."""
    src = AlignmentFile(sam_path)
    out = AlignmentFile(bam_path, "wb", header=src.header)
    for seg in src:
        out.write(seg)
    out.close()


def index(bam_path: str, catch_stdout: bool = False) -> None:
    """pysam.index-style helper: create a (minimal) .bai for the BAM."""
    build_minimal_index(bam_path)


def view(sam_path: str, *args, catch_stdout: bool = False) -> None:
    """pysam.view-style helper supporting the '-b -o OUT IN' conversion."""
    out = None
    arglist = list(args)
    i = 0
    while i < len(arglist):
        if arglist[i] == "-o" and i + 1 < len(arglist):
            out = arglist[i + 1]
        i += 1
    assert out is not None, "view() requires -o OUTPUT"
    sam_to_bam(sam_path, out)


def build_minimal_index(bam_path: str) -> None:
    """Write a structurally valid (empty) .bai next to the BAM.

    Our fetch() scans and filters, using the index only as an existence
    check (mirroring htslib's requirement that indexed access needs an
    index); a real BAI builder can be layered in for seek-based fetch.
    """
    bam = AlignmentFile(bam_path)
    n_ref = len(bam.header.references)
    with open(str(bam_path) + ".bai", "wb") as f:
        f.write(b"BAI\x01")
        f.write(struct.pack("<i", n_ref))
        for _ in range(n_ref):
            f.write(struct.pack("<i", 0))  # n_bin
            f.write(struct.pack("<i", 0))  # n_intv
