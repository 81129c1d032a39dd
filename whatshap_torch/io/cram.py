"""
Native CRAM 3.0 reader (no htslib).

Parses the container/block structure (ITF8/LTF8 varints, gzip/raw/rANS-4x8
block compression), compression headers (preservation map, data-series
encoding map, tag encoding map), slice headers, and decodes records with the
CRAM codec set used in practice: EXTERNAL, HUFFMAN (incl. the ubiquitous
zero-bit constant case), BYTE_ARRAY_LEN, BYTE_ARRAY_STOP, BETA.  Sequences
are reconstructed from the reference FASTA plus feature operations
(substitution matrix, insertions, soft clips, deletions, ...).

Spec: https://samtools.github.io/hts-specs/CRAMv3.pdf.  This is a reader
for interoperability with CRAM inputs produced by htslib; whatshap_torch
itself writes BAM.
"""

import struct
import zlib
from typing import Dict, List, Optional, Tuple

CRAM_MAGIC = b"CRAM"

# CF flags
CF_QS_PRESERVED = 0x1
CF_DETACHED = 0x2
CF_MATE_DOWNSTREAM = 0x4
CF_NO_SEQ = 0x8

_BASES = "ACGTN"


class _Cursor:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def read(self, n: int) -> bytes:
        b = self.data[self.pos : self.pos + n]
        self.pos += n
        return b

    def byte(self) -> int:
        v = self.data[self.pos]
        self.pos += 1
        return v

    def itf8(self) -> int:
        b0 = self.byte()
        if b0 < 0x80:
            v = b0
        elif b0 < 0xC0:
            v = ((b0 & 0x7F) << 8) | self.byte()
        elif b0 < 0xE0:
            v = ((b0 & 0x3F) << 16) | (self.byte() << 8) | self.byte()
        elif b0 < 0xF0:
            v = ((b0 & 0x1F) << 24) | (self.byte() << 16) | (self.byte() << 8) | self.byte()
        else:
            v = (
                ((b0 & 0x0F) << 28)
                | (self.byte() << 20)
                | (self.byte() << 12)
                | (self.byte() << 4)
                | (self.byte() & 0x0F)
            )
        # values are signed 32-bit
        if v >= 1 << 31:
            v -= 1 << 32
        return v

    def ltf8(self) -> int:
        b0 = self.byte()
        n_extra = 0
        mask = b0
        for i in range(8):
            if b0 & (0x80 >> i):
                n_extra += 1
            else:
                break
        if n_extra == 0:
            return b0
        v = b0 & (0xFF >> (n_extra + (1 if n_extra < 8 else 0)))
        for _ in range(n_extra):
            v = (v << 8) | self.byte()
        if v >= 1 << 63:
            v -= 1 << 64
        return v

    def int32(self) -> int:
        (v,) = struct.unpack_from("<i", self.data, self.pos)
        self.pos += 4
        return v

    def array_itf8(self) -> List[int]:
        n = self.itf8()
        return [self.itf8() for _ in range(n)]

    def at_end(self) -> bool:
        return self.pos >= len(self.data)


class _BitReader:
    """MSB-first bit reader over the core block."""

    __slots__ = ("data", "bitpos")

    def __init__(self, data: bytes):
        self.data = data
        self.bitpos = 0

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.bitpos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.bitpos & 7))) & 1)
            self.bitpos += 1
        return v


# ---------------------------------------------------------------------------
# rANS 4x8 decompression (CRAM block method 4)


def _rans_decode(data: bytes) -> bytes:
    cur = _Cursor(data)
    order = cur.byte()
    _comp_size = cur.int32()
    raw_size = cur.int32()
    if order == 0:
        return _rans0_decode(cur, raw_size)
    return _rans1_decode(cur, raw_size)


def _read_freq_table(cur: _Cursor) -> Dict[int, int]:
    """rANS order-0 frequency table: (symbol, freq) pairs with symbol RLE
    (a byte equal to prev+1 introduces a run-length byte), 0-terminated."""
    freqs: Dict[int, int] = {}
    rle = 0
    sym = cur.byte()
    while True:
        freqs[sym] = cur.itf8()
        if rle > 0:
            rle -= 1
            sym += 1
        else:
            nxt = cur.byte()
            if nxt == 0:
                break
            if nxt == (sym + 1) & 0xFF:
                rle = cur.byte()
            sym = nxt
    return freqs


def _normalize(freqs: Dict[int, int]):
    # build cumulative table over TOTFREQ = 4095-normalized frequencies
    syms = sorted(freqs)
    cum = {}
    c = 0
    for s in syms:
        cum[s] = c
        c += freqs[s]
    # lookup: slot -> symbol
    lookup = [0] * 4096
    for s in syms:
        start = cum[s]
        for i in range(freqs[s]):
            lookup[start + i] = s
    return cum, lookup


def _rans0_decode(cur: _Cursor, raw_size: int) -> bytes:
    freqs = _read_freq_table(cur)
    cum, lookup = _normalize(freqs)
    states = [struct.unpack("<I", cur.read(4))[0] for _ in range(4)]
    out = bytearray(raw_size)
    for i in range(raw_size):
        j = i & 3
        x = states[j]
        slot = x & 0xFFF
        s = lookup[slot]
        out[i] = s
        x = freqs[s] * (x >> 12) + slot - cum[s]
        while x < (1 << 23):
            x = (x << 8) | cur.byte()
        states[j] = x
    return bytes(out)


def _rans1_decode(cur: _Cursor, raw_size: int) -> bytes:
    # order-1: a frequency table per context symbol
    tables: Dict[int, Tuple[Dict[int, int], Dict[int, int], List[int]]] = {}
    ctx = cur.byte()
    rle = 0
    while True:
        f = _read_freq_table(cur)
        c, lk = _normalize(f)
        tables[ctx] = (f, c, lk)
        if rle > 0:
            rle -= 1
            ctx += 1
        else:
            nxt = cur.byte()
            if nxt == 0:
                break
            if nxt == (ctx + 1) & 0xFF:
                rle = cur.byte()
            ctx = nxt
    states = [struct.unpack("<I", cur.read(4))[0] for _ in range(4)]
    out = bytearray(raw_size)
    isz4 = raw_size >> 2
    last = [0, 0, 0, 0]

    def step(j, idx):
        f, c, lk = tables[last[j]]
        x = states[j]
        slot = x & 0xFFF
        s = lk[slot]
        out[idx] = s
        x = f[s] * (x >> 12) + slot - c[s]
        while x < (1 << 23) and cur.pos < len(cur.data):
            x = (x << 8) | cur.byte()
        states[j] = x
        last[j] = s

    for i in range(isz4):
        for j in range(4):
            step(j, j * isz4 + i)
    for idx in range(4 * isz4, raw_size):  # remainder rides stream 3
        step(3, idx)
    return bytes(out)


# ---------------------------------------------------------------------------
# blocks / containers


class Block:
    __slots__ = ("method", "content_type", "content_id", "data")

    def __init__(self, method, content_type, content_id, data):
        self.method = method
        self.content_type = content_type
        self.content_id = content_id
        self.data = data


def _read_block(cur: _Cursor) -> Block:
    method = cur.byte()
    content_type = cur.byte()
    content_id = cur.itf8()
    comp_size = cur.itf8()
    raw_size = cur.itf8()
    payload = cur.read(comp_size)
    cur.read(4)  # crc32
    if method == 0:
        data = payload
    elif method == 1:
        data = zlib.decompress(payload, wbits=31)
    elif method == 2:  # pragma: no cover - bzip2
        import bz2

        data = bz2.decompress(payload)
    elif method == 3:  # pragma: no cover - lzma
        import lzma

        data = lzma.decompress(payload)
    elif method == 4:
        data = _rans_decode(payload)
    else:
        raise ValueError(f"unsupported CRAM block compression method {method}")
    if len(data) != raw_size:
        raise ValueError("CRAM block raw size mismatch")
    return Block(method, content_type, content_id, data)


class ContainerHeader:
    __slots__ = (
        "length",
        "ref_id",
        "start",
        "span",
        "n_records",
        "record_counter",
        "bases",
        "n_blocks",
        "landmarks",
    )


def _read_container_header(cur: _Cursor) -> Optional[ContainerHeader]:
    if cur.pos + 4 > len(cur.data):
        return None
    h = ContainerHeader()
    h.length = cur.int32()
    h.ref_id = cur.itf8()
    h.start = cur.itf8()
    h.span = cur.itf8()
    h.n_records = cur.itf8()
    h.record_counter = cur.ltf8()
    h.bases = cur.ltf8()
    h.n_blocks = cur.itf8()
    h.landmarks = cur.array_itf8()
    cur.read(4)  # crc32
    return h


# ---------------------------------------------------------------------------
# encodings


class Encoding:
    def __init__(self, codec: int, params: bytes):
        self.codec = codec
        self.params = params
        self._parse()

    def _parse(self):
        cur = _Cursor(self.params)
        c = self.codec
        if c == 1:  # EXTERNAL
            self.content_id = cur.itf8()
        elif c == 3:  # HUFFMAN
            self.alphabet = cur.array_itf8()
            self.bitlens = cur.array_itf8()
            self._build_huffman()
        elif c == 4:  # BYTE_ARRAY_LEN
            lc = cur.itf8()
            ln = cur.itf8()
            self.len_enc = Encoding(lc, cur.read(ln))
            vc = cur.itf8()
            vn = cur.itf8()
            self.val_enc = Encoding(vc, cur.read(vn))
        elif c == 5:  # BYTE_ARRAY_STOP
            self.stop = cur.byte()
            self.content_id = cur.itf8()
        elif c == 6:  # BETA
            self.offset = cur.itf8()
            self.nbits = cur.itf8()
        elif c == 0:  # NULL
            pass
        else:
            raise ValueError(f"unsupported CRAM encoding codec {c}")

    def _build_huffman(self):
        # canonical Huffman codes from (symbol, bit length) pairs
        pairs = sorted(zip(self.bitlens, self.alphabet))
        codes = {}
        code = 0
        prev_len = pairs[0][0] if pairs else 0
        for ln, sym in pairs:
            code <<= ln - prev_len
            prev_len = ln
            codes[(ln, code)] = sym
            code += 1
        self.huff = codes
        self.max_len = pairs[-1][0] if pairs else 0

    def read_int(self, core: _BitReader, ext: Dict[int, _Cursor]) -> int:
        c = self.codec
        if c == 3:
            if self.max_len == 0:
                return self.alphabet[0]
            ln = 0
            code = 0
            while ln <= self.max_len:
                code = (code << 1) | core.bits(1)
                ln += 1
                if (ln, code) in self.huff:
                    return self.huff[(ln, code)]
            raise ValueError("bad Huffman code")
        if c == 1:
            return ext[self.content_id].itf8()
        if c == 6:
            return core.bits(self.nbits) - self.offset
        raise ValueError(f"cannot read int with codec {c}")

    def read_byte(self, core: _BitReader, ext: Dict[int, _Cursor]) -> int:
        if self.codec == 1:
            return ext[self.content_id].byte()
        return self.read_int(core, ext)

    def read_bytes(self, core: _BitReader, ext: Dict[int, _Cursor], n: Optional[int] = None) -> bytes:
        c = self.codec
        if c == 5:
            cur = ext[self.content_id]
            start = cur.pos
            while cur.data[cur.pos] != self.stop:
                cur.pos += 1
            out = cur.data[start : cur.pos]
            cur.pos += 1  # consume stop byte
            return out
        if c == 4:
            ln = self.len_enc.read_int(core, ext)
            return self.val_enc.read_bytes(core, ext, ln)
        if c == 1:
            assert n is not None
            return ext[self.content_id].read(n)
        if c == 3 and self.max_len == 0 and n is not None:
            return bytes([self.alphabet[0]] * n)
        raise ValueError(f"cannot read bytes with codec {c}")


# ---------------------------------------------------------------------------
# compression header


class CompressionHeader:
    def __init__(self, data: bytes):
        cur = _Cursor(data)
        # preservation map
        self.rn_preserved = True
        self.ap_delta = True
        self.rr = True
        self.sub_matrix = bytes(5)
        self.tag_dict: List[List[Tuple[str, str]]] = [[]]
        _size = cur.itf8()
        n = cur.itf8()
        for _ in range(n):
            key = cur.read(2)
            if key == b"RN":
                self.rn_preserved = cur.byte() != 0
            elif key == b"AP":
                self.ap_delta = cur.byte() != 0
            elif key == b"RR":
                self.rr = cur.byte() != 0
            elif key == b"SM":
                self.sub_matrix = cur.read(5)
            elif key == b"TD":
                ln = cur.itf8()
                raw = cur.read(ln)
                self.tag_dict = []
                for line in raw.split(b"\x00")[:-1] if raw.endswith(b"\x00") else raw.split(b"\x00"):
                    tags = []
                    for i in range(0, len(line), 3):
                        tags.append((line[i : i + 2].decode(), chr(line[i + 2])))
                    self.tag_dict.append(tags)
                if not self.tag_dict:
                    self.tag_dict = [[]]
            else:
                raise ValueError(f"unknown preservation key {key!r}")
        # data series encodings
        self.series: Dict[bytes, Encoding] = {}
        _size = cur.itf8()
        n = cur.itf8()
        for _ in range(n):
            key = bytes(cur.read(2))
            codec = cur.itf8()
            ln = cur.itf8()
            self.series[key] = Encoding(codec, cur.read(ln))
        # tag encodings
        self.tag_enc: Dict[int, Encoding] = {}
        _size = cur.itf8()
        n = cur.itf8()
        for _ in range(n):
            key = cur.itf8()
            codec = cur.itf8()
            ln = cur.itf8()
            self.tag_enc[key] = Encoding(codec, cur.read(ln))

        # substitution decode table: sub_base[ref_base_idx][code] -> base char
        self.sub_table = {}
        for ri, rb in enumerate(_BASES):
            byte = self.sub_matrix[ri]
            alts = [b for b in _BASES if b != rb]
            # the 2-bit fields give each alt base's code, in ACGTN order
            by_code = {}
            for ai, ab in enumerate(alts):
                code = (byte >> (6 - 2 * ai)) & 3
                by_code[code] = ab
            self.sub_table[rb] = by_code
            self.sub_table[rb.lower()] = by_code


class SliceHeader:
    def __init__(self, data: bytes):
        cur = _Cursor(data)
        self.ref_id = cur.itf8()
        self.start = cur.itf8()
        self.span = cur.itf8()
        self.n_records = cur.itf8()
        self.record_counter = cur.ltf8()
        self.n_blocks = cur.itf8()
        self.content_ids = cur.array_itf8()
        self.embedded_ref_id = cur.itf8()
        self.md5 = cur.read(16)


# ---------------------------------------------------------------------------


class CramRecord:
    __slots__ = (
        "flag",
        "cram_flags",
        "ref_id",
        "read_length",
        "pos",
        "read_group",
        "name",
        "mate_flags",
        "mate_ref_id",
        "mate_pos",
        "template_len",
        "tags",
        "mapq",
        "quals",
        "seq",
        "features",
    )


def _decode_slice(
    comp: CompressionHeader,
    slice_header: SliceHeader,
    core: _BitReader,
    ext: Dict[int, _Cursor],
    reference_bases,
) -> List[CramRecord]:
    S = comp.series

    def rint(key: bytes, default=None) -> int:
        enc = S.get(key)
        if enc is None:
            if default is not None:
                return default
            raise ValueError(f"missing data series {key!r}")
        return enc.read_int(core, ext)

    records = []
    prev_ap = slice_header.start
    for _ in range(slice_header.n_records):
        r = CramRecord()
        r.flag = rint(b"BF")
        r.cram_flags = rint(b"CF")
        if slice_header.ref_id == -2:
            r.ref_id = rint(b"RI")
        else:
            r.ref_id = slice_header.ref_id
        r.read_length = rint(b"RL")
        ap = rint(b"AP")
        if comp.ap_delta:
            prev_ap = prev_ap + ap
            r.pos = prev_ap
        else:
            r.pos = ap
        r.read_group = rint(b"RG", default=-1)
        if comp.rn_preserved:
            r.name = S[b"RN"].read_bytes(core, ext).decode()
        else:
            r.name = ""
        r.mate_flags = 0
        r.mate_ref_id = -1
        r.mate_pos = -1
        r.template_len = 0
        if r.cram_flags & CF_DETACHED:
            r.mate_flags = rint(b"MF")
            if not comp.rn_preserved:
                r.name = S[b"RN"].read_bytes(core, ext).decode()
            r.mate_ref_id = rint(b"NS")
            r.mate_pos = rint(b"NP")
            r.template_len = rint(b"TS")
        elif r.cram_flags & CF_MATE_DOWNSTREAM:
            rint(b"NF")  # distance to mate record (not resolved here)

        tl = rint(b"TL", default=0)
        r.tags = {}
        for tag, typ in comp.tag_dict[tl] if tl < len(comp.tag_dict) else []:
            key = (ord(tag[0]) << 16) | (ord(tag[1]) << 8) | ord(typ)
            raw = comp.tag_enc[key].read_bytes(core, ext)
            r.tags[tag] = _parse_tag_value(typ, raw)

        r.mapq = 0
        r.quals = None
        r.features = []
        if not (r.flag & 4):
            fn = rint(b"FN")
            fpos = 0
            for _ in range(fn):
                fc = chr(S[b"FC"].read_byte(core, ext))
                fpos += rint(b"FP")
                if fc == "X":
                    r.features.append((fc, fpos, rint(b"BS")))
                elif fc == "S":
                    r.features.append((fc, fpos, S[b"SC"].read_bytes(core, ext)))
                elif fc == "I":
                    r.features.append((fc, fpos, S[b"IN"].read_bytes(core, ext)))
                elif fc == "i":
                    r.features.append((fc, fpos, S[b"BA"].read_byte(core, ext)))
                elif fc == "D":
                    r.features.append((fc, fpos, rint(b"DL")))
                elif fc == "N":
                    r.features.append((fc, fpos, rint(b"RS")))
                elif fc == "P":
                    r.features.append((fc, fpos, rint(b"PD")))
                elif fc == "H":
                    r.features.append((fc, fpos, rint(b"HC")))
                elif fc == "B":
                    b = S[b"BA"].read_byte(core, ext)
                    q = S[b"QS"].read_byte(core, ext)
                    r.features.append((fc, fpos, (b, q)))
                elif fc == "b":
                    r.features.append((fc, fpos, S[b"BB"].read_bytes(core, ext)))
                elif fc == "q":
                    r.features.append((fc, fpos, S[b"QQ"].read_bytes(core, ext, r.read_length)))
                elif fc == "Q":
                    r.features.append((fc, fpos, S[b"QS"].read_byte(core, ext)))
                else:
                    raise ValueError(f"unknown CRAM feature code {fc!r}")
            r.mapq = rint(b"MQ")
            if r.cram_flags & CF_QS_PRESERVED:
                r.quals = S[b"QS"].read_bytes(core, ext, r.read_length)
            r.seq = _reconstruct_seq(comp, r, reference_bases)
        else:
            bases = bytes(S[b"BA"].read_byte(core, ext) for _ in range(r.read_length))
            r.seq = bases.decode()
            if r.cram_flags & CF_QS_PRESERVED:
                r.quals = S[b"QS"].read_bytes(core, ext, r.read_length)
        records.append(r)
    return records


def _parse_tag_value(typ: str, raw: bytes):
    if typ == "A":
        return raw[:1].decode()
    if typ == "c":
        return struct.unpack("<b", raw)[0]
    if typ == "C":
        return raw[0]
    if typ == "s":
        return struct.unpack("<h", raw)[0]
    if typ == "S":
        return struct.unpack("<H", raw)[0]
    if typ == "i":
        return struct.unpack("<i", raw)[0]
    if typ == "I":
        return struct.unpack("<I", raw)[0]
    if typ == "f":
        return struct.unpack("<f", raw)[0]
    if typ in ("Z", "H"):
        return raw.rstrip(b"\x00").decode()
    if typ == "B":
        sub = chr(raw[0])
        body = raw[5:]  # sub-type + int32 count + values
        fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I", "f": "f"}[sub]
        n = struct.unpack("<i", raw[1:5])[0]
        return list(struct.unpack(f"<{n}{fmt}", body))
    return raw


def _reconstruct_seq(comp: CompressionHeader, r: CramRecord, reference_bases) -> str:
    """Rebuild the read sequence from the reference and feature list."""
    seq = [""] * r.read_length
    ref_pos = r.pos  # 1-based
    read_pos = 1

    def ref_base(p):
        if reference_bases is None:
            return "N"
        i = p - 1
        if 0 <= i < len(reference_bases):
            return reference_bases[i].upper()
        return "N"

    def fill_from_ref(upto):
        nonlocal ref_pos, read_pos
        while read_pos < upto:
            seq[read_pos - 1] = ref_base(ref_pos)
            ref_pos += 1
            read_pos += 1

    for fc, fpos, val in r.features:
        if fc in ("Q", "q"):
            continue
        fill_from_ref(fpos)
        if fc == "X":
            rb = ref_base(ref_pos)
            seq[read_pos - 1] = comp.sub_table.get(rb, comp.sub_table["N"]).get(val, "N")
            ref_pos += 1
            read_pos += 1
        elif fc == "S":
            for b in val:
                seq[read_pos - 1] = chr(b)
                read_pos += 1
        elif fc == "I":
            for b in val:
                seq[read_pos - 1] = chr(b)
                read_pos += 1
        elif fc == "i":
            seq[read_pos - 1] = chr(val)
            read_pos += 1
        elif fc == "B":
            seq[read_pos - 1] = chr(val[0])
            read_pos += 1
        elif fc == "b":
            for b in val:
                seq[read_pos - 1] = chr(b)
                read_pos += 1
        elif fc == "D":
            ref_pos += val
        elif fc == "N":
            ref_pos += val
        elif fc == "H" or fc == "P":
            pass
    fill_from_ref(r.read_length + 1)
    return "".join(seq)


def _cigar_from_features(r: CramRecord) -> List[Tuple[int, int]]:
    """CIGAR reconstruction: M runs between features, with I/D/N/S/H/P ops."""
    if r.flag & 4:
        return []
    ops: List[Tuple[int, int]] = []

    def add(op, ln):
        if ln <= 0:
            return
        if ops and ops[-1][0] == op:
            ops[-1] = (op, ops[-1][1] + ln)
        else:
            ops.append((op, ln))

    read_pos = 1
    for fc, fpos, val in r.features:
        if fc in ("Q", "q", "X", "i", "B"):
            # substitutions/single bases stay within an M run
            continue
        add(0, fpos - read_pos)
        read_pos = fpos
        if fc == "S":
            add(4, len(val))
            read_pos += len(val)
        elif fc == "I":
            add(1, len(val))
            read_pos += len(val)
        elif fc == "b":
            add(0, len(val))
            read_pos += len(val)
        elif fc == "D":
            add(2, val)
        elif fc == "N":
            add(3, val)
        elif fc == "H":
            add(5, val)
        elif fc == "P":
            add(6, val)
    add(0, r.read_length + 1 - read_pos)
    return ops


class CramReader:
    """Reads all records of a CRAM 3.0 file (small-file oriented: CRAM is an
    interchange input here, not the hot path)."""

    def __init__(self, path: str, reference_filename: Optional[str] = None):
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] != CRAM_MAGIC:
            raise ValueError(f"{path}: not a CRAM file")
        self.major, self.minor = data[4], data[5]
        cur = _Cursor(data, 26)  # magic + version + 20-byte file id

        # SAM header container
        h = _read_container_header(cur)
        end = cur.pos + h.length
        block = _read_block(cur)
        hcur = _Cursor(block.data)
        text_len = hcur.int32()
        self.header_text = hcur.read(text_len).split(b"\x00")[0].decode()
        cur.pos = end

        self._reference_filename = reference_filename
        self._ref_cache: Dict[str, Optional[str]] = {}
        self.records: List[Tuple[CramRecord, List[Tuple[int, int]]]] = []
        self._ref_names = self._parse_ref_names()

        while True:
            h = _read_container_header(cur)
            if h is None:
                break
            end = cur.pos + h.length
            if h.ref_id == -1 and h.start == 0x454F46:  # EOF container
                break
            comp = None
            slices: List[Tuple[SliceHeader, List[Block]]] = []
            blocks: List[Block] = []
            while cur.pos < end:
                blocks.append(_read_block(cur))
            bi = 0
            comp = CompressionHeader(blocks[bi].data)
            bi += 1
            while bi < len(blocks):
                sh = SliceHeader(blocks[bi].data)
                bi += 1
                sblocks = blocks[bi : bi + sh.n_blocks]
                bi += sh.n_blocks
                slices.append((sh, sblocks))
            for sh, sblocks in slices:
                if (
                    sh.ref_id >= 0
                    and comp.rr
                    and sh.embedded_ref_id < 0
                    and reference_filename is None
                ):
                    raise OSError(
                        "CRAM decoding requires the reference; pass --reference "
                        "(htslib would look it up via REF_PATH)"
                    )
                core = _BitReader(b"")
                ext: Dict[int, _Cursor] = {}
                for b in sblocks:
                    if b.content_type == 5:
                        core = _BitReader(b.data)
                    else:
                        ext[b.content_id] = _Cursor(b.data)
                refbases = self._reference_for(sh.ref_id)
                for rec in _decode_slice(comp, sh, core, ext, refbases):
                    self.records.append((rec, _cigar_from_features(rec)))
            cur.pos = end

    def _parse_ref_names(self) -> List[str]:
        names = []
        for line in self.header_text.split("\n"):
            if line.startswith("@SQ"):
                for field in line.split("\t")[1:]:
                    if field.startswith("SN:"):
                        names.append(field[3:])
        return names

    def _reference_for(self, ref_id: int) -> Optional[str]:
        if ref_id < 0 or ref_id >= len(self._ref_names):
            return None
        name = self._ref_names[ref_id]
        if name not in self._ref_cache:
            if self._reference_filename is None:
                self._ref_cache[name] = None
            else:
                from ..utils import IndexedFasta

                with IndexedFasta(self._reference_filename) as fa:
                    self._ref_cache[name] = str(fa[name][:])
        return self._ref_cache[name]


# ---------------------------------------------------------------------------
# CRAM 3.0 writer (no-reference mode)


def _enc_itf8(v: int) -> bytes:
    v &= 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF])
    return bytes(
        [
            0xF0 | ((v >> 28) & 0x0F),
            (v >> 20) & 0xFF,
            (v >> 12) & 0xFF,
            (v >> 4) & 0xFF,
            v & 0x0F,
        ]
    )


def _enc_ltf8(v: int) -> bytes:
    v &= (1 << 64) - 1
    if v < 0x80:
        return bytes([v])
    out = []
    n = v
    nbytes = 0
    while n:
        nbytes += 1
        n >>= 8
    # choose the smallest prefix that fits
    for extra in range(1, 9):
        avail = 8 - extra - 1 if extra < 8 else 0
        if v < (1 << (8 * extra + avail)):
            prefix = (0xFF << (8 - extra)) & 0xFF
            first = prefix | (v >> (8 * extra)) if extra < 8 else prefix
            out = [first] + [(v >> (8 * (extra - 1 - i))) & 0xFF for i in range(extra)]
            return bytes(out)
    raise ValueError("ltf8 overflow")


def _enc_block(method: int, content_type: int, content_id: int, data: bytes) -> bytes:
    if method == 1:
        import gzip

        payload = gzip.compress(data)
    else:
        payload = data
    head = (
        bytes([method, content_type])
        + _enc_itf8(content_id)
        + _enc_itf8(len(payload))
        + _enc_itf8(len(data))
    )
    body = head + payload
    return body + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)


def _enc_container(ref_id, start, span, n_records, counter, bases, blocks: List[bytes]) -> bytes:
    payload = b"".join(blocks)
    landmarks = []
    off = 0
    for b in blocks:
        landmarks.append(off)
        off += len(b)
    head = (
        _enc_itf8(ref_id)
        + _enc_itf8(start)
        + _enc_itf8(span)
        + _enc_itf8(n_records)
        + _enc_ltf8(counter)
        + _enc_ltf8(bases)
        + _enc_itf8(len(blocks))
        + _enc_itf8(len(landmarks))
        + b"".join(_enc_itf8(x) for x in landmarks)
    )
    full_head = struct.pack("<i", len(payload)) + head
    crc = struct.pack("<I", zlib.crc32(full_head) & 0xFFFFFFFF)
    return full_head + crc + payload


_EOF_CONTAINER = bytes.fromhex(
    "0f000000ffffffff0fe0454f4600000000010005bdd94f0001000606010001000100ee63014b"
)

# external block content ids for the writer's data series
_W_IDS = {
    b"BF": 1,
    b"CF": 2,
    b"RI": 3,
    b"RL": 4,
    b"AP": 5,
    b"RG": 6,
    b"MF": 7,
    b"NS": 8,
    b"NP": 9,
    b"TS": 10,
    b"TL": 11,
    b"FN": 12,
    b"FP": 13,
    b"MQ": 14,
}
_W_RN = 20  # byte-array-stop
_W_QS = 21
_W_BA = 22
_W_FC = 23
_W_BB_LEN = 24
_W_BB_VAL = 25
_W_IN_LEN = 26
_W_IN_VAL = 27
_W_SC_LEN = 28
_W_SC_VAL = 29
_W_DL = 30
_W_TAG_BASE = 40


class CramWriter:
    """Writes CRAM 3.0 in no-reference mode: M-runs carry their bases as
    'b' (BB) features, so sequences and CIGARs round-trip without a
    reference (RR=false).  One slice per file-sized chunk; every data series
    EXTERNAL (ITF8) except read names (BYTE_ARRAY_STOP) and byte arrays
    (BYTE_ARRAY_LEN over EXTERNAL streams)."""

    def __init__(self, fileobj, header_text: str):
        self._f = fileobj
        self._header_text = header_text
        self._segments = []

    def write(self, seg) -> None:
        self._segments.append(seg)

    def close(self) -> None:
        f = self._f
        f.write(CRAM_MAGIC + bytes([3, 0]) + b"whatshap_torch".ljust(20, b"\x00"))
        text = self._header_text.encode()
        hblock_data = struct.pack("<i", len(text)) + text
        hblock = _enc_block(0, 0, 0, hblock_data)
        f.write(_enc_container(0, 0, 0, 0, 0, 0, [hblock]))
        if self._segments:
            f.write(self._encode_slice_container(self._segments))
        f.write(_EOF_CONTAINER)

    # -- encoding helpers ------------------------------------------------

    def _encode_slice_container(self, segments) -> bytes:
        ext: Dict[int, bytearray] = {}

        def put_int(cid, v):
            ext.setdefault(cid, bytearray()).extend(_enc_itf8(v))

        def put_bytes(cid, b):
            ext.setdefault(cid, bytearray()).extend(b)

        tag_lines: List[Tuple] = []
        tag_ids: Dict[Tuple[str, str], int] = {}
        tag_cids: Dict[int, int] = {}
        n_bases = 0

        for seg in segments:
            flag = seg.flag
            mf = (1 if flag & 0x20 else 0) | (2 if flag & 0x8 else 0)
            cf = CF_DETACHED | (CF_QS_PRESERVED if seg.query_qualities is not None else 0)
            put_int(_W_IDS[b"BF"], flag)
            put_int(_W_IDS[b"CF"], cf)
            put_int(_W_IDS[b"RI"], seg.reference_id)
            rl = len(seg.query_sequence or "")
            put_int(_W_IDS[b"RL"], rl)
            n_bases += rl
            put_int(_W_IDS[b"AP"], (seg.reference_start + 1) if seg.reference_start >= 0 else 0)
            put_int(_W_IDS[b"RG"], -1)
            put_bytes(_W_RN, (seg.query_name or "*").encode() + b"\x00")
            put_int(_W_IDS[b"MF"], mf)
            put_int(_W_IDS[b"NS"], seg.next_reference_id)
            put_int(_W_IDS[b"NP"], (seg.next_reference_start + 1) if seg.next_reference_start >= 0 else 0)
            put_int(_W_IDS[b"TS"], seg.template_length)

            # tag line
            line = tuple(
                (t, _tag_type(v)) for t, v in seg.tags.items()
            )
            if line not in tag_ids:
                tag_ids[line] = len(tag_lines)
                tag_lines.append(line)
            put_int(_W_IDS[b"TL"], tag_ids[line])
            for (t, typ), (_, v) in zip(line, seg.tags.items()):
                key = _tag_key(t, typ)
                if key not in tag_cids:
                    tag_cids[key] = _W_TAG_BASE + 2 * len(tag_cids)
                cid = tag_cids[key]
                raw = _tag_raw(typ, v)
                put_int(cid, len(raw))
                put_bytes(cid + 1, raw)

            if not (flag & 4):
                feats = self._features(seg)
                put_int(_W_IDS[b"FN"], len(feats))
                prev = 0
                for fc, fpos, val in feats:
                    put_bytes(_W_FC, bytes([ord(fc)]))
                    put_int(_W_IDS[b"FP"], fpos - prev)
                    prev = fpos
                    if fc == "b":
                        put_int(_W_BB_LEN, len(val))
                        put_bytes(_W_BB_VAL, val)
                    elif fc == "I":
                        put_int(_W_IN_LEN, len(val))
                        put_bytes(_W_IN_VAL, val)
                    elif fc == "S":
                        put_int(_W_SC_LEN, len(val))
                        put_bytes(_W_SC_VAL, val)
                    elif fc in ("D", "N", "H", "P"):
                        put_int(_W_DL, val)
                put_int(_W_IDS[b"MQ"], seg.mapping_quality)
            else:
                put_bytes(_W_BA, (seg.query_sequence or "").encode())
            if seg.query_qualities is not None:
                put_bytes(_W_QS, bytes(seg.query_qualities))

        comp_block = _enc_block(0, 1, 0, self._compression_header(tag_lines, tag_cids))
        ext_ids = sorted(ext)
        core_block = _enc_block(0, 5, 0, b"")
        ext_blocks = [_enc_block(1, 4, cid, bytes(ext[cid])) for cid in ext_ids]
        slice_head = (
            _enc_itf8(-2)  # multi-ref
            + _enc_itf8(0)
            + _enc_itf8(0)
            + _enc_itf8(len(segments))
            + _enc_ltf8(0)
            + _enc_itf8(1 + len(ext_blocks))
            + _enc_itf8(len(ext_ids))
            + b"".join(_enc_itf8(x) for x in ext_ids)
            + _enc_itf8(-1)
            + bytes(16)
        )
        slice_block = _enc_block(0, 2, 0, slice_head)
        blocks = [comp_block, slice_block, core_block] + ext_blocks
        return _enc_container(
            -2, 0, 0, len(segments), 0, n_bases, blocks
        )

    @staticmethod
    def _features(seg):
        feats = []
        seq = seg.query_sequence or ""
        read_pos = 1
        for op, ln in seg.cigartuples or [(0, len(seq))]:
            if op in (0, 7, 8):  # M/=/X -> verbatim bases
                feats.append(("b", read_pos, seq[read_pos - 1 : read_pos - 1 + ln].encode()))
                read_pos += ln
            elif op == 1:
                feats.append(("I", read_pos, seq[read_pos - 1 : read_pos - 1 + ln].encode()))
                read_pos += ln
            elif op == 4:
                feats.append(("S", read_pos, seq[read_pos - 1 : read_pos - 1 + ln].encode()))
                read_pos += ln
            elif op == 2:
                feats.append(("D", read_pos, ln))
            elif op == 3:
                feats.append(("N", read_pos, ln))
            elif op == 5:
                feats.append(("H", read_pos, ln))
            elif op == 6:
                feats.append(("P", read_pos, ln))
        return feats

    def _compression_header(self, tag_lines, tag_cids) -> bytes:
        def enc_map(entries: List[bytes]) -> bytes:
            body = b"".join(entries)
            inner = _enc_itf8(len(entries)) + body
            return _enc_itf8(len(inner)) + inner

        # preservation map
        td = bytearray()
        for line in tag_lines:
            for t, typ in line:
                td.extend(t.encode() + typ.encode())
            td.append(0)
        if not tag_lines:
            td.append(0)
        pres = enc_map(
            [
                b"RN" + bytes([1]),
                b"AP" + bytes([0]),
                b"RR" + bytes([0]),
                b"SM" + bytes(5),
                b"TD" + _enc_itf8(len(td)) + bytes(td),
            ]
        )

        def ext_enc(cid):
            params = _enc_itf8(cid)
            return _enc_itf8(1) + _enc_itf8(len(params)) + params

        def stop_enc(stop, cid):
            params = bytes([stop]) + _enc_itf8(cid)
            return _enc_itf8(5) + _enc_itf8(len(params)) + params

        def bal_enc(len_cid, val_cid):
            inner_len = _enc_itf8(len_cid)
            inner_val = _enc_itf8(val_cid)
            params = (
                _enc_itf8(1)
                + _enc_itf8(len(inner_len))
                + inner_len
                + _enc_itf8(1)
                + _enc_itf8(len(inner_val))
                + inner_val
            )
            return _enc_itf8(4) + _enc_itf8(len(params)) + params

        series = []
        for key, cid in _W_IDS.items():
            series.append(key + ext_enc(cid))
        series.append(b"RN" + stop_enc(0, _W_RN))
        series.append(b"QS" + ext_enc(_W_QS))
        series.append(b"BA" + ext_enc(_W_BA))
        series.append(b"FC" + ext_enc(_W_FC))
        series.append(b"BB" + bal_enc(_W_BB_LEN, _W_BB_VAL))
        series.append(b"IN" + bal_enc(_W_IN_LEN, _W_IN_VAL))
        series.append(b"SC" + bal_enc(_W_SC_LEN, _W_SC_VAL))
        series.append(b"DL" + ext_enc(_W_DL))
        series.append(b"RS" + ext_enc(_W_DL))
        series.append(b"HC" + ext_enc(_W_DL))
        series.append(b"PD" + ext_enc(_W_DL))
        smap = enc_map(series)

        tags = []
        for key, cid in tag_cids.items():
            tags.append(_enc_itf8(key) + bal_enc(cid, cid + 1))
        tmap = enc_map(tags)
        return pres + smap + tmap


def _tag_key(tag: str, typ: str) -> int:
    return (ord(tag[0]) << 16) | (ord(tag[1]) << 8) | ord(typ)


def _tag_type(v) -> str:
    if isinstance(v, int):
        return "i"
    if isinstance(v, float):
        return "f"
    if isinstance(v, list):
        return "B"
    if isinstance(v, str) and len(v) == 1:
        return "A" if False else "Z"
    return "Z"


def _tag_raw(typ: str, v) -> bytes:
    if typ == "i":
        return struct.pack("<i", v)
    if typ == "f":
        return struct.pack("<f", v)
    if typ == "Z":
        return str(v).encode() + b"\x00"
    if typ == "B":
        if all(isinstance(x, int) for x in v):
            return b"i" + struct.pack("<i", len(v)) + struct.pack(f"<{len(v)}i", *v)
        return b"f" + struct.pack("<i", len(v)) + struct.pack(f"<{len(v)}f", *v)
    return str(v).encode()
