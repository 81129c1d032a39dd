"""
BCF2 (binary VCF) reading and writing.

Layout (SAM/VCF spec section 6): BGZF-compressed stream starting with magic
``BCF\\2\\x02``, a text VCF header, then records of typed binary values.
The reference gets this via pysam/htslib (whatshap/vcf.py uses
pysam.VariantFile, which picks BCF by file extension); here both directions
are implemented natively.
"""

import struct
from typing import Iterator, List, Optional, Tuple

from .bgzf import BGZFReader, BGZFWriter
from . import vcflib


def _read_typed_descriptor(buf, off) -> Tuple[int, int, int]:
    """Return (type, length, new_offset)."""
    b = buf[off]
    off += 1
    typ = b & 0x0F
    length = b >> 4
    if length == 15:
        # length given as a following typed integer
        val, off = _read_typed_value_scalar(buf, off)
        length = val
    return typ, length, off


def _read_typed_value_scalar(buf, off):
    typ, length, off = _read_typed_descriptor(buf, off)
    assert length == 1
    return _read_scalar(buf, off, typ)


def _read_scalar(buf, off, typ):
    if typ == 1:
        return struct.unpack_from("<b", buf, off)[0], off + 1
    if typ == 2:
        return struct.unpack_from("<h", buf, off)[0], off + 2
    if typ == 3:
        return struct.unpack_from("<i", buf, off)[0], off + 4
    if typ == 5:
        return struct.unpack_from("<f", buf, off)[0], off + 4
    raise ValueError(f"unsupported BCF scalar type {typ}")


_INT_MISSING = {1: -128, 2: -32768, 3: -2147483648}
_INT_EOV = {1: -127, 2: -32767, 3: -2147483647}
_FLOAT_MISSING = b"\x01\x00\x80\x7f"  # 0x7F800001
_FLOAT_EOV = b"\x02\x00\x80\x7f"  # 0x7F800002


def _read_typed(buf, off):
    """Read one typed value (scalar, vector, or string)."""
    typ, length, off = _read_typed_descriptor(buf, off)
    if typ == 0:
        return None, off
    if typ == 7:  # char string
        s = buf[off : off + length].decode()
        return s, off + length
    vals = []
    for _ in range(length):
        v, off = _read_scalar(buf, off, typ)
        if typ in _INT_MISSING and v == _INT_MISSING[typ]:
            v = None
        vals.append(v)
    if length == 1:
        return vals[0], off
    return vals, off


class BCFParser:
    def __init__(self, path: str):
        self._reader = BGZFReader(path)
        magic = self._reader.read(5)
        if magic[:3] != b"BCF":
            raise vcflib.VcfFormatError("not a BCF file")
        (l_text,) = struct.unpack("<I", self._reader.read(4))
        text = self._reader.read(l_text).rstrip(b"\x00").decode()
        lines = text.splitlines()
        self.header = vcflib.VariantHeader.parse([ln + "\n" for ln in lines])
        # IDX-aware string dictionary: FILTER/INFO/FORMAT ids by index
        self._dict: List[str] = []
        idx_map = {}
        n = 0
        for ln in lines:
            m = vcflib._HEADER_STRUCTURED_RE.match(ln)
            if not m:
                continue
            kind = m.group(1)
            if kind not in ("FILTER", "INFO", "FORMAT"):
                continue
            fields = vcflib._split_structured(m.group(2))
            ident = fields.get("ID")
            if ident in idx_map:
                continue
            if "IDX" in fields:
                idx_map[ident] = int(fields["IDX"])
            else:
                idx_map[ident] = n
                n += 1
        if "PASS" not in idx_map:
            idx_map["PASS"] = 0
        size = max(idx_map.values()) + 1 if idx_map else 0
        self._dict = [""] * size
        for ident, i in idx_map.items():
            if i < size:
                self._dict[i] = ident
        self._contigs = list(self.header.contigs)

    def __iter__(self) -> Iterator[vcflib.VariantRecord]:
        while True:
            head = self._reader.read(8)
            if len(head) < 8:
                return
            l_shared, l_indiv = struct.unpack("<II", head)
            shared = self._reader.read(l_shared)
            indiv = self._reader.read(l_indiv)
            if len(shared) < l_shared:
                return
            yield self._parse_record(shared, indiv)

    def _parse_record(self, shared: bytes, indiv: bytes) -> vcflib.VariantRecord:
        rec = vcflib.VariantRecord(self.header)
        (chrom_idx, pos, _rlen) = struct.unpack_from("<iii", shared, 0)
        (qual,) = struct.unpack_from("<f", shared, 12)
        (n_allele_info,) = struct.unpack_from("<I", shared, 16)
        (n_fmt_sample,) = struct.unpack_from("<I", shared, 20)
        n_allele = n_allele_info >> 16
        n_info = n_allele_info & 0xFFFF
        n_fmt = n_fmt_sample >> 24
        n_sample = n_fmt_sample & 0xFFFFFF
        off = 24
        rec.chrom = self._contigs[chrom_idx]
        rec.pos = pos + 1
        if qual == qual and struct.pack("<f", qual) != b"\x01\x00\x80\x7f":
            rec.qual = float(qual)
        else:
            rec.qual = None
        vid, off = _read_typed(shared, off)
        rec.id = vid if vid else None
        alleles = []
        for _ in range(n_allele):
            a, off = _read_typed(shared, off)
            alleles.append(a)
        rec.ref = alleles[0] if alleles else ""
        rec.alts = tuple(alleles[1:]) if len(alleles) > 1 else None
        filt, off = _read_typed(shared, off)
        if filt is None:
            rec.filter = "."
        else:
            ids = filt if isinstance(filt, list) else [filt]
            rec.filter = ";".join(self._dict[i] for i in ids) or "."
        info_parts = []
        for _ in range(n_info):
            key_idx, off = _read_typed_value_scalar(shared, off)
            val, off = _read_typed(shared, off)
            key = self._dict[key_idx]
            if val is None:
                info_parts.append(key)
            elif isinstance(val, list):
                info_parts.append(
                    f"{key}={','.join('.' if v is None else _fmt(v) for v in val)}"
                )
            else:
                info_parts.append(f"{key}={_fmt(val)}")
        rec.set_info_raw(";".join(info_parts) if info_parts else ".")

        # FORMAT / per-sample values
        off = 0
        names = self.header.samples
        per_sample = [dict() for _ in names]
        fmt_keys = []
        for _ in range(n_fmt):
            key_idx, off = _read_typed_value_scalar(indiv, off)
            key = self._dict[key_idx]
            typ, length, off = _read_typed_descriptor(indiv, off)
            fmt_keys.append(key)
            for s in range(n_sample):
                if typ == 7:
                    raw = indiv[off : off + length].decode().rstrip("\x00")
                    off += length
                    per_sample[s][key] = raw if raw else "."
                else:
                    vals = []
                    for _i in range(length):
                        v, off = _read_scalar(indiv, off, typ)
                        vals.append((typ, v))
                    if key == "GT":
                        per_sample[s][key] = _decode_gt(vals)
                    else:
                        out = []
                        for typ_i, v in vals:
                            if typ_i in _INT_EOV and v == _INT_EOV[typ_i]:
                                continue  # end of vector
                            if typ_i == 5 and struct.pack("<f", v) == _FLOAT_EOV:
                                continue  # float end-of-vector (htslib 0x7F800002)
                            if typ_i in _INT_MISSING and v == _INT_MISSING[typ_i]:
                                out.append(".")
                            elif typ_i == 5 and v != v:
                                out.append(".")
                            else:
                                out.append(_fmt(v))
                        per_sample[s][key] = ",".join(out) if out else "."
        rec.format = fmt_keys
        calls = [vcflib.VariantRecordSample(rec, values) for values in per_sample]
        rec.samples = vcflib._SampleMap(list(names), calls)
        return rec


def _decode_gt(vals) -> str:
    parts = []
    phased_next = False
    out = []
    for i, (typ, v) in enumerate(vals):
        if typ in _INT_EOV and v == _INT_EOV[typ]:
            break
        if typ in _INT_MISSING and v == _INT_MISSING[typ]:
            allele = "."
            sep = "/"
        else:
            allele = str((v >> 1) - 1) if (v >> 1) >= 1 else "."
            sep = "|" if (v & 1) else "/"
        if i == 0:
            out.append(allele)
        else:
            out.append(sep + allele)
    return "".join(out) if out else "."


def _fmt(v) -> str:
    if isinstance(v, float):
        if v == int(v):
            return str(int(v))
        return f"{v:g}"
    return str(v)


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------


def _int_type(vals: List[Optional[int]]) -> int:
    """Smallest BCF integer type whose usable range covers all values
    (the bottom 8 values of each range are reserved sentinels)."""
    lo = min((v for v in vals if v is not None), default=0)
    hi = max((v for v in vals if v is not None), default=0)
    if -120 <= lo and hi <= 127:
        return 1
    if -32760 <= lo and hi <= 32767:
        return 2
    return 3


_INT_PACK = {1: "<b", 2: "<h", 3: "<i"}


def _typed_descriptor(typ: int, length: int) -> bytes:
    if length < 15:
        return bytes([(length << 4) | typ])
    out = bytes([(15 << 4) | typ])
    it = _int_type([length])
    out += bytes([(1 << 4) | it]) + struct.pack(_INT_PACK[it], length)
    return out


def _typed_string(s: Optional[str]) -> bytes:
    if not s:
        return _typed_descriptor(7, 0)
    b = s.encode()
    return _typed_descriptor(7, len(b)) + b


def _typed_ints(vals: List[Optional[int]]) -> bytes:
    it = _int_type(vals)
    out = _typed_descriptor(it, len(vals))
    for v in vals:
        out += struct.pack(_INT_PACK[it], _INT_MISSING[it] if v is None else v)
    return out


def _typed_int_scalar(v: int) -> bytes:
    return _typed_ints([v])


class BCFWriter:
    """BCF2.2 writer mirroring what pysam/htslib emits for ``mode="wb"``.

    Works from the same textual record representation the VCF writer uses
    (io/vcflib.py VariantRecord); values are encoded using the
    FORMAT/INFO Type declarations in the header.
    """

    def __init__(self, raw_handle, header):
        self._raw = raw_handle
        self._bgzf = BGZFWriter(raw_handle)
        self.header = header
        text = header.text()
        # string dictionary: replicate BCFParser's reconstruction from the
        # header text exactly, so every file round-trips through our reader
        idx_map = {}
        n = 0
        for ln in text.splitlines():
            m = vcflib._HEADER_STRUCTURED_RE.match(ln)
            if not m or m.group(1) not in ("FILTER", "INFO", "FORMAT"):
                continue
            fields = vcflib._split_structured(m.group(2))
            ident = fields.get("ID")
            if ident in idx_map:
                continue
            if "IDX" in fields:
                idx_map[ident] = int(fields["IDX"])
            else:
                idx_map[ident] = n
                n += 1
        if "PASS" not in idx_map:
            idx_map["PASS"] = 0
        self._dict = idx_map
        self._contigs = {name: i for i, name in enumerate(header.contigs)}
        payload = text.encode() + b"\x00"
        self._bgzf.write(b"BCF\x02\x02" + struct.pack("<I", len(payload)) + payload)

    # -- encoding helpers ------------------------------------------------

    def _encode_info(self, key: str, raw) -> bytes:
        out = _typed_int_scalar(self._dict[key])
        field = self.header.infos.get(key)
        typ = field.type if field is not None else "String"
        if raw is True or typ == "Flag":
            return out + b"\x00"  # typed null (flag presence)
        if typ in ("Integer", "Float"):
            parts = str(raw).split(",")
            if typ == "Integer":
                vals = [None if p == "." else int(p) for p in parts]
                return out + _typed_ints(vals)
            buf = _typed_descriptor(5, len(parts))
            for p in parts:
                buf += _FLOAT_MISSING if p == "." else struct.pack("<f", float(p))
            return out + buf
        return out + _typed_string(str(raw))

    def _encode_gt_cell(self, gt: str) -> List[int]:
        vals = []
        phased = False
        allele = ""
        for ch in gt + "/":
            if ch in "|/":
                if allele == "." or allele == "":
                    v = 0
                else:
                    v = (int(allele) + 1) << 1
                if phased:
                    v |= 1
                vals.append(v)
                phased = ch == "|"
                allele = ""
            else:
                allele += ch
        return vals

    def _encode_format_key(self, key: str, cells: List[str]) -> bytes:
        out = _typed_int_scalar(self._dict[key])
        field = self.header.formats.get(key)
        typ = field.type if field is not None else "String"
        if key == "GT":
            per = [self._encode_gt_cell(c if c else ".") for c in cells]
            width = max(len(p) for p in per)
            flat = [v for p in per for v in p + [None] * (width - len(p))]
            it = _int_type([v for v in flat if v is not None])
            buf = _typed_descriptor(it, width)
            for p in per:
                for v in p:
                    buf += struct.pack(_INT_PACK[it], v)
                for _ in range(width - len(p)):
                    buf += struct.pack(_INT_PACK[it], _INT_EOV[it])
            return out + buf
        if typ == "Integer":
            per = [
                [None if x in (".", "") else int(x) for x in (c or ".").split(",")]
                for c in cells
            ]
            width = max(len(p) for p in per)
            it = _int_type([v for p in per for v in p])
            buf = _typed_descriptor(it, width)
            for p in per:
                for v in p:
                    buf += struct.pack(_INT_PACK[it], _INT_MISSING[it] if v is None else v)
                for _ in range(width - len(p)):
                    buf += struct.pack(_INT_PACK[it], _INT_EOV[it])
            return out + buf
        if typ == "Float":
            per = [(c or ".").split(",") for c in cells]
            width = max(len(p) for p in per)
            buf = _typed_descriptor(5, width)
            for p in per:
                for x in p:
                    buf += (
                        _FLOAT_MISSING if x in (".", "") else struct.pack("<f", float(x))
                    )
                buf += _FLOAT_EOV * (width - len(p))
            return out + buf
        # String / Character: fixed-width NUL-padded char vectors
        enc = [(c if c not in ("", None) else ".").encode() for c in cells]
        width = max(max(len(e) for e in enc), 1)
        buf = _typed_descriptor(7, width)
        for e in enc:
            buf += e + b"\x00" * (width - len(e))
        return out + buf

    # -- record emission -------------------------------------------------

    def write(self, rec) -> None:
        if rec.chrom not in self._contigs:
            raise vcflib.VcfFormatError(
                f"BCF output requires a ##contig header line for {rec.chrom!r}"
            )
        n_sample = len(self.header.samples)
        fmt_keys = [
            k
            for k in rec.format
            if k == "GT" or any(k in c._values for c in rec.samples.values())
        ]
        if n_sample and not fmt_keys:
            fmt_keys = ["GT"]
        for k in fmt_keys:
            if k not in self._dict:
                raise vcflib.VcfFormatError(
                    f"FORMAT field {k!r} is not defined in the header "
                    "(required for BCF output)"
                )

        info = rec.info
        info_items = list(info.items())
        for k, _v in info_items:
            if k not in self._dict:
                raise vcflib.VcfFormatError(
                    f"INFO field {k!r} is not defined in the header "
                    "(required for BCF output)"
                )

        shared = struct.pack(
            "<iii",
            self._contigs[rec.chrom],
            rec.pos - 1,
            max(len(rec.ref), 1),
        )
        shared += (
            struct.pack("<f", rec.qual) if rec.qual is not None else _FLOAT_MISSING
        )
        n_allele = 1 + (len(rec.alts) if rec.alts else 0)
        shared += struct.pack("<I", (n_allele << 16) | len(info_items))
        shared += struct.pack("<I", (len(fmt_keys) << 24) | n_sample)
        shared += _typed_string(rec.id)
        shared += _typed_string(rec.ref)
        for alt in rec.alts or ():
            shared += _typed_string(alt)
        filt = rec.filter
        if not filt or filt == ".":
            shared += b"\x00"
        else:
            ids = [self._dict[f] for f in filt.split(";") if f in self._dict]
            shared += _typed_ints(ids) if ids else b"\x00"
        for k, v in info_items:
            shared += self._encode_info(k, v)

        indiv = b""
        if n_sample:
            for call in rec.samples.values():
                call._rewrite_gt_separator()
            for k in fmt_keys:
                cells = [c._values.get(k, ".") for c in rec.samples.values()]
                indiv += self._encode_format_key(k, cells)

        self._bgzf.write(
            struct.pack("<II", len(shared), len(indiv)) + shared + indiv
        )

    def close(self) -> None:
        if self._bgzf is not None:
            self._bgzf.close()
            self._bgzf = None
