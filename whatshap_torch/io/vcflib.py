"""
Native VCF reading/writing with a pysam-like surface (no htslib).

Provides VariantFile / VariantHeader / VariantRecord / VariantRecordSample
with the subset of the pysam API that the domain layer (whatshap_torch.vcf)
uses: header introspection (samples, contigs, formats, infos), record
iteration, typed per-sample FORMAT access (GT with phased flag), record
mutation, and VCF text output (plain or bgzip by file extension).

Supports plain and gzip/BGZF-compressed VCF input and BCF (binary VCF)
reading.
"""

import gzip
import io
import os
import re
import struct
from typing import Dict, Iterator, List, Optional, Tuple, Union

from .bgzf import BGZFWriter, is_gzip

MISSING = "."


class VcfFormatError(ValueError):
    # subclass of ValueError so header-repair code can treat malformed
    # records like htslib/pysam parse errors
    pass


_HEADER_STRUCTURED_RE = re.compile(r"##(\w+)=<(.*)>\s*$")


def _split_structured(body: str) -> Dict[str, str]:
    """Split 'ID=GT,Number=1,Type=String,Description="..."' into a dict."""
    out = {}
    key = []
    val = []
    in_key = True
    in_quotes = False
    i = 0
    cur_key = ""
    token = []
    while i < len(body):
        c = body[i]
        if in_key:
            if c == "=":
                cur_key = "".join(token)
                token = []
                in_key = False
            else:
                token.append(c)
        else:
            if c == '"':
                in_quotes = not in_quotes
                token.append(c)
            elif c == "," and not in_quotes:
                out[cur_key] = "".join(token)
                token = []
                in_key = True
            else:
                token.append(c)
        i += 1
    if cur_key and not in_key:
        out[cur_key] = "".join(token)
    return out


def _unquote(s: str) -> str:
    if len(s) >= 2 and s[0] == '"' and s[-1] == '"':
        return s[1:-1]
    return s


class HeaderField:
    """A FORMAT or INFO definition."""

    __slots__ = ("id", "number", "type", "description", "raw")

    def __init__(self, id, number, type_, description, raw=None):
        self.id = id
        self.number = number
        self.type = type_
        self.description = description
        self.raw = raw

    def line(self, kind: str) -> str:
        if self.raw is not None:
            return self.raw
        return (
            f"##{kind}=<ID={self.id},Number={self.number},Type={self.type},"
            f'Description="{self.description}">'
        )


class Contig:
    __slots__ = ("name", "length", "raw")

    def __init__(self, name, length=None, raw=None):
        self.name = name
        self.length = length
        self.raw = raw

    def line(self) -> str:
        if self.raw is not None:
            return self.raw
        if self.length is not None:
            return f"##contig=<ID={self.name},length={self.length}>"
        return f"##contig=<ID={self.name}>"


class VariantHeader:
    def __init__(self):
        # ordered list of (kind, payload) entries; kind in
        # {"raw", "contig", "format", "info", "filter"}
        self._lines: List[Tuple[str, object]] = [("raw", "##fileformat=VCFv4.2")]
        self.samples: List[str] = []
        self.contigs: Dict[str, Contig] = {}
        self.formats: Dict[str, HeaderField] = {}
        self.infos: Dict[str, HeaderField] = {}
        self.filters: Dict[str, str] = {}

    @classmethod
    def parse(cls, lines: List[str]) -> "VariantHeader":
        header = cls()
        header._lines = []
        for line in lines:
            line = line.rstrip("\n")
            if line.startswith("##"):
                header.add_line(line)
            elif line.startswith("#CHROM"):
                fields = line.split("\t")
                if len(fields) > 9:
                    header.samples = fields[9:]
        return header

    def add_line(self, line: str) -> None:
        line = line.rstrip("\n")
        m = _HEADER_STRUCTURED_RE.match(line)
        if m:
            kind = m.group(1)
            fields = _split_structured(m.group(2))
            if kind == "contig":
                c = Contig(
                    fields.get("ID"),
                    int(fields["length"]) if "length" in fields else None,
                    raw=line,
                )
                self.contigs[c.name] = c
                self._lines.append(("contig", c))
                return
            if kind in ("FORMAT", "INFO"):
                number = fields.get("Number", ".")
                f = HeaderField(
                    fields.get("ID"),
                    number,
                    fields.get("Type", "String"),
                    _unquote(fields.get("Description", "")),
                    raw=line,
                )
                target = self.formats if kind == "FORMAT" else self.infos
                target[f.id] = f
                self._lines.append(("format" if kind == "FORMAT" else "info", f))
                return
            if kind == "FILTER":
                self.filters[fields.get("ID")] = line
                self._lines.append(("filter", line))
                return
        self._lines.append(("raw", line))

    def remove_format(self, fmt_id: str) -> None:
        self.formats.pop(fmt_id, None)
        self._lines = [
            (k, v)
            for (k, v) in self._lines
            if not (k == "format" and getattr(v, "id", None) == fmt_id)
        ]

    def add_contig(self, name: str, length: Optional[int] = None) -> None:
        if name in self.contigs:
            return
        c = Contig(name, length)
        self.contigs[name] = c
        self._lines.append(("contig", c))

    def add_meta(self, key: str, value: str) -> None:
        self._lines.append(("raw", f"##{key}={value}"))

    def remove_meta_key(self, key: str) -> None:
        """Drop unstructured header lines of the form ##key=..."""
        self._lines = [
            (k, v)
            for (k, v) in self._lines
            if not (k == "raw" and isinstance(v, str) and v.startswith(f"##{key}="))
        ]

    def copy(self) -> "VariantHeader":
        import copy as _copy

        return _copy.deepcopy(self)

    def text(self) -> str:
        out = []
        # htslib always declares the PASS filter right after ##fileformat
        if "PASS" not in self.filters:
            lines = list(self._lines)
            pass_line = (
                "filter",
                '##FILTER=<ID=PASS,Description="All filters passed">',
            )
            if lines and lines[0][0] == "raw" and str(lines[0][1]).startswith("##fileformat"):
                lines.insert(1, pass_line)
            else:
                lines.insert(0, pass_line)
        else:
            lines = self._lines
        for kind, v in lines:
            if kind == "raw":
                out.append(v)
            elif kind == "contig":
                out.append(v.line())
            elif kind == "format":
                out.append(v.line("FORMAT"))
            elif kind == "info":
                out.append(v.line("INFO"))
            elif kind == "filter":
                out.append(v)
        cols = ["#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO"]
        if self.samples:
            cols += ["FORMAT"] + list(self.samples)
        out.append("\t".join(cols))
        return "\n".join(out) + "\n"

    def format_number(self, fmt_id: str) -> Union[str, int]:
        f = self.formats.get(fmt_id)
        if f is None:
            return "."
        try:
            return int(f.number)
        except (TypeError, ValueError):
            return f.number

    def format_type(self, fmt_id: str) -> str:
        f = self.formats.get(fmt_id)
        return f.type if f is not None else "String"


def _parse_typed(value: str, typ: str):
    # String fields keep "." verbatim (matching htslib/pysam, whose callers
    # compare against ('.',)); numeric fields convert it to None.
    if typ == "Integer":
        if value in (MISSING, ""):
            return None
        try:
            return int(value)
        except ValueError:
            return None
    if typ == "Float":
        if value in (MISSING, ""):
            return None
        try:
            return float(value)
        except ValueError:
            return None
    return value


class VariantRecordSample:
    """Typed access to one sample's FORMAT fields (pysam-compatible API)."""

    __slots__ = ("_record", "_values", "phased", "_gt_cache")

    def __init__(self, record: "VariantRecord", values: Dict[str, str]):
        self._record = record
        self._values = values  # field -> raw string
        self.phased = False
        self._gt_cache = None  # (raw string, parsed tuple)
        gt_raw = values.get("GT")
        if gt_raw is not None and "|" in gt_raw:
            self.phased = True

    def keys(self):
        return [k for k in self._record.format if k in self._values or k == "GT"]

    def __iter__(self):
        return iter(self.keys())

    def __contains__(self, key) -> bool:
        return key in self._values

    def get(self, key, default=None):
        # pysam semantics: the default applies only when the field is absent;
        # a present-but-missing value (".") yields None
        if key not in self._values:
            return default
        return self[key]

    def __getitem__(self, key):
        raw = self._values.get(key)
        if key == "GT":
            if raw is None:
                return None
            # hot path: callers re-read GT several times per record (phase
            # extraction, genotype coding, depth checks) — memoize on the
            # raw string, and parse the ubiquitous "a/b" / "a|b" diploid
            # shape without the regex
            cache = self._gt_cache
            if cache is not None and cache[0] == raw:
                return cache[1]
            if len(raw) == 3 and (raw[1] == "/" or raw[1] == "|"):
                a, b = raw[0], raw[2]
                parsed = (
                    None if a == MISSING else int(a),
                    None if b == MISSING else int(b),
                )
            else:
                alleles = re.split(r"[/|]", raw)
                parsed = tuple(
                    None if a in (MISSING, "") else int(a) for a in alleles
                )
            self._gt_cache = (raw, parsed)
            return parsed
        if raw is None:
            raise KeyError(key)
        header = self._record.header
        typ = header.format_type(key)
        number = header.format_number(key)
        if number == 1:
            return _parse_typed(raw, typ)
        parts = raw.split(",")
        if all(p == MISSING for p in parts):
            return tuple(_parse_typed(p, typ) for p in parts)
        return tuple(_parse_typed(p, typ) for p in parts)

    def __setitem__(self, key, value) -> None:
        if key == "GT":
            if value is None or len(value) == 0:
                self._values["GT"] = MISSING
                self.phased = False
            else:
                sep = "|" if self.phased else "/"
                self._values["GT"] = sep.join(
                    MISSING if a is None else str(a) for a in value
                )
            self._record._ensure_format("GT")
            return
        if value is None:
            # pysam semantics: setting None clears the value
            self._values.pop(key, None)
            return
        if isinstance(value, (list, tuple)):
            raw = ",".join(MISSING if v is None else _format_value(v) for v in value)
        else:
            raw = _format_value(value)
        self._values[key] = raw
        self._record._ensure_format(key)

    def __delitem__(self, key) -> None:
        self._values.pop(key, None)

    def _rewrite_gt_separator(self) -> None:
        raw = self._values.get("GT")
        if raw is None:
            return
        if self.phased:
            if "/" in raw:
                self._values["GT"] = raw.replace("/", "|")
        elif "|" in raw:
            self._values["GT"] = raw.replace("|", "/")

    def items(self):
        return [(k, self[k]) for k in self.keys()]


def _format_value(v) -> str:
    if isinstance(v, float):
        # match htslib's %g formatting
        return f"{v:g}"
    return str(v)


class _SampleMap:
    """Ordered mapping sample name -> VariantRecordSample.  The name index
    is built lazily: two maps are constructed per parsed record (the empty
    placeholder plus the real one) and most accesses are positional."""

    __slots__ = ("_names", "_calls", "_index_cache")

    def __init__(self, names: List[str], calls: List[VariantRecordSample]):
        self._names = names
        self._calls = calls
        self._index_cache = None

    @property
    def _index(self):
        idx = self._index_cache
        if idx is None:
            idx = self._index_cache = {n: i for i, n in enumerate(self._names)}
        return idx

    def __getitem__(self, key):
        if isinstance(key, int):
            return self._calls[key]
        return self._calls[self._index[key]]

    def __contains__(self, key):
        return key in self._index

    def __len__(self):
        return len(self._calls)

    def __iter__(self):
        return iter(self._names)

    def keys(self):
        return list(self._names)

    def values(self):
        return list(self._calls)

    def items(self):
        return list(zip(self._names, self._calls))


class VariantRecord:
    __slots__ = (
        "header",
        "chrom",
        "pos",
        "id",
        "ref",
        "alts",
        "qual",
        "filter",
        "_info_raw",
        "format",
        "samples",
    )

    def __init__(self, header: VariantHeader):
        self.header = header
        self.chrom = ""
        self.pos = 0  # 1-based
        self.id: Optional[str] = None
        self.ref = ""
        self.alts: Optional[Tuple[str, ...]] = None
        self.qual: Optional[float] = None
        self.filter: str = MISSING
        self._info_raw: str = MISSING
        self.format: List[str] = []
        self.samples: _SampleMap = _SampleMap([], [])

    # pysam-compatible accessors ----------------------------------------
    @property
    def start(self) -> int:
        return self.pos - 1

    @property
    def stop(self) -> int:
        return self.pos - 1 + len(self.ref)

    @property
    def contig(self) -> str:
        return self.chrom

    @property
    def info(self) -> Dict[str, str]:
        if self._info_raw in (MISSING, ""):
            return {}
        out = {}
        for item in self._info_raw.split(";"):
            if not item:
                continue
            if "=" in item:
                k, v = item.split("=", 1)
                out[k] = v
            else:
                out[item] = True
        return out

    def set_info_raw(self, raw: str) -> None:
        self._info_raw = raw

    def _ensure_format(self, key: str) -> None:
        if key not in self.format:
            self.format.append(key)

    @classmethod
    def parse_line(cls, line: str, header: VariantHeader) -> "VariantRecord":
        fields = line.rstrip("\n").split("\t")
        if len(fields) < 8:
            raise VcfFormatError(f"VCF record with fewer than 8 fields: {line!r}")
        if header.samples and len(fields) < 10:
            raise VcfFormatError(
                f"VCF record with missing sample columns: {line!r}"
            )
        if len(fields) > 8 and (" " in fields[8] or not fields[8]):
            raise VcfFormatError(f"Malformed FORMAT column: {fields[8]!r}")
        rec = cls(header)
        rec.chrom = fields[0]
        rec.pos = int(fields[1])
        rec.id = None if fields[2] == MISSING else fields[2]
        rec.ref = fields[3]
        alt = fields[4]
        rec.alts = None if alt == MISSING or alt == "" else tuple(alt.split(","))
        rec.qual = None if fields[5] == MISSING else float(fields[5])
        rec.filter = fields[6]
        rec._info_raw = fields[7]
        calls = []
        names = header.samples
        if len(fields) > 8:
            rec.format = fields[8].split(":") if fields[8] != MISSING else []
            for i, name in enumerate(names):
                col = fields[9 + i] if 9 + i < len(fields) else MISSING
                values = {}
                parts = col.split(":")
                for k, v in zip(rec.format, parts):
                    values[k] = v
                calls.append(VariantRecordSample(rec, values))
        rec.samples = _SampleMap(names, calls)
        return rec

    def to_line(self) -> str:
        alt = MISSING if not self.alts else ",".join(self.alts)
        qual = MISSING if self.qual is None else _format_value(self.qual)
        fields = [
            self.chrom,
            str(self.pos),
            self.id if self.id is not None else MISSING,
            self.ref,
            alt,
            qual,
            self.filter if self.filter else MISSING,
            self._info_raw if self._info_raw else MISSING,
        ]
        if self.header.samples:
            calls = self.samples._calls
            # drop FORMAT keys that no sample carries anymore (except GT)
            fmt = [
                k
                for k in self.format
                if k == "GT" or any(k in c._values for c in calls)
            ]
            if not fmt:
                fmt = ["GT"]
            fields.append(":".join(fmt))
            for call in calls:
                call._rewrite_gt_separator()
                values = call._values
                # trailing missing fields may be dropped per spec, but keep
                # them for simplicity/compatibility
                fields.append(":".join(values.get(k, MISSING) for k in fmt))
        return "\t".join(fields)


class VariantFile:
    """Read or write a VCF file (pysam-like)."""

    def __init__(self, path, mode: str = "r", header: Optional[VariantHeader] = None):
        self.filename = str(path).encode() if not hasattr(path, "write") else b"<stream>"
        self._records_iter: Optional[Iterator[VariantRecord]] = None
        self._write_handle = None
        self._bgzf_writer = None
        self._bcf_writer = None
        if mode in ("r", "rb", "rt"):
            self._open_read(path)
        elif mode == "w":
            assert header is not None
            self.header = header
            self._open_write(path)
        else:
            raise ValueError(mode)

    # -- reading ---------------------------------------------------------
    def _open_read(self, path) -> None:
        path = os.fspath(path)
        self._path = path
        with open(path, "rb") as f:
            magic = f.read(4)
        if magic[:2] == b"\x1f\x8b":
            # could be bgzipped VCF or BCF
            with gzip.open(path, "rb") as g:
                inner_magic = g.read(4)
            if inner_magic[:3] == b"BCF":
                self._init_bcf(path)
                return
            self._handle = gzip.open(path, "rt")
        elif magic[:3] == b"BCF":
            raise VcfFormatError("uncompressed BCF is not supported")
        else:
            self._handle = open(path, "rt")
        header_lines = []
        pos_after_header = None
        self._body_start_line = None
        lines_iter = iter(self._handle)
        first_body = None
        for line in lines_iter:
            if line.startswith("#"):
                header_lines.append(line)
            else:
                first_body = line
                break
        self.header = VariantHeader.parse(header_lines)
        self._lines_iter = lines_iter
        self._first_body = first_body
        self._is_bcf = False

    def _init_bcf(self, path) -> None:
        from .bcf import BCFParser

        self._bcf = BCFParser(path)
        self.header = self._bcf.header
        self._is_bcf = True
        self._handle = None

    @property
    def index(self):
        # presence of .tbi/.csi next to the file
        for ext in (".tbi", ".csi"):
            if os.path.exists(self._path + ext):
                return True
        return None

    def _body_contigs(self):
        """Set of contigs that actually occur in the file body (cached)."""
        cached = getattr(self, "_body_contigs_cache", None)
        if cached is None:
            cached = set()
            vf = VariantFile(self._path)
            for rec in vf:
                cached.add(rec.chrom)
            vf.close()
            self._body_contigs_cache = cached
        return cached

    def __iter__(self) -> Iterator[VariantRecord]:
        if self._is_bcf:
            yield from self._bcf
            return
        if self._first_body is not None:
            yield VariantRecord.parse_line(self._first_body, self.header)
            self._first_body = None
        for line in self._lines_iter:
            if line.strip():
                yield VariantRecord.parse_line(line, self.header)

    def fetch(self, contig=None, start=0, stop=None) -> Iterator[VariantRecord]:
        """Region fetch.  Requires an index to exist (like pysam/htslib);
        the actual record filtering is done by scanning."""
        if self.index is None:
            raise ValueError("fetch requires an index")
        if contig is not None and contig not in self.header.contigs:
            # htslib resolves contigs via the index, not only the header:
            # only reject if the contig appears nowhere in the file either
            if contig not in self._body_contigs():
                raise ValueError(f"invalid contig `{contig}`")

        def gen():
            vf = VariantFile(self._path)
            for rec in vf:
                if contig is not None and rec.chrom != contig:
                    continue
                if stop is not None and rec.start >= stop:
                    continue
                if rec.start + max(len(rec.ref), 1) <= start:
                    continue
                yield rec
            vf.close()

        return gen()

    # -- writing ---------------------------------------------------------
    def _open_write(self, path) -> None:
        try:
            path = os.fspath(path)
            is_path = True
        except TypeError:
            is_path = False
        if not is_path:
            self._write_handle = path
            self._owns_handle = False
        else:
            if str(path).endswith(".gz"):
                raw = open(path, "wb")
                self._bgzf_writer = BGZFWriter(raw)
                self._raw_handle = raw
                self._write_handle = None
            elif str(path).endswith(".bcf"):
                from .bcf import BCFWriter

                raw = open(path, "wb")
                self._bcf_writer = BCFWriter(raw, self.header)
                self._raw_handle = raw
                self._write_handle = None
                self._owns_handle = True
                return  # BCFWriter emits the header itself
            else:
                self._write_handle = open(path, "w")
            self._owns_handle = True
        self._write_text(self.header.text())

    def _write_text(self, text: str) -> None:
        if self._bgzf_writer is not None:
            self._bgzf_writer.write(text.encode())
        else:
            self._write_handle.write(text)

    def write(self, record: VariantRecord) -> None:
        if self._bcf_writer is not None:
            self._bcf_writer.write(record)
            return
        self._write_text(record.to_line() + "\n")

    def close(self) -> None:
        if self._bcf_writer is not None:
            self._bcf_writer.close()
            self._raw_handle.close()
            self._bcf_writer = None
        elif self._bgzf_writer is not None:
            self._bgzf_writer.close()
            self._raw_handle.close()
            self._bgzf_writer = None
        elif self._write_handle is not None:
            if getattr(self, "_owns_handle", False):
                self._write_handle.close()
            else:
                self._write_handle.flush()
            self._write_handle = None
        elif getattr(self, "_handle", None) is not None:
            self._handle.close()
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()
