"""
Replica of libstdc++'s std::hash<std::string> (Murmur-derived _Hash_bytes,
64-bit, seed 0xc70f6907).

The reference's ReadSet::sort breaks ties between reads with equal first
variant position by std::hash of (name, source_id) (src/readset.h:39-87).
Reproducing that hash exactly is required to reproduce the reference's read
ordering, which in turn determines DP tie-breaking and hence the exact
phased output. Verified against g++/libstdc++ output.
"""

_MASK = (1 << 64) - 1
_MUL = ((0xC6A4A793 << 32) + 0x5BD1E995) & _MASK
_SEED = 0xC70F6907


def _shift_mix(v: int) -> int:
    return (v ^ (v >> 47)) & _MASK


def hash_bytes(data: bytes, seed: int = _SEED) -> int:
    """libstdc++ _Hash_bytes (hash_bytes.cc) for 64-bit size_t."""
    length = len(data)
    h = (seed ^ ((length * _MUL) & _MASK)) & _MASK
    len_aligned = length & ~0x7
    for i in range(0, len_aligned, 8):
        block = int.from_bytes(data[i : i + 8], "little")
        d = (_shift_mix((block * _MUL) & _MASK) * _MUL) & _MASK
        h = ((h ^ d) * _MUL) & _MASK
    tail = length & 0x7
    if tail:
        block = int.from_bytes(data[len_aligned:], "little")
        h = ((h ^ block) * _MUL) & _MASK
    h = (_shift_mix(h) * _MUL) & _MASK
    h = _shift_mix(h)
    return h


def std_hash_string(s: str) -> int:
    return hash_bytes(s.encode("utf-8"))


def std_hash_int(i: int) -> int:
    # std::hash<int> is the identity cast to size_t
    return i & _MASK


def name_and_source_id_hash(name: str, source_id: int) -> int:
    # src/readset.h:95-99: hash(name) ^ hash(source_id)
    return std_hash_string(name) ^ std_hash_int(source_id)
