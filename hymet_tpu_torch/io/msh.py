"""Mash ``.msh`` sketch files: a dependency-free Cap'n Proto codec (the
port's own copy of hymet_tpu.io.msh, numpy only; the same bytes read and
written).

The reference pipeline screens queries against three prebuilt Mash sketch
databases ``data/sketch1-3.msh`` (``main.pl:44-46``, ``scripts/mash.sh:14``;
distributed externally per ``README.md:164-193``). Those files are Cap'n
Proto messages in the standard *stream framing* (segment table + segments,
as written by capnp ``writeMessageToFd``) whose root is Mash's ``MinHash``
struct (schema: Mash upstream ``src/mash/capnp/MinHash.capnp``, v2.x):

    struct MinHash {
      kmerSize @0 :UInt32;            # data word 0, bits [0,32)
      windowSize @1 :UInt32;          # data word 0, bits [32,64)
      minHashesPerWindow @2 :UInt32;  # data word 1, bits [0,32)
      concatenated @3 :Bool;          # data word 1, bit 32
      error @4 :Float32;              # data word 2, bits [0,32)
      noncanonical @5 :Bool;          # data word 1, bit 33
      alphabet @6 :Text;              # pointer 0
      preserveCase @7 :Bool;          # data word 1, bit 34
      hashSeed @8 :UInt32;            # data word 2, bits [32,64)
      referenceListOld @9 :ReferenceList;  # pointer 1
      referenceList @10 :ReferenceList;    # pointer 2
      locusList @11 :LocusList;            # pointer 3
    }
    struct Reference {
      sequence @0 :Text;      # ptr 0
      quality @1 :Text;       # ptr 1
      length @2 :UInt32;      # data word 0, bits [0,32)
      name @3 :Text;          # ptr 2
      comment @4 :Text;       # ptr 3
      hashes64 @5 :List(UInt64);   # ptr 4
      hashes32 @6 :List(UInt32);   # ptr 5
      length64 @7 :UInt64;    # data word 1
      counts32 @8 :List(UInt32);   # ptr 6
      counts32Sorted @9 :Bool;     # data word 0, bit 32
    }
    struct ReferenceList { references @0 :List(Reference); }

(The word/bit placements follow Cap'n Proto's standard layout algorithm —
fields packed by ordinal into the smallest aligned hole — and are asserted
by the byte-level golden fixture in ``tests/test_msh.py``; the port's
copy is held to it by ``tests/test_torch_msh.py``.)

The reader handles multi-segment messages and far pointers (large real
DBs from ``MallocMessageBuilder`` span many segments); the writer emits a
single-segment message, which any conforming reader (including Mash's)
accepts. Only the fields Mash ``screen``/``info`` actually use are
surfaced: k, sketch size, per-reference name/comment/length/hashes.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

# list-pointer element size codes
_SZ_VOID, _SZ_BIT, _SZ_BYTE, _SZ_2B, _SZ_4B, _SZ_8B, _SZ_PTR, _SZ_COMPOSITE = range(8)

_WORD = 8


class MshFormatError(ValueError):
    pass


# ----------------------------------------------------------------------
# reading


class _Message:
    def __init__(self, segments: List[bytes]):
        self.segments = segments

    def word(self, seg: int, off: int) -> int:
        s = self.segments[seg]
        byte = off * _WORD
        if off < 0 or byte + _WORD > len(s):
            raise MshFormatError(f"pointer outside segment {seg} at word {off}")
        return struct.unpack_from("<Q", s, byte)[0]


def _parse_stream(data: bytes) -> _Message:
    """Standard Cap'n Proto stream framing: u32 segment-count-1, u32 sizes
    (words), pad to 8 bytes, then the segments back to back."""
    if len(data) < 8:
        raise MshFormatError("truncated capnp stream")
    n_seg = struct.unpack_from("<I", data, 0)[0] + 1
    if n_seg > 1 << 20:
        raise MshFormatError("implausible segment count (not a .msh file?)")
    sizes = struct.unpack_from(f"<{n_seg}I", data, 4)
    off = 4 + 4 * n_seg
    off = (off + 7) & ~7
    segs = []
    for words in sizes:
        end = off + words * _WORD
        if end > len(data):
            raise MshFormatError("truncated capnp segment")
        segs.append(data[off:end])
        off = end
    return _Message(segs)


@dataclass
class _StructRef:
    seg: int
    off: int  # first data word
    data_words: int
    ptr_words: int

    def data_u64(self, msg: _Message, i: int) -> int:
        if i >= self.data_words:
            return 0  # absent fields read as default
        return msg.word(self.seg, self.off + i)

    def data_u32(self, msg: _Message, i: int) -> int:
        w = self.data_u64(msg, i // 2)
        return (w >> (32 * (i % 2))) & 0xFFFFFFFF

    def ptr(self, msg: _Message, i: int):
        if i >= self.ptr_words:
            return None
        return _resolve_ptr(msg, self.seg, self.off + self.data_words + i)


@dataclass
class _ListRef:
    seg: int
    off: int  # first content word (past composite tag, if any)
    elem_size: int
    count: int
    # composite lists only:
    data_words: int = 0
    ptr_words: int = 0


def _resolve_ptr(msg: _Message, seg: int, off: int):
    """Decode the pointer word at (seg, off); follows far pointers."""
    word = msg.word(seg, off)
    if word == 0:
        return None
    tag = word & 3
    if tag == 2:  # far pointer
        two_word_pad = (word >> 2) & 1
        pad_off = (word >> 3) & ((1 << 29) - 1)
        pad_seg = word >> 32
        if not two_word_pad:
            return _resolve_ptr(msg, pad_seg, pad_off)
        # double-far: landing pad = far ptr to content + a tag word whose
        # offset part is ignored (content starts exactly at the far target)
        far2 = msg.word(pad_seg, pad_off)
        if far2 & 3 != 2:
            raise MshFormatError("double-far landing pad without far pointer")
        content_seg = far2 >> 32
        content_off = (far2 >> 3) & ((1 << 29) - 1)
        tagw = msg.word(pad_seg, pad_off + 1)
        return _decode_content_ptr(msg, tagw, content_seg, content_off)
    # intra-segment pointer: offset is relative to the word after `off`
    signed_off = (word >> 2) & ((1 << 30) - 1)
    if signed_off >= 1 << 29:
        signed_off -= 1 << 30
    content_off = off + 1 + signed_off
    return _decode_content_ptr(msg, word, seg, content_off)


def _decode_content_ptr(msg: _Message, word: int, seg: int, content_off: int):
    tag = word & 3
    if tag == 0:  # struct
        return _StructRef(
            seg=seg,
            off=content_off,
            data_words=(word >> 32) & 0xFFFF,
            ptr_words=(word >> 48) & 0xFFFF,
        )
    if tag == 1:  # list
        elem_size = (word >> 32) & 7
        count = word >> 35
        if elem_size == _SZ_COMPOSITE:
            tagw = msg.word(seg, content_off)
            n = (tagw >> 2) & ((1 << 30) - 1)
            return _ListRef(
                seg=seg,
                off=content_off + 1,
                elem_size=elem_size,
                count=n,
                data_words=(tagw >> 32) & 0xFFFF,
                ptr_words=(tagw >> 48) & 0xFFFF,
            )
        return _ListRef(seg=seg, off=content_off, elem_size=elem_size, count=count)
    raise MshFormatError(f"unexpected pointer tag {tag}")


def _read_text(msg: _Message, ref: Optional[_ListRef]) -> str:
    if ref is None:
        return ""
    if ref.elem_size != _SZ_BYTE:
        raise MshFormatError("Text field is not a byte list")
    raw = msg.segments[ref.seg][ref.off * _WORD : ref.off * _WORD + ref.count]
    return raw.rstrip(b"\x00").decode("utf-8", "replace")


def _read_u64_list(msg: _Message, ref: Optional[_ListRef]) -> np.ndarray:
    if ref is None:
        return np.zeros(0, dtype=np.uint64)
    if ref.elem_size != _SZ_8B:
        raise MshFormatError("expected a List(UInt64)")
    b = ref.off * _WORD
    return np.frombuffer(
        msg.segments[ref.seg], dtype="<u8", count=ref.count, offset=b
    ).astype(np.uint64)


def _read_u32_list(msg: _Message, ref: Optional[_ListRef]) -> np.ndarray:
    if ref is None:
        return np.zeros(0, dtype=np.uint32)
    if ref.elem_size != _SZ_4B:
        raise MshFormatError("expected a List(UInt32)")
    b = ref.off * _WORD
    return np.frombuffer(
        msg.segments[ref.seg], dtype="<u4", count=ref.count, offset=b
    ).astype(np.uint32)


@dataclass
class MshSketch:
    """Decoded Mash sketch file (the fields the screen consumes)."""

    kmer_size: int
    window_size: int
    min_hashes_per_window: int
    error: float
    noncanonical: bool
    preserve_case: bool
    hash_seed: int
    alphabet: str
    names: List[str] = field(default_factory=list)
    comments: List[str] = field(default_factory=list)
    lengths: List[int] = field(default_factory=list)
    hashes: List[np.ndarray] = field(default_factory=list)  # uint64 per ref


def read_msh(path: str) -> MshSketch:
    """Parse a Mash ``.msh`` file into an :class:`MshSketch`."""
    with open(path, "rb") as f:
        data = f.read()
    msg = _parse_stream(data)
    root = _resolve_ptr(msg, 0, 0)
    if not isinstance(root, _StructRef):
        raise MshFormatError("root is not a struct")

    kmer = root.data_u32(msg, 0)
    window = root.data_u32(msg, 1)
    min_hashes = root.data_u32(msg, 2)
    w1 = root.data_u64(msg, 1)
    concat = bool((w1 >> 32) & 1)  # noqa: F841 — parsed for completeness
    noncanon = bool((w1 >> 33) & 1)
    preserve = bool((w1 >> 34) & 1)
    error = struct.unpack("<f", struct.pack("<I", root.data_u32(msg, 4)))[0]
    hash_seed = root.data_u32(msg, 5)
    alphabet = _read_text(msg, root.ptr(msg, 0))

    out = MshSketch(
        kmer_size=kmer,
        window_size=window,
        min_hashes_per_window=min_hashes,
        error=error,
        noncanonical=noncanon,
        preserve_case=preserve,
        hash_seed=hash_seed,
        alphabet=alphabet,
    )

    ref_list = root.ptr(msg, 2) or root.ptr(msg, 1)  # referenceList, else Old
    if ref_list is None:
        return out
    if not isinstance(ref_list, _StructRef):
        raise MshFormatError("referenceList is not a struct")
    refs = ref_list.ptr(msg, 0)
    if refs is None:
        return out
    if not isinstance(refs, _ListRef) or refs.elem_size != _SZ_COMPOSITE:
        raise MshFormatError("references is not a composite list")

    stride = refs.data_words + refs.ptr_words
    use64 = kmer > 16  # Mash: 32-bit hashes for k <= 16, 64-bit beyond
    for i in range(refs.count):
        r = _StructRef(
            seg=refs.seg,
            off=refs.off + i * stride,
            data_words=refs.data_words,
            ptr_words=refs.ptr_words,
        )
        w0 = r.data_u64(msg, 0)
        length32 = w0 & 0xFFFFFFFF
        length64 = r.data_u64(msg, 1)
        out.names.append(_read_text(msg, r.ptr(msg, 2)))
        out.comments.append(_read_text(msg, r.ptr(msg, 3)))
        out.lengths.append(int(length64 or length32))
        if use64:
            h = _read_u64_list(msg, r.ptr(msg, 4))
        else:
            h = _read_u32_list(msg, r.ptr(msg, 5)).astype(np.uint64)
        out.hashes.append(np.sort(h))
    return out


# ----------------------------------------------------------------------
# writing (single-segment; golden fixtures, exports, round-trip tests)


class _SegBuilder:
    """Append-only single-segment builder with pointer back-patching."""

    def __init__(self) -> None:
        self.words: List[int] = []

    def alloc(self, n: int) -> int:
        off = len(self.words)
        self.words.extend([0] * n)
        return off

    def set_word(self, off: int, val: int) -> None:
        self.words[off] = val & 0xFFFFFFFFFFFFFFFF

    def struct_ptr(self, at: int, content: int, data_words: int, ptr_words: int) -> None:
        rel = content - (at + 1)
        self.set_word(
            at,
            ((rel & ((1 << 30) - 1)) << 2)
            | (data_words << 32)
            | (ptr_words << 48),
        )

    def list_ptr(self, at: int, content: int, elem_size: int, count: int) -> None:
        rel = content - (at + 1)
        self.set_word(
            at, 1 | ((rel & ((1 << 30) - 1)) << 2) | (elem_size << 32) | (count << 35)
        )

    def write_text(self, at: int, text: str) -> None:
        raw = text.encode("utf-8") + b"\x00"
        n_words = -(-len(raw) // _WORD)
        content = self.alloc(n_words)
        padded = raw + b"\x00" * (n_words * _WORD - len(raw))
        for i in range(n_words):
            self.set_word(content + i, struct.unpack_from("<Q", padded, i * _WORD)[0])
        self.list_ptr(at, content, _SZ_BYTE, len(raw))

    def write_u64_list(self, at: int, vals: np.ndarray) -> None:
        content = self.alloc(len(vals))
        for i, v in enumerate(np.asarray(vals, dtype=np.uint64)):
            self.set_word(content + i, int(v))
        self.list_ptr(at, content, _SZ_8B, len(vals))

    def write_u32_list(self, at: int, vals: np.ndarray) -> None:
        vals = np.asarray(vals, dtype=np.uint32)
        n_words = -(-len(vals) // 2)
        content = self.alloc(n_words)
        for i, v in enumerate(vals):
            w = self.words[content + i // 2]
            self.words[content + i // 2] = w | (int(v) << (32 * (i % 2)))
        self.list_ptr(at, content, _SZ_4B, len(vals))

    def tobytes(self) -> bytes:
        body = b"".join(struct.pack("<Q", w) for w in self.words)
        header = struct.pack("<II", 0, len(self.words))  # 1 segment
        return header + body


_REF_DATA_WORDS = 2
_REF_PTR_WORDS = 7


def write_msh(
    path: str,
    kmer_size: int,
    min_hashes_per_window: int,
    names: List[str],
    hashes: List[np.ndarray],
    comments: Optional[List[str]] = None,
    lengths: Optional[List[int]] = None,
    hash_seed: int = 42,
    alphabet: str = "ACGT",
    error: float = 0.0,
    noncanonical: bool = False,
) -> None:
    """Write a Mash-compatible single-segment ``.msh``."""
    comments = comments or [""] * len(names)
    lengths = lengths or [0] * len(names)
    use64 = kmer_size > 16
    b = _SegBuilder()
    root_ptr = b.alloc(1)
    root = b.alloc(3 + 4)  # 3 data words, 4 pointers
    b.struct_ptr(root_ptr, root, 3, 4)
    b.set_word(root, kmer_size | (0 << 32))  # windowSize = 0
    w1 = min_hashes_per_window | ((1 if noncanonical else 0) << 33)
    b.set_word(root + 1, w1)
    err_bits = struct.unpack("<I", struct.pack("<f", error))[0]
    b.set_word(root + 2, err_bits | (hash_seed << 32))
    b.write_text(root + 3 + 0, alphabet)  # alphabet @6 -> ptr 0

    # referenceList @10 -> ptr 2: struct with one pointer (references @0)
    rl = b.alloc(1)
    b.struct_ptr(root + 3 + 2, rl, 0, 1)
    # composite list of Reference structs
    n = len(names)
    stride = _REF_DATA_WORDS + _REF_PTR_WORDS
    tag_at = b.alloc(1 + n * stride)
    content = tag_at + 1
    b.set_word(
        tag_at,
        ((n & ((1 << 30) - 1)) << 2)
        | (_REF_DATA_WORDS << 32)
        | (_REF_PTR_WORDS << 48),
    )
    b.list_ptr(rl, tag_at, _SZ_COMPOSITE, 1 + n * stride)
    for i in range(n):
        r = content + i * stride
        length = int(lengths[i])
        b.set_word(r, (length & 0xFFFFFFFF) | (1 << 32))  # counts32Sorted=true
        b.set_word(r + 1, length)  # length64
        b.write_text(r + _REF_DATA_WORDS + 2, names[i])  # name @3
        b.write_text(r + _REF_DATA_WORDS + 3, comments[i])  # comment @4
        h = np.sort(np.asarray(hashes[i], dtype=np.uint64))
        if use64:
            b.write_u64_list(r + _REF_DATA_WORDS + 4, h)  # hashes64 @5
        else:
            b.write_u32_list(
                r + _REF_DATA_WORDS + 5, h.astype(np.uint32)
            )  # hashes32 @6

    with open(path, "wb") as f:
        f.write(b.tobytes())


# ----------------------------------------------------------------------
# SketchDB bridge


def sketchdb_from_msh(path: str):
    """Load a Mash ``.msh`` into our screening :class:`SketchDB`
    (PARITY item: real-DB interop — the reference ships its reference
    sketches only as ``.msh``, ``README.md:164-193``)."""
    from hymet_tpu_torch.io.sketchdb import PAD_HASH, SketchDB

    m = read_msh(path)
    R = len(m.names)
    s = max([m.min_hashes_per_window] + [len(h) for h in m.hashes] + [1])
    hashes = np.full((R, s), PAD_HASH, dtype=np.uint64)
    n_hashes = np.zeros(R, dtype=np.int32)
    for i, h in enumerate(m.hashes):
        hashes[i, : len(h)] = h
        n_hashes[i] = len(h)
    return SketchDB(
        k=m.kmer_size,
        sketch_size=m.min_hashes_per_window,
        hashes=hashes,
        n_hashes=n_hashes,
        names=list(m.names),
        lengths=np.asarray(m.lengths, dtype=np.int64),
        comments=list(m.comments),
    )


def msh_from_sketchdb(db, path: str) -> None:
    """Export a :class:`SketchDB` as a Mash-compatible ``.msh``."""
    from hymet_tpu_torch.io.sketchdb import PAD_HASH

    hashes = []
    for i in range(db.n_refs):
        row = db.hashes[i]
        hashes.append(row[row != PAD_HASH])
    write_msh(
        path,
        kmer_size=db.k,
        min_hashes_per_window=db.sketch_size,
        names=list(db.names),
        hashes=hashes,
        comments=list(db.comments) if db.comments else None,
        lengths=[int(x) for x in db.lengths],
    )
