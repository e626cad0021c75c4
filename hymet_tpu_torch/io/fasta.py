"""FASTA parsing and 2-bit nucleotide packing (copy of hymet_tpu.io.fasta's
host helpers).

Contigs travel as dense uint8 code arrays: A=0, C=1, G=2, T=3, anything
else = 4 (invalid — k-mers covering it are skipped, as Mash and minimap2
skip non-ACGT k-mers).
"""

from __future__ import annotations

import gzip
from typing import Iterator, List, Tuple

import numpy as np

# char -> 2-bit code lookup (256 entries); invalid bases map to 4
_CODE_LUT = np.full(256, 4, dtype=np.uint8)
for i, base in enumerate("ACGT"):
    _CODE_LUT[ord(base)] = i
    _CODE_LUT[ord(base.lower())] = i


def _open_maybe_gzip(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def iter_fasta(path: str) -> Iterator[Tuple[str, bytes]]:
    """Yield (header_id, sequence_bytes). header_id is the first
    whitespace-delimited token after '>'."""
    name = None
    chunks: List[bytes] = []
    with _open_maybe_gzip(path) as f:
        for raw in f:
            line = raw.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    yield name, b"".join(chunks)
                toks = line[1:].split(None, 1)
                name = toks[0].decode("utf-8", "replace") if toks else ""
                chunks = []
            elif line:
                chunks.append(line)
        if name is not None:
            yield name, b"".join(chunks)


def read_fasta(path: str) -> Tuple[List[str], List[bytes]]:
    names: List[str] = []
    seqs: List[bytes] = []
    for name, seq in iter_fasta(path):
        names.append(name)
        seqs.append(seq)
    return names, seqs


def encode_seq(seq: bytes) -> np.ndarray:
    """ASCII sequence -> uint8 codes (A=0 C=1 G=2 T=3, other=4)."""
    return _CODE_LUT[np.frombuffer(seq, dtype=np.uint8)]


def read_fasta_codes(path: str) -> Tuple[List[str], List[np.ndarray]]:
    """Read FASTA directly into uint8 code arrays (the native helpers'
    encoder when the library is there, :func:`encode_seq` else)."""
    from hymet_tpu_torch.io import native_io

    if native_io.available():
        return native_io.read_fasta_codes(path)
    names, seqs = read_fasta(path)
    return names, [encode_seq(s) for s in seqs]


def pack_code_batch(codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    """Pack a [B, L] uint8 code batch (0-3 bases, 4 = invalid) into 2-bit
    codes + a validity bitmask: 0.375 bytes/base on the host-to-device
    link instead of 1.

    Returns (packed [B, ceil(L/8)*2] uint8 little-endian 2-bit fields,
    mask [B, ceil(L/8)] uint8 little-endian bits, L). Unpack on the
    device with :func:`hymet_tpu_torch.ops.hashing.unpack_code_batch`.
    """
    B, L = codes.shape
    Lp = -(-L // 8) * 8
    c = np.full((B, Lp), 4, dtype=np.uint8)
    c[:, :L] = codes
    valid = c < 4
    two = np.where(valid, c, 0).astype(np.uint16)
    shifts = np.arange(4, dtype=np.uint16) * 2
    packed = (two.reshape(B, -1, 4) << shifts).sum(axis=-1).astype(np.uint8)
    mask = np.packbits(valid, axis=1, bitorder="little")
    return packed, mask, L
