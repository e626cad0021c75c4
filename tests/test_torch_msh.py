"""hymet_tpu_torch's Mash .msh codec against hymet_tpu's on the CPU: the port
reads what the JAX writer wrote (64- and 32-bit hashes, names, comments,
lengths), writes the same bytes, reads the hand-built golden fixture and
its multi-segment far-pointer form, rejects garbage alike, and SketchDB
survives the .msh round trip both ways."""

import struct

import numpy as np
import pytest

from hymet_tpu.io import msh as jmsh
from hymet_tpu.io.sketchdb import SketchDB as JDB
from hymet_tpu.io.sketchdb import build_sketch_db_from_sequences
from hymet_tpu_torch.io import msh as tmsh
from hymet_tpu_torch.io.sketchdb import SketchDB as TDB
from hymet_tpu_torch.io.sketchdb import load_sketch_db
from test_msh import _hand_built_msh


def _refs(seed: int, k: int, R: int = 5):
    """R references: random names, comments (one empty, one non-ASCII),
    lengths (one above 2^32) and sorted distinct hashes (below 2^32 at
    k <= 16), one reference with none."""
    rng = np.random.default_rng(seed)
    top = 2**32 if k <= 16 else 2**64
    hashes = [np.unique(rng.integers(0, top, int(rng.integers(1, 60)), dtype=np.uint64,
                                     endpoint=False)) for _ in range(R - 1)]
    hashes.append(np.zeros(0, np.uint64))
    names = [f"GCF_{seed:03d}{i}.1_genomic.fna.gz" for i in range(R)]
    comments = ["", "chromosome 1", "plasmid pX", "Escherichia coli é", "c" * 17][:R]
    lengths = [int(x) for x in rng.integers(1, 10_000_000, R)]
    lengths[1] = 2**32 + 7
    return names, hashes, comments, lengths


def _fields(m):
    return (m.kmer_size, m.window_size, m.min_hashes_per_window, m.error, m.noncanonical,
            m.preserve_case, m.hash_seed, m.alphabet, m.names, m.comments, m.lengths)


@pytest.mark.parametrize("k,s", [(21, 1000), (32, 7), (15, 50), (16, 1)])
def test_port_reads_and_writes_jax_msh(tmp_path, k, s):
    """k > 16 stores hashes64, k <= 16 hashes32 (Mash's rule): the port
    reads the JAX file field for field and writes the same bytes."""
    names, hashes, comments, lengths = _refs(k, k)
    jpath, tpath = tmp_path / "j.msh", tmp_path / "t.msh"
    jmsh.write_msh(str(jpath), k, s, names, hashes, comments=comments, lengths=lengths)
    tmsh.write_msh(str(tpath), k, s, names, hashes, comments=comments, lengths=lengths)
    assert tpath.read_bytes() == jpath.read_bytes()
    got, want = tmsh.read_msh(str(jpath)), jmsh.read_msh(str(jpath))
    assert _fields(got) == _fields(want)
    assert len(got.hashes) == len(want.hashes)
    for g, w, h in zip(got.hashes, want.hashes, hashes):
        assert g.dtype == w.dtype == np.uint64
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, np.sort(h))


def test_writer_options_give_the_same_bytes(tmp_path):
    """Seed, alphabet, error and noncanonical, and no comments or lengths."""
    kw = dict(hash_seed=7, alphabet="ACGU", error=0.25, noncanonical=True)
    names, hashes, _c, _l = _refs(3, 21, R=2)
    jmsh.write_msh(str(tmp_path / "j.msh"), 21, 9, names, hashes, **kw)
    tmsh.write_msh(str(tmp_path / "t.msh"), 21, 9, names, hashes, **kw)
    assert (tmp_path / "t.msh").read_bytes() == (tmp_path / "j.msh").read_bytes()
    assert _fields(tmsh.read_msh(str(tmp_path / "j.msh"))) == _fields(
        jmsh.read_msh(str(tmp_path / "j.msh")))


@pytest.mark.parametrize("layout", ["golden", "far_pointer"])
def test_port_reads_the_hand_built_fixture(tmp_path, layout):
    """The hand-built single-segment file of tests/test_msh.py, and the
    same content behind a far pointer in a second segment."""
    data = _hand_built_msh()
    if layout == "far_pointer":
        n_words = struct.unpack_from("<I", data, 4)[0]
        far = 2 | (1 << 32)  # one-word landing pad at segment 1, word 0
        data = struct.pack("<III", 1, 1, n_words) + b"\x00" * 4 + struct.pack("<Q", far) + data[8:]
    p = tmp_path / "x.msh"
    p.write_bytes(data)
    got, want = tmsh.read_msh(str(p)), jmsh.read_msh(str(p))
    assert _fields(got) == _fields(want)
    assert got.names == ["refA"] and got.hashes[0].tolist() == want.hashes[0].tolist() == [5, 7, 11]


@pytest.mark.parametrize("data", [b"\xff" * 64, b"\x00" * 4, struct.pack("<II", 0, 99)])
def test_port_rejects_what_jax_rejects(tmp_path, data):
    p = tmp_path / "bad.msh"
    p.write_bytes(data)
    with pytest.raises(jmsh.MshFormatError):
        jmsh.read_msh(str(p))
    with pytest.raises(tmsh.MshFormatError):
        tmsh.read_msh(str(p))


def _jax_db(seed: int, s: int) -> JDB:
    rng = np.random.default_rng(seed)
    seqs = [(f"ref{i}", np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].tobytes())
            for i, n in enumerate([3000, 40, 5, 2000])]
    db = build_sketch_db_from_sequences(seqs, k=21, sketch_size=s)
    db.comments = ["", "short", "none", "x"]
    return db


def _same_db(a, b) -> None:
    assert (a.k, a.sketch_size, a.names, a.comments) == (b.k, b.sketch_size, b.names, b.comments)
    for f in ("hashes", "n_hashes", "lengths"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("s", [1000, 3])
def test_sketchdb_msh_round_trip_both_ways(tmp_path, s):
    """JAX to_msh -> port from_msh (and load_sketch_db), port to_msh ->
    JAX from_msh: the same DB both ways, and the two writers' bytes."""
    jdb = _jax_db(s, s)
    jdb.to_msh(str(tmp_path / "j.msh"))
    tdb = TDB.from_msh(str(tmp_path / "j.msh"))
    _same_db(tdb, JDB.from_msh(str(tmp_path / "j.msh")))
    _same_db(load_sketch_db(str(tmp_path / "j.msh")), tdb)
    tdb.to_msh(str(tmp_path / "t.msh"))
    assert (tmp_path / "t.msh").read_bytes() == (tmp_path / "j.msh").read_bytes()
    _same_db(JDB.from_msh(str(tmp_path / "t.msh")), tdb)
    # the .npz DB written by the port reads back as the JAX .msh import
    tdb.save(str(tmp_path / "t.npz"))
    _same_db(load_sketch_db(str(tmp_path / "t.npz")), JDB.from_msh(str(tmp_path / "j.msh")))


def test_sketch_size_from_rows(tmp_path):
    """sketchdb_from_msh takes the row width as the largest of
    min_hashes_per_window and the rows' lengths (a file whose rows hold
    more hashes than its sketch size)."""
    names, hashes, comments, lengths = _refs(9, 21, R=3)
    jmsh.write_msh(str(tmp_path / "x.msh"), 21, 2, names, hashes, comments, lengths)
    t, j = tmsh.sketchdb_from_msh(str(tmp_path / "x.msh")), jmsh.sketchdb_from_msh(
        str(tmp_path / "x.msh"))
    _same_db(t, j)
    assert t.sketch_size == 2 and t.hashes.shape[1] == max(len(h) for h in hashes)
