"""The port's zarr and kvlite writers against the JAX package's stores, and
``write_corpus`` in all three formats.

Stores cross both ways (port writer -> JAX reader, JAX writer -> port
reader) with equal arrays; for the same data the two zarr writers produce
byte-equal ``.zarray`` and chunk files. Tolerance: none.
"""

import sqlite3

import numpy as np
import pytest
import torch

from lipsync_tpu.training import data as j_data
from lipsync_tpu.utils import kvlite as j_kvlite
from lipsync_tpu.utils import zarrlite as j_zarrlite
from lipsync_tpu_torch.training import data as t_data
from lipsync_tpu_torch.utils import kvlite, synthetic, zarrlite

torch.set_num_threads(1)

ARRAYS = {
    "u8_chunked": (lambda r: r.integers(0, 256, (10, 6, 6, 3)).astype(
        np.uint8), (4, 6, 6, 3), None),
    "f32_one_chunk": (lambda r: r.normal(size=(80, 37)).astype(np.float32),
                      None, None),
    "f32_uncompressed": (lambda r: r.normal(size=(5, 7)).astype(np.float32),
                         (2, 3), "none"),
    "i64_edges": (lambda r: r.integers(-9, 9, (7, 5)).astype(np.int64),
                  (3, 2), None),
}


def _write(zl, root, arrays):
    grp = zl.open_group(root, mode="w").require_group("sample_0")
    for name, (data, chunks, comp) in arrays.items():
        grp.create_array(name, data, chunks=chunks, compressor=comp)


@pytest.fixture()
def arrays():
    rng = np.random.default_rng(0)
    return {name: (make(rng), chunks, comp)
            for name, (make, chunks, comp) in ARRAYS.items()}


@pytest.mark.parametrize("writer,reader", [(zarrlite, j_zarrlite),
                                           (j_zarrlite, zarrlite)],
                         ids=["port_to_jax", "jax_to_port"])
def test_zarr_stores_cross_packages(tmp_path, arrays, writer, reader):
    _write(writer, tmp_path / "s.zarr", arrays)
    grp = reader.open_group(tmp_path / "s.zarr")["sample_0"]
    assert sorted(grp.keys()) == sorted(arrays)
    for name, (data, _, _) in arrays.items():
        got = grp[name][:]
        assert got.dtype == data.dtype and got.shape == data.shape
        np.testing.assert_array_equal(got, data)


def test_zarr_files_byte_equal_to_jax(tmp_path, arrays):
    _write(zarrlite, tmp_path / "p.zarr", arrays)
    _write(j_zarrlite, tmp_path / "j.zarr", arrays)
    port = sorted(p.relative_to(tmp_path / "p.zarr")
                  for p in (tmp_path / "p.zarr").rglob("*") if p.is_file())
    jax_ = sorted(p.relative_to(tmp_path / "j.zarr")
                  for p in (tmp_path / "j.zarr").rglob("*") if p.is_file())
    assert port == jax_
    for rel in port:
        assert (tmp_path / "p.zarr" / rel).read_bytes() == (
            tmp_path / "j.zarr" / rel).read_bytes(), rel
    # u8 (10, ...) in chunks of 4: three chunk files, the last padded.
    chunks = sorted(p.name for p in (tmp_path / "p.zarr" / "sample_0" /
                                     "u8_chunked").iterdir())
    assert chunks == [".zarray", "0.0.0.0", "1.0.0.0", "2.0.0.0"]


@pytest.mark.parametrize("shape,itemsize", [((10, 4), 4), ((), 4),
                                            ((3000, 100, 100), 4),
                                            ((1, 9000, 9000), 1)])
def test_default_chunks_match_jax(shape, itemsize):
    assert zarrlite._default_chunks(shape, itemsize) == \
        j_zarrlite._default_chunks(shape, itemsize)


def test_zarr_group_modes(tmp_path):
    root = zarrlite.open_group(tmp_path / "g.zarr", mode="w")
    root.require_group("a").create_array("x", np.arange(3))
    root.require_group("b")
    assert sorted(root.keys()) == ["a", "b"] and "a" in root
    again = zarrlite.open_group(tmp_path / "g.zarr", mode="a")
    assert sorted(again.keys()) == ["a", "b"]
    read = zarrlite.open_group(tmp_path / "g.zarr")
    with pytest.raises(zarrlite.ZarrLiteError, match="read-only"):
        read.require_group("c")
    with pytest.raises(zarrlite.ZarrLiteError, match="read-only"):
        read["a"].create_array("y", np.arange(2))
    np.testing.assert_array_equal(read["a"]["x"][:], np.arange(3))
    fresh = zarrlite.open_group(tmp_path / "g.zarr", mode="w")
    assert list(fresh.keys()) == []
    with pytest.raises(zarrlite.ZarrLiteError, match="Unsupported write"):
        fresh.create_array("z", np.arange(2), compressor={"id": "blosc"})
    with pytest.raises(zarrlite.ZarrLiteError, match="Not a zarr group"):
        zarrlite.open_group(tmp_path / "missing")


@pytest.mark.parametrize("writer,reader", [(kvlite, j_kvlite),
                                           (j_kvlite, kvlite)],
                         ids=["port_to_jax", "jax_to_port"])
def test_kvlite_stores_cross_packages(tmp_path, writer, reader):
    path = tmp_path / "s.lmdb"
    with writer.open(path) as env:
        with env.begin(write=True) as txn:
            for i in range(5):
                txn.put(f"k{i}".encode(), bytes([i]) * (i + 1))
    assert kvlite.is_sqlite_file(path) and j_kvlite.is_sqlite_file(path)
    with reader.open(path, readonly=True) as env:
        with env.begin() as txn:
            got = [txn.get(f"k{i}".encode()) for i in range(5)]
            assert txn.get(b"missing", b"default") == b"default"
        assert env.stat() == {"entries": 5}
    assert got == [bytes([i]) * (i + 1) for i in range(5)]


def test_kvlite_put_delete_sync_stat_and_read_only(tmp_path):
    path = tmp_path / "s.lmdb"
    env = kvlite.open(path)
    con = sqlite3.connect(str(path))
    ddl = con.execute("SELECT sql FROM sqlite_master WHERE name='kv'"
                      ).fetchone()[0]
    assert "WITHOUT ROWID" in ddl and "k BLOB PRIMARY KEY" in ddl
    with env.begin(write=True) as txn:
        assert txn.put(b"a", b"1") and txn.put(b"b", b"2")
        assert txn.put(b"a", b"3")  # replace
    with env.begin(write=True) as txn:
        assert txn.delete(b"b") and not txn.delete(b"nope")
    with pytest.raises(RuntimeError):  # rolled back
        with env.begin(write=True) as txn:
            txn.put(b"c", b"4")
            raise RuntimeError("abort")
    env.sync()
    assert con.execute("SELECT k, v FROM kv").fetchall() == [(b"a", b"3")]
    con.close()
    assert env.stat() == {"entries": 1}
    with env.begin() as txn:
        with pytest.raises(kvlite.Error, match="read-only transaction"):
            txn.put(b"x", b"y")
        with pytest.raises(kvlite.Error, match="read-only transaction"):
            txn.delete(b"a")
    env.close()
    ro = kvlite.open(path, readonly=True)
    with pytest.raises(kvlite.Error, match="read-only Env"):
        ro.begin(write=True)
    ro.sync()  # no-op on a read-only store
    ro.close()
    with pytest.raises(kvlite.Error, match="No such kvlite store"):
        kvlite.open(tmp_path / "missing.lmdb", readonly=True)


@pytest.mark.parametrize("offset", [16, 12])
def test_is_lmdb_file_on_a_fabricated_header(tmp_path, offset):
    head = bytearray(64)
    head[offset:offset + 4] = (0xBEEFC0DE).to_bytes(4, "little")
    path = tmp_path / "data.mdb"
    path.write_bytes(bytes(head))
    assert kvlite.is_lmdb_file(path) and j_kvlite.is_lmdb_file(path)
    assert not kvlite.is_sqlite_file(path)
    with kvlite.open(tmp_path / "s.lmdb"):
        pass
    assert not kvlite.is_lmdb_file(tmp_path / "s.lmdb")
    assert not kvlite.is_lmdb_file(tmp_path / "missing")


def test_write_corpus_formats_read_identically(tmp_path):
    """The three formats of one corpus give byte-identical training samples
    through the port's and the JAX package's ``LipSyncDataset``."""
    outs = {fmt: synthetic.write_corpus(tmp_path / fmt, n_clips=3,
                                        n_frames=20, crop_size=16,
                                        device="cpu", storage_format=fmt)
            for fmt in synthetic.STORAGE_FORMATS}
    assert (outs["zarr"] / "samples.zarr").is_dir()
    assert kvlite.is_sqlite_file(outs["lmdb"] / "samples.lmdb")
    for pkg in (t_data, j_data):
        sets = {fmt: pkg.LipSyncDataset(preprocessed_dir=out, video_frames=8,
                                        audio_frames=32, uint8_visual=True)
                for fmt, out in outs.items()}
        assert {f: s.storage_format for f, s in sets.items()} == {
            f: f for f in outs}
        for i in range(3):
            want = sets["npy"].get_item(i, train_mode_override=False)
            assert want is not None
            for fmt in ("zarr", "lmdb"):
                got = sets[fmt].get_item(i, train_mode_override=False)
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype
                    np.testing.assert_array_equal(g, w)


def test_write_corpus_rejects_unknown_format(tmp_path):
    with pytest.raises(ValueError, match="Unknown storage format"):
        synthetic.write_corpus(tmp_path, n_clips=1, device="cpu",
                               storage_format="parquet")
