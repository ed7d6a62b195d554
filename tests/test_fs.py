"""Filesystem seam (gdmix_tpu.io.fs): remote-scheme transparency for every IO
path — the analog of the reference's tf.io.gfile indirection with
write-through-local batched writes (io_utils.py:299-334) and the
namenode-storm-avoiding glob (io_utils.py:378-392). The fake remote is the
in-process mem:// scheme."""
import os

import numpy as np
import pytest

from gdmix_tpu.io import fs


@pytest.fixture()
def memfs():
    """A fresh mem:// store per test (drop the registered singleton)."""
    m = fs.MemFS()
    fs.register_filesystem("mem", m)
    yield m
    fs._registry.pop("mem", None)


def test_mem_roundtrip_text_and_binary(memfs):
    with fs.open("mem://bkt/a/b.txt", "w") as f:
        f.write("hello")
    with fs.open("mem://bkt/a/c.bin", "wb") as f:
        f.write(b"\x00\x01\x02")
    assert fs.open("mem://bkt/a/b.txt").read() == "hello"
    assert fs.open("mem://bkt/a/c.bin", "rb").read() == b"\x00\x01\x02"
    assert fs.exists("mem://bkt/a/b.txt")
    assert fs.isfile("mem://bkt/a/b.txt")
    assert fs.isdir("mem://bkt/a")
    assert not fs.isdir("mem://bkt/a/b.txt")
    assert fs.listdir("mem://bkt/a") == ["b.txt", "c.bin"]
    # append mode
    with fs.open("mem://bkt/a/b.txt", "a") as f:
        f.write("!")
    assert fs.open("mem://bkt/a/b.txt").read() == "hello!"
    fs.remove("mem://bkt/a/b.txt")
    assert not fs.exists("mem://bkt/a/b.txt")


def test_low_rpc_glob_one_listdir(memfs):
    """glob = ONE listdir + client-side fnmatch (io_utils.py:378-392): the
    op counter proves no per-candidate RPCs."""
    for i in range(5):
        with fs.open(f"mem://bkt/d/part-{i:05d}.avro", "wb") as f:
            f.write(b"x")
    with fs.open("mem://bkt/d/_SUCCESS", "wb") as f:
        f.write(b"")
    memfs.list_count = 0
    got = fs.glob("mem://bkt/d/part-*.avro")
    assert got == [f"mem://bkt/d/part-{i:05d}.avro" for i in range(5)]
    assert memfs.list_count == 1
    assert fs.glob("mem://bkt/nope/*.avro") == []


def test_local_glob_and_find(tmp_path):
    d = tmp_path / "x"
    d.mkdir()
    (d / "a.avro").write_bytes(b"1")
    (d / "b.avro").write_bytes(b"2")
    (d / "c.txt").write_bytes(b"3")
    sub = d / "partitionId=0"
    sub.mkdir()
    (sub / "d.avro").write_bytes(b"4")
    assert fs.glob(str(d / "*.avro")) == [str(d / "a.avro"), str(d / "b.avro")]
    assert fs.find_files(str(d), ".avro") == [
        str(d / "a.avro"), str(d / "b.avro"), str(sub / "d.avro")]


def test_find_files_recursive_remote(memfs):
    for k in ("s/part-0.avro", "s/partitionId=1/part-1.avro", "s/.hidden"):
        with fs.open(f"mem://bkt/{k}", "wb") as f:
            f.write(b"x")
    assert fs.find_files("mem://bkt/s", ".avro") == [
        "mem://bkt/s/part-0.avro", "mem://bkt/s/partitionId=1/part-1.avro"]


def test_atomic_output_remote_write_through_local(memfs):
    """The write half of copy-through-local (io_utils.py:299-334): the yielded
    path is a REAL local file; the bytes land remotely only on success."""
    with fs.atomic_output("mem://bkt/out/model.avro") as local:
        assert os.path.isabs(local) and not local.startswith("mem://")
        with open(local, "wb") as f:
            f.write(b"payload")
        assert not fs.exists("mem://bkt/out/model.avro")  # not yet uploaded
    assert fs.open("mem://bkt/out/model.avro", "rb").read() == b"payload"
    assert not os.path.exists(local)  # temp cleaned up


def test_atomic_output_local_is_atomic(tmp_path):
    target = str(tmp_path / "f.json")
    with pytest.raises(RuntimeError):
        with fs.atomic_output(target) as local:
            with open(local, "w") as f:
                f.write("partial")
            raise RuntimeError("boom")
    assert not os.path.exists(target)       # nothing landed
    with fs.atomic_output(target) as local:
        with open(local, "w") as f:
            f.write("done")
    assert open(target).read() == "done"


def test_local_input_downloads_remote(memfs, tmp_path):
    with fs.open("mem://bkt/in/data.bin", "wb") as f:
        f.write(b"remote-bytes")
    with fs.local_input("mem://bkt/in/data.bin") as local:
        assert not local.startswith("mem://")
        assert open(local, "rb").read() == b"remote-bytes"
    assert not os.path.exists(local)
    # local path: yielded as-is, no copy
    p = tmp_path / "x.bin"
    p.write_bytes(b"local")
    with fs.local_input(str(p)) as local:
        assert local == str(p)


def test_copy_between_filesystems(memfs, tmp_path):
    src = tmp_path / "a.txt"
    src.write_bytes(b"abc")
    fs.copy(str(src), "mem://bkt/c/a.txt")
    assert fs.open("mem://bkt/c/a.txt", "rb").read() == b"abc"
    dst = tmp_path / "back.txt"
    fs.copy("mem://bkt/c/a.txt", str(dst))
    assert dst.read_bytes() == b"abc"


# --------------------------------------------------------- real call sites --

def test_model_avro_roundtrip_on_remote_scheme(memfs, tmp_path):
    """export → load of photon-ml avro models on mem:// — exercises
    fs.makedirs, the OCF writer, and the native parser's copy-through-local
    (fs.local_input) at the real call sites."""
    from gdmix_tpu.io import model_avro
    from gdmix_tpu.io.feature_list import write_feature_list
    ff = str(tmp_path / "features")
    write_feature_list([(f"f{i}", "t") for i in range(4)], ff)
    idx = [np.array([0, 2]), np.array([1, 3])]
    vals = [np.array([0.5, -1.5]), np.array([2.0, 0.25])]
    biases = [0.1, -0.2]
    remote = "mem://bkt/models/part-00000.avro"
    model_avro.export_linear_model_to_avro(["e0", "e1"], idx, vals, biases,
                                           ff, remote,
                                           sparsity_threshold=0.0)
    got = model_avro.load_sparse_models_from_avro(remote, ff)
    assert set(got) == {"e0", "e1"}
    np.testing.assert_allclose(got["e0"].theta, [0.1, 0.5, -1.5])
    np.testing.assert_allclose(got["e1"].theta, [-0.2, 2.0, 0.25])


def test_scores_write_read_on_remote_scheme(memfs):
    from gdmix_tpu.io import scores as scores_io

    class _SP:
        uid_column_name = "uid"
        prediction_score_column_name = "predictionScore"
        prediction_score_per_coordinate_column_name = \
            "predictionScorePerCoordinate"
        label_column_name = "response"
        weight_column_name = "weight"

    uids = np.arange(7, dtype=np.int64)
    sc = np.linspace(-1, 1, 7)
    out = "mem://bkt/scores/part-00000.avro"
    scores_io.write_scores(out, _SP, uids, sc, scores_per_coordinate=sc * 2)
    got = scores_io.read_scores("mem://bkt/scores", _SP)
    np.testing.assert_array_equal(got["uid"], uids)
    np.testing.assert_allclose(got["predictionScore"], sc, atol=1e-7)


def test_shard_input_files_on_remote_scheme(memfs):
    from gdmix_tpu.io.shard import shard_input_files
    for i in range(4):
        with fs.open(f"mem://bkt/train/part-{i}.tfrecord", "wb") as f:
            f.write(b"x")
    files, sample_level = shard_input_files("mem://bkt/train", 2, 1)
    assert files == ["mem://bkt/train/part-1.tfrecord",
                     "mem://bkt/train/part-3.tfrecord"]
    assert not sample_level


def test_tfrecord_dataset_readable_from_remote(memfs, tmp_path):
    """A real grouped dataset written locally, uploaded to mem://, read back
    through the normal input pipeline — end-to-end seam coverage."""
    from gdmix_tpu.io.metadata import DatasetMetadata
    from gdmix_tpu.io.input_pipeline import read_per_record
    from gdmix_tpu.data import movielens
    root = str(tmp_path / "ml")
    data = movielens.generate_synthetic(num_users=20, num_movies=25,
                                        num_ratings=300, seed=3)
    ml = movielens.prepare_gdmix_data(root, data)
    md = DatasetMetadata.from_file(
        os.path.join(ml, "global", "metadata", "tensor_metadata.json"))
    local_dir = os.path.join(ml, "global", "trainingData")
    for f in sorted(os.listdir(local_dir)):
        fs.copy(os.path.join(local_dir, f), f"mem://bkt/global/train/{f}")
    want = read_per_record(local_dir, md, "global")
    got = read_per_record("mem://bkt/global/train", md, "global")
    assert got.num_samples == want.num_samples
    np.testing.assert_array_equal(got.columns["uid"], want.columns["uid"])
    np.testing.assert_allclose(got.values, want.values)


def test_metadata_roundtrip_remote(memfs, tmp_path):
    from gdmix_tpu.io.metadata import DatasetMetadata
    md_json = {"features": [{"name": "global", "dtype": "float",
                             "shape": [5], "isSparse": True}],
               "labels": [{"name": "response", "dtype": "int",
                           "shape": [], "isSparse": False}]}
    import json
    local = tmp_path / "md.json"
    local.write_text(json.dumps(md_json))
    md = DatasetMetadata.from_file(str(local))
    md.save("mem://bkt/md/tensor_metadata.json")
    again = DatasetMetadata.from_file("mem://bkt/md/tensor_metadata.json")
    assert again.num_features("global") == 5


def test_gzip_tfrecord_remote_commits_on_close(memfs):
    """gzip.GzipFile(fileobj=...) does not close the fileobj; remote schemes
    commit bytes only when THEIR file object closes. _OwnedGzipFile must
    close both, so the record is visible immediately — not at GC."""
    from gdmix_tpu.io import tfrecord
    path = "mem://bkt/tf/data.tfrecord.gz"
    tfrecord.write_tfrecords(path, [b"payload-bytes"])
    assert fs.exists(path)  # committed by close, not by finalization
    assert list(tfrecord.read_tfrecords(path)) == [b"payload-bytes"]


def test_gzip_write_body_failure_lands_nothing(memfs):
    """If the writer body raises, the remote store must NOT see a truncated
    gzip object: _OwnedGzipWriter aborts (closes without committing a valid
    file) instead of committing partial bytes on close."""
    from gdmix_tpu.io import tfrecord
    path = "mem://bkt/tf/fail.tfrecord.gz"
    with pytest.raises(RuntimeError):
        with tfrecord._open_write(path, "GZIP") as f:
            f.write(b"half-a-record")
            raise RuntimeError("boom")
    assert not fs.exists(path)


def test_gzip_trailer_flush_failure_lands_nothing(memfs):
    """If the gzip trailer flush itself raises on close, the partial object
    must be discarded, not committed."""
    from gdmix_tpu.io import tfrecord
    path = "mem://bkt/tf/fail2.tfrecord.gz"
    w = tfrecord._open_write(path, "GZIP")
    w.write(b"some-bytes")
    raw = w.fileobj

    class _FailOnWrite:
        def write(self, data):
            raise OSError("store went away")

        def close(self):
            raw.close()

    w.fileobj = _FailOnWrite()
    w.myfileobj = None
    with pytest.raises(OSError):
        w.close()
    assert not fs.exists(path)


def test_memfs_refuses_update_modes(memfs):
    """LocalFS honors r+; MemFS would silently drop the writes (the read
    branch returns a snapshot copy) — it must refuse instead."""
    with fs.open("mem://bkt/f.bin", "wb") as f:
        f.write(b"abc")
    with pytest.raises(ValueError):
        fs.open("mem://bkt/f.bin", "r+b")


def test_read_scores_remote_takes_native_fast_path(memfs, monkeypatch):
    """The native columnar decoder needs a REAL local path; remote score
    reads must go through fs.local_input instead of silently demoting to
    the ~40x slower per-record Python reader."""
    from gdmix_tpu import native
    from gdmix_tpu.io import scores as scores_io
    if not native.available():
        pytest.skip("native codecs unavailable")

    class _SP:
        uid_column_name = "uid"
        label_column_name = "label"
        weight_column_name = "weight"
        prediction_score_column_name = "predictionScore"
        prediction_score_per_coordinate_column_name = \
            "predictionScorePerCoordinate"

    uids = np.arange(64, dtype=np.int64)
    sc = np.linspace(-1, 1, 64).astype(np.float32)
    scores_io.write_scores("mem://bkt/ns/part-0.avro", _SP, uids, sc,
                           scores_per_coordinate=sc * 2)
    calls = []
    real = native.read_avro_columns

    def counting(path):
        calls.append(path)
        return real(path)

    monkeypatch.setattr(native, "read_avro_columns", counting)
    got = scores_io.read_scores("mem://bkt/ns", _SP)
    assert calls and not calls[0].startswith("mem://")  # local_input path
    np.testing.assert_array_equal(got["uid"], uids)
    np.testing.assert_allclose(got["predictionScore"], sc, rtol=1e-6)


@pytest.fixture()
def fakefs(tmp_path):
    """A fresh fakefs:// store per test rooted at a hidden local dir."""
    store = tmp_path / ".store"
    d = fs.DirFS(str(store))
    fs.register_filesystem("fakefs", d)
    yield store
    fs._registry.pop("fakefs", None)


def test_dirfs_roundtrip_and_low_rpc_glob(fakefs):
    with fs.open("fakefs://bkt/a/b.txt", "w") as f:
        f.write("hello")
    with fs.open("fakefs://bkt/a/c.bin", "wb") as f:
        f.write(b"\x00\x01")
    assert fs.open("fakefs://bkt/a/b.txt").read() == "hello"
    assert fs.open("fakefs://bkt/a/c.bin", "rb").read() == b"\x00\x01"
    assert fs.isdir("fakefs://bkt/a")
    assert fs.listdir("fakefs://bkt/a") == ["b.txt", "c.bin"]
    assert fs.glob("fakefs://bkt/a/*.txt") == ["fakefs://bkt/a/b.txt"]
    with fs.open("fakefs://bkt/a/b.txt", "a") as f:
        f.write("!")
    assert fs.open("fakefs://bkt/a/b.txt").read() == "hello!"
    fs.remove("fakefs://bkt/a/b.txt")
    assert not fs.exists("fakefs://bkt/a/b.txt")
    # files land under the backing root
    assert (fakefs / "bkt/a/c.bin").is_file()


def test_dirfs_commit_on_close_and_discard_on_error(fakefs):
    """Object-store semantics: a writer's bytes become visible only at close
    (temp-then-rename), and a failing body lands NOTHING — no partial
    objects for concurrent readers in other processes."""
    w = fs.open("fakefs://bkt/x.bin", "wb")
    w.write(b"pending")
    assert not fs.exists("fakefs://bkt/x.bin")  # not yet committed
    w.close()
    assert fs.open("fakefs://bkt/x.bin", "rb").read() == b"pending"

    with pytest.raises(RuntimeError):
        with fs.open("fakefs://bkt/y.bin", "wb") as f:
            f.write(b"partial")
            raise RuntimeError("boom")
    assert not fs.exists("fakefs://bkt/y.bin")
    # no stray temp files either
    names = [n for _, _, fns in os.walk(str(fakefs)) for n in fns]
    assert not [n for n in names if n.endswith(".part~")], names


def test_dirfs_atomic_output_and_local_input(fakefs):
    with fs.atomic_output("fakefs://bkt/up/model.avro") as local:
        with open(local, "wb") as f:
            f.write(b"model-bytes")
    assert fs.open("fakefs://bkt/up/model.avro", "rb").read() == b"model-bytes"
    with fs.local_input("fakefs://bkt/up/model.avro") as local:
        assert open(local, "rb").read() == b"model-bytes"


def test_fakefs_rebuilds_on_env_root_change(tmp_path):
    """A cached DirFS must not keep writing to a stale root after
    GDMIX_FAKEFS_ROOT changes (the registry entry is invalidated)."""
    import os as _os
    fs._registry.pop("fakefs", None)
    a, b = tmp_path / "rootA", tmp_path / "rootB"
    try:
        _os.environ["GDMIX_FAKEFS_ROOT"] = str(a)
        with fs.open("fakefs://x/f.txt", "w") as f:
            f.write("one")
        assert (a / "x/f.txt").is_file()
        _os.environ["GDMIX_FAKEFS_ROOT"] = str(b)
        with fs.open("fakefs://x/f.txt", "w") as f:
            f.write("two")
        assert (b / "x/f.txt").is_file()
        assert (a / "x/f.txt").read_text() == "one"  # untouched
    finally:
        _os.environ.pop("GDMIX_FAKEFS_ROOT", None)
        fs._registry.pop("fakefs", None)
