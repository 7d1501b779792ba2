"""The port's dataset readers (paddle_tpu_torch/dataset/) held against the
JAX package's (paddle_tpu/dataset/) on the CPU: with no file under
DATA_HOME both yield the same seeded synthetic samples, and from the same
test-written file in each reader's real format (MNIST idx, the CIFAR
pickles, housing.data, PTB's simple-examples.tgz, the aclImdb tarball,
NLTK's movie_reviews.zip, the WMT tarballs, ml-1m.zip, the flowers triple,
LETOR's Fold1 and the VOC tarball) both parse the same samples. Every
comparison is exact: the same values, dtypes and Python types, bit for
bit (tolerance 0)."""
import gzip
import importlib
import io
import os
import pickle
import struct
import tarfile
import zipfile

import numpy as np
import pytest

import paddle_tpu.dataset as jds
import paddle_tpu_torch.dataset as tds

READERS = ("mnist", "cifar", "uci_housing", "imikolov", "imdb", "sentiment",
           "wmt14", "wmt16", "movielens", "conll05", "flowers", "image",
           "mq2007", "voc2012")


def _mods(name):
    return (importlib.import_module(f"paddle_tpu.dataset.{name}"),
            importlib.import_module(f"paddle_tpu_torch.dataset.{name}"))


@pytest.fixture
def data_home(tmp_path, monkeypatch):
    """Point both packages' DATA_HOME at one fresh directory, and clear the
    readers' parse caches around the test."""
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        common = importlib.import_module(f"{pkg}.dataset.common")
        monkeypatch.setattr(common, "DATA_HOME", str(tmp_path))

    def clear():
        for name in ("imdb", "sentiment", "movielens"):
            for m in _mods(name):
                cache = getattr(m, "_cache", None) or getattr(
                    m, "_word_dict_cache", None)
                if cache is not None:
                    cache.clear()

    clear()
    yield tmp_path
    clear()


def _same(a, b, where="sample"):
    """a (the JAX package's) equals b (the port's) exactly, types too."""
    assert type(a) is type(b), f"{where}: {type(a)} vs {type(b)}"
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.tobytes() == b.tobytes(), where
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, float):
        assert np.float64(a).tobytes() == np.float64(b).tobytes(), where
    else:
        assert a == b, where


def _stream(jr, tr, limit=None):
    """Both readers' samples, compared one by one; returns the count."""
    n = 0
    for n, (a, b) in enumerate(zip(jr(), tr()), 1):
        _same(a, b, f"sample {n - 1}")
        if limit is not None and n >= limit:
            return n
    # the same length: neither has one left over
    if limit is None:
        assert sum(1 for _ in jr()) == sum(1 for _ in tr()) == n
    return n


def test_the_port_has_every_reader():
    assert set(tds.__all__) == set(jds.__all__) == set(READERS)
    for name in READERS:
        j, t = _mods(name)
        assert set(j.__all__) == set(t.__all__), name


# -- the synthetic fallbacks ----------------------------------------------

SYNTHETIC = [
    ("mnist", lambda m: m.train(), None),
    ("mnist", lambda m: m.test(), None),
    ("cifar", lambda m: m.train10(), None),
    ("cifar", lambda m: m.test10(), None),
    ("cifar", lambda m: m.train100(), 512),
    ("cifar", lambda m: m.test100(), None),
    ("uci_housing", lambda m: m.train(), None),
    ("uci_housing", lambda m: m.test(), None),
    ("imikolov", lambda m: m.train(m.build_dict(), 5), None),
    ("imikolov", lambda m: m.test(m.build_dict(), 5), None),
    ("imikolov", lambda m: m.train(m.build_dict(), 40, m.DataType.SEQ), None),
    ("imdb", lambda m: m.train(), None),
    ("imdb", lambda m: m.test({f"w{i}": i for i in range(100)}), None),
    ("sentiment", lambda m: m.train(), None),
    ("sentiment", lambda m: m.test(), None),
    ("wmt14", lambda m: m.train(1000), None),
    ("wmt14", lambda m: m.test(), None),
    ("wmt16", lambda m: m.train(), None),
    ("wmt16", lambda m: m.validation(), None),
    ("movielens", lambda m: m.train(), None),
    ("movielens", lambda m: m.test(), None),
    ("conll05", lambda m: m.test(), None),
    ("flowers", lambda m: m.train(), 24),
    ("flowers", lambda m: m.valid(), 8),
    ("mq2007", lambda m: m.train("pointwise"), None),
    ("mq2007", lambda m: m.vali("pairwise"), None),
    ("mq2007", lambda m: m.test("listwise"), None),
    ("voc2012", lambda m: m.train(), None),
    ("voc2012", lambda m: m.val(), None),
]


@pytest.mark.parametrize("name,make,limit", SYNTHETIC,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(SYNTHETIC)])
def test_synthetic_samples_bit_for_bit(data_home, name, make, limit):
    j, t = _mods(name)
    assert j.is_synthetic() and t.is_synthetic()
    assert _stream(make(j), make(t), limit) > 0


def test_synthetic_tables_and_dicts(data_home):
    for name, fn in (("imikolov", "build_dict"), ("imdb", "word_dict"),
                     ("sentiment", "get_word_dict"),
                     ("movielens", "get_movie_title_dict"),
                     ("movielens", "movie_categories"),
                     ("movielens", "max_user_id"),
                     ("movielens", "max_movie_id"),
                     ("movielens", "max_job_id")):
        j, t = _mods(name)
        _same(getattr(j, fn)(), getattr(t, fn)(), f"{name}.{fn}")
    j, t = _mods("wmt14")
    _same(j.get_dict(500), t.get_dict(500))
    _same(j.get_dict(500, reverse=True), t.get_dict(500, reverse=True))
    j, t = _mods("wmt16")
    _same(j.get_dict("de", 300), t.get_dict("de", 300))
    j, t = _mods("conll05")
    _same(j.get_dict(), t.get_dict())
    _same(j.get_embedding(), t.get_embedding())


def test_image_transforms_bit_for_bit():
    j, t = _mods("image")
    rng = np.random.default_rng(0)
    im = rng.integers(0, 255, (120, 80, 3), dtype=np.uint8)
    for fn, args in (("resize_short", (64,)), ("resize_short", (33,)),
                     ("center_crop", (48,)), ("left_right_flip", ()),
                     ("to_chw", ())):
        _same(getattr(j, fn)(im, *args), getattr(t, fn)(im, *args), fn)
    _same(j.random_crop(im, 48, rng=np.random.default_rng(3)),
          t.random_crop(im, 48, rng=np.random.default_rng(3)))
    _same(j.simple_transform(im, 64, 48, is_train=False, mean=[1., 2., 3.]),
          t.simple_transform(im, 64, 48, is_train=False, mean=[1., 2., 3.]))
    q = "2 qid:10 1:0.5 2:0.25 #docid = GX001"
    jq, tq = _mods("mq2007")[0].Query.parse(q), _mods("mq2007")[1].Query.parse(q)
    _same(vars(jq), vars(tq))
    assert str(jq) == str(tq)


# -- the real-format parsers, from files the test writes -------------------

def _tar_gz(path, members: dict, mode="w:gz"):
    with tarfile.open(path, mode) as tf:
        for name, data in members.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))


def _write_mnist(home, rng):
    os.makedirs(home / "mnist")
    for split, n in (("train", 40), ("t10k", 12)):
        imgs = rng.integers(0, 256, (n, 28 * 28), dtype=np.uint8)
        labels = rng.integers(0, 10, n, dtype=np.uint8)
        with gzip.open(home / "mnist" / f"{split}-images-idx3-ubyte.gz",
                       "wb") as f:
            f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
        with gzip.open(home / "mnist" / f"{split}-labels-idx1-ubyte.gz",
                       "wb") as f:
            f.write(struct.pack(">II", 2049, n) + labels.tobytes())


def _write_cifar(home, rng):
    os.makedirs(home / "cifar")
    for archive, key, classes in (("cifar-10-python.tar.gz", b"labels", 10),
                                  ("cifar-100-python.tar.gz", b"fine_labels",
                                   100)):
        members = {}
        for name, n in (("data_batch_1", 9), ("data_batch_2", 7),
                        ("test_batch", 5)):
            d = {b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                 key: rng.integers(0, classes, n).tolist()}
            members[f"cifar/{name}"] = pickle.dumps(d)
        _tar_gz(home / "cifar" / archive, members)


def _write_housing(home, rng):
    os.makedirs(home / "uci_housing")
    np.savetxt(home / "uci_housing" / "housing.data",
               rng.random((30, 14)) * 50, fmt="%.5f")


PTB_WORDS = [f"tok{i}" for i in range(12)]


def _ptb_text(rng, lines):
    return "\n".join(" ".join(PTB_WORDS[int(i)] for i in rng.integers(
        0, len(PTB_WORDS), int(rng.integers(3, 9)))) for _ in range(lines))


def write_ptb(dirname, rng, lines=(60, 20, 20)):
    """A PTB-layout simple-examples.tgz under `dirname`/imikolov."""
    os.makedirs(os.path.join(dirname, "imikolov"), exist_ok=True)
    _tar_gz(os.path.join(dirname, "imikolov", "simple-examples.tgz"), {
        f"./simple-examples/data/ptb.{split}.txt":
            _ptb_text(rng, n).encode()
        for split, n in zip(("train", "valid", "test"), lines)})


def _write_imdb(home, rng):
    os.makedirs(home / "imdb")
    words = ["good", "bad", "plot", "actor", "great", "awful", "the"]
    members = {}
    for split in ("train", "test"):
        for lab in ("pos", "neg"):
            for i in range(4):
                text = " ".join(words[int(k)] for k in rng.integers(
                    0, len(words), 12)) + " Unknown!"
                members[f"aclImdb/{split}/{lab}/{i}_7.txt"] = text.encode()
    _tar_gz(home / "imdb" / "aclImdb_v1.tar.gz", members)


def _write_sentiment(home, rng):
    os.makedirs(home / "sentiment")
    words = ["fine", "dull", "movie", "scene", "Bright", "poor"]
    with zipfile.ZipFile(home / "sentiment" / "movie_reviews.zip", "w") as zf:
        for lab in ("pos", "neg"):
            for i in range(6):
                zf.writestr(f"movie_reviews/{lab}/cv{i:03d}.txt", " ".join(
                    words[int(k)] for k in rng.integers(0, len(words), 9)))


def _pairs(rng, src, trg, n):
    return "\n".join(
        " ".join(src[int(k)] for k in rng.integers(0, len(src), 5)) + "\t"
        + " ".join(trg[int(k)] for k in rng.integers(0, len(trg), 4))
        for _ in range(n)) + "\nno tab here\n"


def _write_wmt(home, rng):
    os.makedirs(home / "wmt14")
    _tar_gz(home / "wmt14" / "wmt14.tgz", {
        f"wmt14/{split}/{split}.txt": _pairs(
            rng, ["fr3", "fr4", "fr9", "zz"], ["en5", "en7", "yy"], 6).encode()
        for split in ("train", "test")})
    os.makedirs(home / "wmt16")
    _tar_gz(home / "wmt16" / "wmt16.tar.gz", {
        f"wmt16/{split}": _pairs(
            rng, ["the", "house", "cat", "qq"], ["das", "haus", "rr"],
            5).encode() for split in ("train", "val", "test")})
    (home / "wmt16" / "en.dict").write_text("the\nhouse\ncat\n")
    (home / "wmt16" / "de.dict").write_text("das\nhaus\n\nhaus\n")


def _write_movielens(home, rng):
    os.makedirs(home / "movielens")
    users = "\n".join(f"{u}::{'MF'[u % 2]}::{[1, 18, 25, 35][u % 4]}::"
                      f"{u % 21}::0000{u}" for u in range(1, 7))
    movies = "\n".join(f"{m}::Movie {m} Part{m % 3} (199{m})::"
                       f"{['Comedy', 'Drama|Action', 'Animation'][m % 3]}"
                       for m in range(1, 6))
    ratings = "\n".join(f"{int(rng.integers(1, 8))}::{int(rng.integers(1, 7))}"
                        f"::{int(rng.integers(1, 6))}::97830{i}"
                        for i in range(40))
    with zipfile.ZipFile(home / "movielens" / "ml-1m.zip", "w") as zf:
        zf.writestr("ml-1m/users.dat", users)
        zf.writestr("ml-1m/movies.dat", movies)
        zf.writestr("ml-1m/ratings.dat", ratings)


def _png(arr, fmt="PNG"):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt)
    return buf.getvalue()


def _write_flowers(home, rng):
    from scipy.io import savemat

    os.makedirs(home / "flowers")
    n = 6
    _tar_gz(home / "flowers" / "102flowers.tgz", {
        f"jpg/image_{i:05d}.jpg": _png(rng.integers(
            0, 256, (40 + 3 * i, 50, 3), dtype=np.uint8), "JPEG")
        for i in range(1, n + 1)})
    savemat(home / "flowers" / "imagelabels.mat",
            {"labels": rng.integers(1, 103, (1, n))})
    savemat(home / "flowers" / "setid.mat",
            {"trnid": np.array([[1, 4]]), "tstid": np.array([[2, 3, 6]]),
             "valid": np.array([[5]])})


def _write_mq2007(home, rng):
    os.makedirs(home / "MQ2007" / "Fold1")
    for split in ("train", "vali", "test"):
        lines = []
        for qid in (10, 10, 10, 11, 11, 12):
            feats = " ".join(f"{k + 1}:{v:.6f}"
                             for k, v in enumerate(rng.random(46)))
            lines.append(f"{int(rng.integers(0, 3))} qid:{qid} {feats} "
                         f"#docid = GX{qid}")
        (home / "MQ2007" / "Fold1" / f"{split}.txt").write_text(
            "\n".join(lines) + "\n\n")


def _write_voc(home, rng):
    os.makedirs(home / "voc2012")
    root = "VOCdevkit/VOC2012"
    members = {}
    for split, names in (("trainval", ["a", "b", "c"]), ("train", ["a"]),
                         ("val", ["b", "c"])):
        members[f"{root}/ImageSets/Segmentation/{split}.txt"] = (
            "\n".join(names) + "\n").encode()
    for nm in "abc":
        members[f"{root}/JPEGImages/{nm}.jpg"] = _png(rng.integers(
            0, 256, (20, 24, 3), dtype=np.uint8), "JPEG")
        members[f"{root}/SegmentationClass/{nm}.png"] = _png(rng.integers(
            0, 21, (20, 24), dtype=np.uint8))
    _tar_gz(home / "voc2012" / "VOCtrainval_11-May-2012.tar", members,
            mode="w")


REAL = [
    ("mnist", _write_mnist, [lambda m: m.train(), lambda m: m.test()]),
    ("cifar", _write_cifar, [lambda m: m.train10(), lambda m: m.test10(),
                             lambda m: m.train100(), lambda m: m.test100()]),
    ("uci_housing", _write_housing, [lambda m: m.train(), lambda m: m.test()]),
    ("imikolov", lambda h, r: write_ptb(str(h), r), [
        lambda m: m.train(m.build_dict(2), 4),
        lambda m: m.test(m.build_dict(0), 3),
        lambda m: m.train(m.build_dict(2), 6, m.DataType.SEQ)]),
    ("imdb", _write_imdb, [lambda m: m.train(), lambda m: m.test()]),
    ("sentiment", _write_sentiment, [lambda m: m.train(),
                                     lambda m: m.test()]),
    ("wmt14", _write_wmt, [lambda m: m.train(6), lambda m: m.test(8)]),
    ("wmt16", _write_wmt, [lambda m: m.train(), lambda m: m.test(),
                           lambda m: m.validation(4, 3)]),
    ("movielens", _write_movielens, [lambda m: m.train(),
                                     lambda m: m.test()]),
    ("flowers", _write_flowers, [lambda m: m.train(), lambda m: m.test(),
                                 lambda m: m.valid()]),
    ("mq2007", _write_mq2007, [lambda m: m.train("pointwise"),
                               lambda m: m.vali("pairwise"),
                               lambda m: m.test("listwise")]),
    ("voc2012", _write_voc, [lambda m: m.train(), lambda m: m.test(),
                             lambda m: m.val()]),
]


@pytest.mark.parametrize("name,write,makes", REAL, ids=[r[0] for r in REAL])
def test_real_format_parsers_bit_for_bit(data_home, name, write, makes):
    write(data_home, np.random.default_rng(11))
    j, t = _mods(name)
    assert not j.is_synthetic() and not t.is_synthetic()
    for make in makes:
        assert _stream(make(j), make(t)) > 0
    for fn in ("build_dict", "word_dict", "get_word_dict",
               "get_movie_title_dict", "movie_categories", "max_user_id",
               "max_movie_id"):
        if hasattr(j, fn):
            _same(getattr(j, fn)(), getattr(t, fn)(), f"{name}.{fn}")
