"""The port's R reader and datasets against the JAX package's, and the
native host helpers.

* The test writes small R serialisation streams itself (XDR, ``RDX2`` and
  ``RDX3`` headers, uncompressed, gzip, bzip2 and xz): a data.frame with a
  factor holding an NA, an integer column with an NA, a numeric column
  with NA and a compact-intseq ALTREP ``row.names``, a character vector
  with NA, a logical vector with NA, a raw vector, a named and an unnamed
  list, a matrix with dimnames and an S4 dgCMatrix; repeated symbols are
  written as references. ``harmony_tpu.rdata.load_rdata`` and
  ``harmony_tpu_torch.rdata.load_rdata`` must decode each stream to equal
  values, and those values are checked against what was written.
* ``datasets.cell_lines``, ``cell_lines_small`` and ``pbmc_stim`` on a
  directory that holds only such ``.rda``/``.RData`` files return what the
  JAX package's functions return there (the reference's files, not the
  synthetic fallback); ``pbmc_stim`` on an empty directory names both
  sources and the directory; a ``.npz`` beside an ``.rda`` is read first.
  Where the reference's ``data/`` is mounted, its files are read by both.
* ``native.csc_row_stats`` and ``csc_log_normalize`` against the JAX
  package's and NumPy (skipped without a C++ toolchain, as
  tests/test_native.py is).
"""

import bz2
import gzip
import lzma
import os
import shutil
import struct

import numpy as np
import pytest

from harmony_tpu import datasets as jdatasets
from harmony_tpu import native as jnative
from harmony_tpu import rdata as jrdata
from harmony_tpu_torch import datasets as tdatasets
from harmony_tpu_torch import native as tnative
from harmony_tpu_torch import rdata as trdata

NA_INT = -2**31
# R's NA_real_: a NaN with the payload 1954
NA_REAL = struct.unpack(">d", bytes.fromhex("7ff00000000007a2"))[0]


# ---- a writer of R's XDR serialisation format -----------------------------


class _RWriter:
    """Writes nodes (tuples, see :func:`_node`) as R's ``serialize`` does:
    each item a flags word (type, object, attribute and tag bits, gp
    levels), then its payload; the first use of a symbol a SYMSXP, the
    later ones a reference to it."""

    def __init__(self):
        self.out = bytearray()
        self.syms = {}

    def i32(self, v):
        self.out += struct.pack(">i", v)

    def flags(self, typ, obj=False, attr=False, tag=False, levels=0):
        self.out += struct.pack(">I", typ | obj << 8 | attr << 9 | tag << 10 | levels << 12)

    def charsxp(self, s):
        if s is None:
            self.flags(9)
            self.i32(-1)
            return
        b = s.encode("utf-8")
        self.flags(9, levels=64 if s.isascii() else 8)  # ASCII / UTF8 mask
        self.i32(len(b))
        self.out += b

    def sym(self, name):
        if name in self.syms:
            self.out += struct.pack(">I", self.syms[name] << 8 | 255)  # REFSXP
            return
        self.flags(1)
        self.charsxp(name)
        self.syms[name] = len(self.syms) + 1

    def pairlist(self, items, tagged=True):
        for name, node in items:
            self.flags(2, tag=tagged)
            if tagged:
                self.sym(name)
            self.write(node)
        self.flags(254)  # the last CDR: NILVALUE_SXP

    def write(self, node):
        kind, value, attrs = node
        has_cls = any(n == "class" for n, _ in attrs)
        head = dict(obj=has_cls, attr=bool(attrs))
        if kind == "null":
            self.flags(254)
            return
        if kind == "altrep_intseq":
            n, start, step = value
            self.flags(238)
            self.pairlist([(None, ("sym", "compact_intseq", [])), (None, ("sym", "base", [])),
                           (None, ("int", [13], []))], tagged=False)
            self.write(("real", [n, start, step], []))
            self.flags(254)
            return
        if kind == "sym":
            self.sym(value)
            return
        if kind == "s4":
            self.flags(25, obj=True, attr=True, levels=16)  # S4_OBJECT_MASK
        elif kind == "int":
            self.flags(13, **head)
            self.i32(len(value))
            self.out += np.asarray(value, dtype=">i4").tobytes()
        elif kind == "lgl":
            self.flags(10, **head)
            self.i32(len(value))
            self.out += np.asarray([NA_INT if v is None else int(v) for v in value],
                                   dtype=">i4").tobytes()
        elif kind == "real":
            self.flags(14, **head)
            self.i32(len(value))
            self.out += np.asarray(value, dtype=">f8").tobytes()
        elif kind == "str":
            self.flags(16, **head)
            self.i32(len(value))
            for s in value:
                self.charsxp(s)
        elif kind == "raw":
            self.flags(24, **head)
            self.i32(len(value))
            self.out += bytes(value)
        elif kind == "vec":
            self.flags(19, **head)
            self.i32(len(value))
            for v in value:
                self.write(v)
        else:
            raise ValueError(kind)
        if attrs:
            self.pairlist(attrs)


def _node(kind, value=None, **attrs):
    return (kind, value, list(attrs.items()))


def _str(*values, **attrs):
    return _node("str", list(values), **attrs)


def _factor(codes, levels):
    """An R factor: 1-based codes, NA as NA_integer_."""
    return _node("int", [NA_INT if c is None else c + 1 for c in codes],
                 levels=_str(*levels), **{"class": _str("factor")})


def _data_frame(columns, n):
    return _node("vec", list(columns.values()), names=_str(*columns),
                 **{"class": _str("data.frame"), "row.names": ("altrep_intseq", (n, 1, 1), [])})


def _dgc(dense, dimnames=None):
    """A Matrix-package dgCMatrix of the dense (rows, cols) array."""
    rows, cols = dense.shape
    i, p, x = [], [0], []
    for c in range(cols):
        nz = np.nonzero(dense[:, c])[0]
        i += nz.tolist()
        x += dense[nz, c].tolist()
        p.append(len(i))
    dn = [("null", None, []) if d is None else _str(*d) for d in (dimnames or [None, None])]
    return _node("s4", None, i=_node("int", i), p=_node("int", p),
                 Dim=_node("int", [rows, cols]), Dimnames=_node("vec", dn), x=_node("real", x),
                 factors=_node("vec", []),
                 **{"class": _str("dgCMatrix", package=_str("Matrix"))})


def _rdata_bytes(objects, version=2, compress="gzip"):
    w = _RWriter()
    w.out += f"RDX{version}\n".encode() + b"X\n"
    w.i32(version)
    w.i32(0x040201)  # writer R 4.2.1
    w.i32(0x020300 if version == 2 else 0x030500)  # oldest reader
    if version == 3:
        w.i32(5)
        w.out += b"UTF-8"
    w.pairlist(list(objects.items()))
    raw = bytes(w.out)
    return {None: lambda b: b, "gzip": gzip.compress, "bzip2": bz2.compress,
            "xz": lzma.compress}[compress](raw)


def _write(path, objects, **kw):
    with open(path, "wb") as fh:
        fh.write(_rdata_bytes(objects, **kw))
    return str(path)


# ---- the streams ------------------------------------------------------------

N_DF = 7
DENSE = np.array([[0.0, 2.5, 0.0, 1.0], [3.0, 0.0, 0.0, 0.0], [0.0, 4.0, 0.0, 7.5]])


def _objects():
    """Every SEXP type the reader takes, in a workspace of four objects."""
    df = _data_frame({
        "cell_type": _factor([0, 2, 1, None, 0, 1, 2], ["t0", "t1", "t2"]),
        "n_genes": _node("int", [5, 9, NA_INT, 1, 0, 3, 2]),
        "score": _node("real", [0.5, NA_REAL, -1.25, 2.0, 0.0, 1e300, -3.5]),
    }, N_DF)
    misc = _node("vec", [
        _str("a", None, "ünï", "d"),
        _node("lgl", [True, None, False]),
        _node("raw", [0, 7, 255]),
        _node("vec", [_node("int", [1, 2]), ("null", None, [])]),
        _node("real", [1.0, 2.0, 3.0, 4.0, 5.0, 6.0], dim=_node("int", [2, 3]),
              dimnames=_node("vec", [_str("r1", "r2"), _str("c1", "c2", "c3")])),
    ], names=_str("chars", "flags", "bytes", "nested", "mat"))
    return {"frame": df, "misc": misc, "sparse": _dgc(DENSE, [["g1", "g2", "g3"], None]),
            "vec": _node("int", [4, 5, 6])}


def _same(a, b, where="top"):
    """Equal decoded values across the two readers' classes."""
    assert type(a).__name__.replace("RSparseMatrix", "SparseMatrix") == \
        type(b).__name__.replace("RSparseMatrix", "SparseMatrix"), where
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        if a.dtype == object:
            assert a.tolist() == b.tolist(), where
        else:
            np.testing.assert_array_equal(a, b, err_msg=where)
    elif type(a).__name__ in ("RFactor", "SparseMatrix", "RSparseMatrix", "RMatrix"):
        for f in vars(a):
            _same(getattr(a, f), getattr(b, f), f"{where}.{f}")
    else:
        assert a == b, where


@pytest.mark.parametrize("version,compress", [(2, "gzip"), (3, "gzip"), (2, "bzip2"),
                                              (3, "xz"), (2, None), (3, None)])
def test_streams_decode_as_the_jax_reader(tmp_path, version, compress):
    path = _write(tmp_path / "w.rda", _objects(), version=version, compress=compress)
    ours, theirs = trdata.load_rdata(path), jrdata.load_rdata(path)
    _same(ours, theirs)
    assert list(ours) == ["frame", "misc", "sparse", "vec"]


def test_decoded_values(tmp_path):
    """What the port's reader returns is what was written."""
    got = trdata.load_rdata(_write(tmp_path / "w.RData", _objects(), version=3))
    df = got["frame"]
    assert list(df) == ["cell_type", "n_genes", "score"]
    assert isinstance(df["cell_type"], trdata.RFactor)
    assert df["cell_type"].as_strings().tolist() == ["t0", "t2", "t1", None, "t0", "t1", "t2"]
    assert df["n_genes"].dtype == np.int32 and df["n_genes"][2] == NA_INT
    assert np.isnan(df["score"][1]) and df["score"][5] == 1e300
    misc = got["misc"]
    assert misc["chars"].tolist() == ["a", None, "ünï", "d"]
    assert misc["flags"].tolist() == [True, None, False]
    assert misc["bytes"].tolist() == [0, 7, 255]
    assert misc["nested"][0].tolist() == [1, 2] and misc["nested"][1] is None
    np.testing.assert_array_equal(misc["mat"].values, [[1.0, 3.0, 5.0], [2.0, 4.0, 6.0]])
    assert misc["mat"].dimnames[1].tolist() == ["c1", "c2", "c3"]
    sp = got["sparse"]
    assert isinstance(sp, tdatasets.SparseMatrix) and sp.shape == DENSE.shape
    np.testing.assert_array_equal(sp.toarray(), DENSE)
    assert sp.dimnames[0].tolist() == ["g1", "g2", "g3"] and sp.dimnames[1] is None
    np.testing.assert_array_equal(got["vec"], [4, 5, 6])


def test_compact_intseq_row_names(tmp_path):
    """The ALTREP compact_intseq decodes to the sequence it stands for."""
    w = _RWriter()
    w.write(("altrep_intseq", (5, 3, 2), []))
    r = trdata._Reader(bytes(w.out))
    obj = r.read_item()
    assert obj.type == trdata.INTSXP and obj.value.tolist() == [3, 5, 7, 9, 11]


def test_bad_header_raises(tmp_path):
    p = tmp_path / "bad.rda"
    p.write_bytes(gzip.compress(b"RDA2\nX\n"))
    with pytest.raises(trdata.RDataError, match="not an RData file"):
        trdata.load_rdata(str(p))


# ---- datasets from .rda/.RData alone ---------------------------------------


def _cell_lines_object(n, seed):
    rng = np.random.default_rng(seed)
    pcs = rng.normal(size=(n, 4)) / 50.0
    return _node("vec", [
        _data_frame({f"X{j + 1}": _node("real", pcs[:, j].tolist()) for j in range(4)}, n),
        _data_frame({"dataset": _factor(rng.integers(0, 2, n).tolist(), ["jurkat", "t293"]),
                     "cell_type": _factor(rng.integers(0, 3, n).tolist(),
                                          ["jurkat", "t293", "half"])}, n),
    ], names=_str("scaled_pcs", "meta_data"))


def _same_dataset(ours, theirs, name):
    assert ours.name == theirs.name == name
    np.testing.assert_array_equal(ours.scaled_pcs, theirs.scaled_pcs)
    assert list(ours.meta_data) == list(theirs.meta_data)
    for k in ours.meta_data:
        assert ours.meta_data[k].tolist() == theirs.meta_data[k].tolist(), k


def test_cell_lines_from_rda_match_jax(tmp_path):
    _write(tmp_path / "cell_lines.rda", {"cell_lines": _cell_lines_object(40, 1)}, version=3,
           compress="xz")
    _write(tmp_path / "cell_lines_small.RData",
           {"cell_lines_small": _cell_lines_object(12, 2)}, compress="bzip2")
    for name in ("cell_lines", "cell_lines_small"):
        ours = getattr(tdatasets, name)(path=str(tmp_path))
        theirs = getattr(jdatasets, name)(path=str(tmp_path))
        _same_dataset(ours, theirs, name)  # the files' cells, not the synthetic set
        assert ours.scaled_pcs.shape == ((40, 4) if name == "cell_lines" else (12, 4))
        assert set(ours.meta_data["dataset"]) <= {"jurkat", "t293"}


def test_pbmc_stim_from_rdata_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    ctrl = rng.poisson(0.7, size=(6, 9)).astype(np.float64)
    stim = rng.poisson(0.7, size=(6, 5)).astype(np.float64)
    genes = [f"g{i}" for i in range(6)]
    _write(tmp_path / "pbmc_stim.RData",
           {"pbmc.ctrl": _dgc(ctrl, [genes, [f"c{i}" for i in range(9)]]),
            "pbmc.stim": _dgc(stim, [genes, [f"s{i}" for i in range(5)]])})
    ours, theirs = tdatasets.pbmc_stim(path=str(tmp_path)), jdatasets.pbmc_stim(path=str(tmp_path))
    _same(list(ours), list(theirs))
    for m, dense in zip(ours, (ctrl, stim)):
        assert isinstance(m, tdatasets.SparseMatrix)
        np.testing.assert_array_equal(m.toarray(), dense)


def test_pbmc_stim_names_both_sources_when_missing(tmp_path):
    with pytest.raises(FileNotFoundError) as e:
        tdatasets.pbmc_stim(path=str(tmp_path))
    msg = str(e.value)
    assert "pbmc_ctrl.npz" in msg and "pbmc_stim.npz" in msg and "pbmc_stim.RData" in msg
    assert str(tmp_path) in msg
    with pytest.raises(FileNotFoundError):
        jdatasets.pbmc_stim(path=str(tmp_path))


def test_npz_is_read_before_the_rda(tmp_path):
    _write(tmp_path / "cell_lines_small.RData",
           {"cell_lines_small": _cell_lines_object(12, 2)})
    shutil.copy(os.path.join(tdatasets.VENDORED, "cell_lines_small.npz"), tmp_path)
    ours = tdatasets.cell_lines_small(path=str(tmp_path))
    _same_dataset(ours, jdatasets.cell_lines_small(path=str(tmp_path)), "cell_lines_small")
    assert ours.n_cells == 300


def test_search_dirs_follow_the_jax_package(monkeypatch):
    monkeypatch.setenv("HARMONY_TPU_DATA", "/somewhere")
    assert tdatasets._search_dirs(None) == ["/somewhere", tdatasets.VENDORED,
                                            tdatasets.REFERENCE_DATA]
    assert tdatasets.REFERENCE_DATA == jdatasets._DEFAULT_PATHS[2]
    assert tdatasets._search_dirs("/given") == ["/given"]


@pytest.mark.skipif(not os.path.isdir(tdatasets.REFERENCE_DATA),
                    reason="the reference's data/ is not mounted")
@pytest.mark.parametrize("fname", ["cell_lines.rda", "cell_lines_small.RData",
                                   "pbmc_stim.RData"])
def test_reference_files_decode_as_the_jax_reader(fname):
    path = os.path.join(tdatasets.REFERENCE_DATA, fname)
    if not os.path.exists(path):
        pytest.skip(f"{fname} is not in the reference's data/")
    _same(trdata.load_rdata(path), jrdata.load_rdata(path))


# ---- the native host helpers -------------------------------------------------

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None or not jnative.available(),
                               reason="no C++ toolchain")


def _csc(seed, nrow=30, ncol=45, density=0.25):
    rng = np.random.default_rng(seed)
    A = np.abs(rng.normal(size=(nrow, ncol)))
    A[rng.random(A.shape) > density] = 0.0
    A[:, 3] = 0.0  # an empty column: its sum is taken as 1
    indptr, indices, data = [0], [], []
    for c in range(ncol):
        nz = np.nonzero(A[:, c])[0]
        indices += nz.tolist()
        data += A[nz, c].tolist()
        indptr.append(len(indices))
    return A, np.array(data), np.array(indices, np.int64), np.array(indptr, np.int64)


@needs_gxx
def test_csc_row_stats_matches_jax_and_numpy():
    A, x, i, p = _csc(5)
    mean, sd = tnative.csc_row_stats(x, i, p, *A.shape)
    jmean, jsd = jnative.csc_row_stats(x, i, p, *A.shape)
    np.testing.assert_array_equal(mean, jmean)
    np.testing.assert_array_equal(sd, jsd)
    np.testing.assert_allclose(mean, A.mean(axis=1), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(sd, A.std(axis=1, ddof=1), rtol=1e-12, atol=1e-14)


@needs_gxx
def test_csc_log_normalize_matches_jax_and_numpy():
    A, x, i, p = _csc(6)
    ours = tnative.csc_log_normalize(x.copy(), p, A.shape[1], 1e4)
    theirs = jnative.csc_log_normalize(x.copy(), p, A.shape[1], 1e4)
    np.testing.assert_array_equal(ours, theirs)
    lib = A.sum(axis=0)
    dense = np.log1p(A / np.where(lib == 0, 1.0, lib)[None, :] * 1e4)
    np.testing.assert_allclose(ours, dense.T[A.T > 0], rtol=1e-12)
    # in place where the values are a contiguous float64 array
    y = x.copy()
    assert tnative.csc_log_normalize(y, p, A.shape[1]) is y
    with pytest.raises(ValueError, match="malformed"):
        tnative.csc_log_normalize(x.copy(), p[:-1], A.shape[1])


def test_native_helpers_return_none_without_the_library(monkeypatch):
    monkeypatch.setattr(tnative, "_load", lambda: None)
    A, x, i, p = _csc(7)
    assert tnative.csc_row_stats(x, i, p, *A.shape) is None
    assert tnative.csc_log_normalize(x, p, A.shape[1]) is None
