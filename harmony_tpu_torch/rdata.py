"""A reader for R workspace files (.rda / .RData: RDX2/RDX3, XDR), NumPy only.

The port's own copy of what ``harmony_tpu/rdata.py`` does, with the same
names and the same decoding, so :mod:`harmony_tpu_torch.datasets` reads the
reference's bundled datasets (``cell_lines``, ``cell_lines_small`` as lists
of data.frames; ``pbmc.ctrl``/``pbmc.stim`` as ``dgCMatrix`` S4 sparse
matrices) as the JAX package reads them. Written from R's serialization
format (R's ``serialize.c``).

Supported: gzip, bzip2 and xz compression; XDR ("X\\n") encoding; the SEXP
types NILSXP, SYMSXP, LISTSXP, CHARSXP, LGLSXP, INTSXP, REALSXP, CPLXSXP,
STRSXP, VECSXP, RAWSXP, S4SXP and REFSXP, environments, external and weak
pointers; attributes; ALTREP (compact sequences, wrapped vectors, deferred
strings).

Decoded R objects map to Python as:

* numeric/integer/logical vectors -> NumPy arrays (NA -> nan / -2**31;
  logical NA -> None in an object array of bools)
* character vectors -> NumPy object arrays of str/None
* factor -> :class:`RFactor` (codes + levels; ``as_strings()``)
* data.frame -> dict of column name -> decoded column
* dgCMatrix -> :class:`SparseMatrix` (CSC arrays; ``toarray()``)
* a matrix with dimnames -> :class:`RMatrix`
* named list -> dict, unnamed list -> list
"""

from __future__ import annotations

import bz2
import dataclasses
import gzip
import lzma
import struct
from typing import Any, Dict, List, Optional

import numpy as np

# SEXP type codes (R internals)
NILSXP = 0
SYMSXP = 1
LISTSXP = 2
ENVSXP = 4
LANGSXP = 6
CHARSXP = 9
LGLSXP = 10
INTSXP = 13
REALSXP = 14
CPLXSXP = 15
STRSXP = 16
VECSXP = 19
EXPRSXP = 20
EXTPTRSXP = 22
WEAKREFSXP = 23
RAWSXP = 24
S4SXP = 25
# pseudo-types of the serialization format
ALTREP_SXP = 238
BASEENV_SXP = 241
EMPTYENV_SXP = 242
PACKAGESXP = 248
NAMESPACESXP = 249
MISSINGARG_SXP = 251
GLOBALENV_SXP = 253
NILVALUE_SXP = 254
REFSXP = 255

R_NA_INT = -2147483648


class RDataError(ValueError):
    pass


@dataclasses.dataclass
class RFactor:
    codes: np.ndarray  # 0-based here (1-based in R), NA -> -1
    levels: np.ndarray  # object array of str

    def as_strings(self) -> np.ndarray:
        out = np.empty(self.codes.shape, dtype=object)
        valid = self.codes >= 0
        out[valid] = self.levels[self.codes[valid]]
        out[~valid] = None
        return out

    def __len__(self):
        return len(self.codes)


@dataclasses.dataclass
class SparseMatrix:
    """A CSC sparse matrix (genes x cells): the fields of a Matrix-package
    dgCMatrix, as ``harmony_tpu.rdata.RSparseMatrix`` holds them."""

    data: np.ndarray  # x
    indices: np.ndarray  # i (row indices)
    indptr: np.ndarray  # p (column pointers)
    shape: tuple
    dimnames: Optional[list] = None

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csc_matrix((self.data, self.indices, self.indptr), shape=self.shape)

    def toarray(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.data.dtype)
        for c in range(self.shape[1]):
            sl = slice(self.indptr[c], self.indptr[c + 1])
            out[self.indices[sl], c] = self.data[sl]
        return out


# the JAX package's name of the dgCMatrix holder
RSparseMatrix = SparseMatrix


@dataclasses.dataclass
class RObject:
    """A decoded SEXP with its attributes, before conversion."""

    type: int
    value: Any
    attributes: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class RMatrix:
    values: np.ndarray
    dimnames: Optional[list]


class _PairTail:
    """A decoded pairlist (association list)."""

    def __init__(self, pairs, rest):
        self.pairs = pairs
        self.rest = rest
        self.attributes: Dict[str, Any] = {}


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.refs: List[Any] = []

    # ---- primitives (XDR: big-endian) ------------------------------------
    def _read(self, n: int) -> bytes:
        b = self.data[self.pos:self.pos + n]
        if len(b) != n:
            raise RDataError("unexpected EOF")
        self.pos += n
        return b

    def u32(self) -> int:
        return struct.unpack(">I", self._read(4))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self._read(4))[0]

    def length(self) -> int:
        n = self.i32()
        if n == -1:  # a long vector: two 32-bit words
            hi, lo = self.u32(), self.u32()
            return (hi << 32) | lo
        return n

    def read_header(self) -> int:
        magic = self._read(2)
        if magic in (b"A\n", b"B\n"):
            raise RDataError("only XDR-format RData is supported")
        if magic != b"X\n":
            raise RDataError(f"bad serialization header {magic!r}")
        version = self.i32()
        self.i32()  # writer version
        self.i32()  # min reader version
        if version >= 3:
            self._read(self.i32())  # native encoding name
        return version

    def _vector(self, typ: int, values, has_attr: bool) -> RObject:
        obj = RObject(typ, values)
        obj.attributes = self.read_attributes() if has_attr else {}
        return obj

    # ---- SEXP reader -------------------------------------------------------
    def read_item(self) -> Any:
        flags = self.u32()
        typ = flags & 0xFF
        levels = flags >> 12
        has_attr = bool(flags & 0x200)
        has_tag = bool(flags & 0x400)

        if typ in (NILVALUE_SXP, NILSXP):
            return None
        if typ == REFSXP:
            idx = flags >> 8
            if idx == 0:
                idx = self.u32()
            return self.refs[idx - 1]
        if typ == SYMSXP:
            sym = self.read_item()  # its CHARSXP
            obj = RObject(SYMSXP, sym.value if isinstance(sym, RObject) else sym)
            self.refs.append(obj)
            return obj
        if typ in (PACKAGESXP, NAMESPACESXP):
            # a persistent name: a STRSXP-like vector of CHARSXPs
            self.i32()
            n = self.i32()
            obj = RObject(typ, [self._read_charsxp_item() for _ in range(n)])
            self.refs.append(obj)
            return obj
        if typ in (GLOBALENV_SXP, BASEENV_SXP, EMPTYENV_SXP, MISSINGARG_SXP):
            return RObject(typ, None)
        if typ == ENVSXP:
            # locked flag, enclosure, frame, hash table, attributes
            obj = RObject(ENVSXP, None)
            self.refs.append(obj)
            self.u32()
            obj.value = {k: self.read_item() for k in ("enclos", "frame", "hashtab", "attrib")}
            return obj
        if typ in (LISTSXP, LANGSXP):
            # a pairlist node: attributes?, tag?, CAR, CDR
            attrs = self.read_attributes() if has_attr else {}
            tag = self.read_item() if has_tag else None
            car = self.read_item()
            cdr = self.read_item()
            pairs = [(tag, car)]
            while isinstance(cdr, _PairTail):
                pairs.extend(cdr.pairs)
                cdr = cdr.rest
            tail = _PairTail(pairs, cdr)
            tail.attributes = attrs
            return tail
        if typ == CHARSXP:
            return RObject(CHARSXP, self._read_charsxp(levels))
        if typ == LGLSXP:
            vals = np.frombuffer(self._read(4 * self.length()), dtype=">i4").astype(np.int32)
            out = np.where(vals == R_NA_INT, None, vals != 0).astype(object)
            return self._vector(LGLSXP, out, has_attr)
        if typ == INTSXP:
            vals = np.frombuffer(self._read(4 * self.length()), dtype=">i4").astype(np.int32)
            return self._vector(INTSXP, vals, has_attr)
        if typ == REALSXP:
            vals = np.frombuffer(self._read(8 * self.length()), dtype=">f8").astype(np.float64)
            return self._vector(REALSXP, vals, has_attr)
        if typ == CPLXSXP:
            vals = np.frombuffer(self._read(16 * self.length()),
                                 dtype=">c16").astype(np.complex128)
            return self._vector(CPLXSXP, vals, has_attr)
        if typ == STRSXP:
            n = self.length()
            vals = np.empty(n, dtype=object)
            for i in range(n):
                vals[i] = self._read_charsxp_item()
            return self._vector(STRSXP, vals, has_attr)
        if typ in (VECSXP, EXPRSXP):
            n = self.length()
            return self._vector(VECSXP, [self.read_item() for _ in range(n)], has_attr)
        if typ == RAWSXP:
            n = self.length()
            return self._vector(RAWSXP, np.frombuffer(self._read(n), dtype=np.uint8), has_attr)
        if typ == S4SXP:
            return self._vector(S4SXP, None, has_attr)
        if typ == EXTPTRSXP:  # e.g. data.table's .internal.selfref
            obj = RObject(typ, None)
            self.refs.append(obj)
            self.read_item()  # protected value
            self.read_item()  # tag
            if has_attr:
                obj.attributes = self.read_attributes()
            return obj
        if typ == WEAKREFSXP:
            obj = RObject(typ, None)
            self.refs.append(obj)
            return obj
        if typ == ALTREP_SXP:
            info = self.read_item()  # the class: a pairlist of symbols
            state = self.read_item()
            attr = self.read_item()
            return _decode_altrep(info, state, attr)
        raise RDataError(f"unsupported SEXP type {typ}")

    def _read_charsxp(self, levels: int) -> Optional[str]:
        n = self.i32()
        if n == -1:
            return None  # NA_character_
        raw = self._read(n)
        if levels & 0x4:  # LATIN1_MASK
            return raw.decode("latin-1")
        return raw.decode("utf-8", errors="replace")

    def _read_charsxp_item(self) -> Optional[str]:
        item = self.read_item()
        if item is None:
            return None
        if isinstance(item, RObject) and item.type == CHARSXP:
            return item.value
        raise RDataError("expected CHARSXP in string vector")

    def read_attributes(self) -> Dict[str, Any]:
        tail = self.read_item()
        if tail is None:
            return {}
        if not isinstance(tail, _PairTail):
            raise RDataError("attributes must be a pairlist")
        return {_sym_name(tag): car for tag, car in tail.pairs}


def _decode_altrep(info, state, attr):
    """The common ALTREP payloads: compact sequences, wrapped vectors and
    deferred strings."""
    name = None
    if isinstance(info, _PairTail) and info.pairs:
        car = info.pairs[0][1]
        if isinstance(car, RObject) and car.type == SYMSXP:
            name = car.value
    if name == "compact_intseq":
        n, start, step = (int(v) for v in state.value)  # REALSXP c(n, start, step)
        return RObject(INTSXP, np.arange(start, start + n * step, step, dtype=np.int32))
    if name == "compact_realseq":
        n, start, step = state.value
        return RObject(REALSXP, np.arange(start, start + n * step, step, dtype=np.float64))
    if name in ("wrap_real", "wrap_integer", "wrap_logical", "wrap_string", "wrap_raw",
                "wrap_complex"):
        return state.value[0] if isinstance(state, RObject) else state  # [payload, meta]
    if name == "deferred_string":
        payload = state.value[0] if isinstance(state, RObject) else state
        # the numbers as R would print them
        return RObject(STRSXP, np.array([_r_num_to_str(v) for v in payload.value], dtype=object))
    raise RDataError(f"unsupported ALTREP class {name!r}")


def _r_num_to_str(v) -> str:
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


# ---- conversion to Python -------------------------------------------------


def _attr_value(attrs: Dict[str, Any], name: str):
    v = attrs.get(name)
    return _convert(v) if v is not None else None


def _sym_name(tag) -> Optional[str]:
    if isinstance(tag, RObject) and tag.type == SYMSXP:
        return tag.value
    return None


def _convert(obj: Any) -> Any:
    """A decoded RObject tree as Python values."""
    if obj is None:
        return None
    if isinstance(obj, _PairTail):
        return {_sym_name(t): _convert(c) for t, c in obj.pairs}
    if not isinstance(obj, RObject):
        return obj
    attrs = obj.attributes or {}
    cls = None
    if "class" in attrs:
        cls_v = attrs["class"]
        cls = list(cls_v.value) if isinstance(cls_v, RObject) else None

    if obj.type == INTSXP and cls and "factor" in cls:
        codes = obj.value.astype(np.int64) - 1
        codes[obj.value == R_NA_INT] = -1
        return RFactor(codes=codes, levels=np.asarray(_attr_value(attrs, "levels"), dtype=object))

    if obj.type == S4SXP:
        conv = {k: _convert(v) for k, v in attrs.items() if k}
        if cls and any(c in ("dgCMatrix", "lgCMatrix", "ngCMatrix") for c in cls):
            x = conv.get("x")
            if x is None:  # a pattern matrix
                x = np.ones(len(conv["i"]), dtype=np.float64)
            return SparseMatrix(
                data=np.asarray(x), indices=np.asarray(conv["i"], dtype=np.int64),
                indptr=np.asarray(conv["p"], dtype=np.int64),
                shape=tuple(int(v) for v in conv["Dim"]), dimnames=conv.get("Dimnames"))
        conv["__class__"] = cls
        return conv

    if obj.type == VECSXP:
        names = _attr_value(attrs, "names")
        vals = [_convert(v) for v in obj.value]
        if cls and "data.frame" in cls:
            if names is None:
                names = [f"V{i + 1}" for i in range(len(vals))]
            return dict(zip(list(names), vals))
        if names is not None and len(names) == len(vals) and all(n for n in names):
            return dict(zip(list(names), vals))
        return vals

    if obj.type in (REALSXP, INTSXP, LGLSXP, STRSXP, CPLXSXP, RAWSXP):
        val = obj.value
        dim = _attr_value(attrs, "dim")
        if dim is not None:
            # R stores column-major
            val = np.asarray(val).reshape(tuple(int(x) for x in dim), order="F")
            dimnames = _attr_value(attrs, "dimnames")
            if dimnames is not None:
                return RMatrix(values=val, dimnames=dimnames)
        return val

    if obj.type in (CHARSXP, SYMSXP):
        return obj.value
    return obj


def _decompress(raw: bytes) -> bytes:
    if raw[:2] == b"\x1f\x8b":
        return gzip.decompress(raw)
    if raw[:3] == b"BZh":
        return bz2.decompress(raw)
    if raw[:6] == b"\xfd7zXZ\x00":
        return lzma.decompress(raw)
    return raw


def load_rdata(path: str) -> Dict[str, Any]:
    """Load a .rda/.RData file: {object name: Python value}."""
    with open(path, "rb") as fh:
        raw = _decompress(fh.read())
    if raw[:5] not in (b"RDX2\n", b"RDX3\n"):
        raise RDataError(f"not an RData file: header {raw[:5]!r}")
    r = _Reader(raw[5:])
    r.read_header()
    top = r.read_item()
    out: Dict[str, Any] = {}
    if isinstance(top, _PairTail):
        for tag, car in top.pairs:
            out[_sym_name(tag)] = _convert(car)
    elif top is not None:
        out["value"] = _convert(top)
    return out
