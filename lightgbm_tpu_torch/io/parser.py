"""Text data-file parsing: CSV / TSV / LibSVM.

Port of ``lightgbm_tpu/io/parser.py`` (reference: src/io/parser.cpp:195
``Parser::CreateParser`` format sniffing, parser.h CSVParser/TSVParser/
LibSVMParser, and the column roles of ``DatasetLoader::SetHeader``,
src/io/dataset_loader.cpp:39-167): ``label_column``/``weight_column``/
``group_column``/``ignore_column`` take an index (``"2"``) or a
``name:col`` form when the file has a header; integer specs other than the
label's do not count the label column. Parsing materializes a dense f64
matrix on the host, through the g++-built parser (``native/fastio.cpp``)
when it builds, else a Python parser; ``LAST_PARSE_PATH`` and the log say
which ran.

Sidecar files follow the reference conventions (src/io/metadata.cpp:473-560):
``<data>.weight`` (one weight per row), ``<data>.query`` (rows per query),
``<data>.init`` (one init score per row).
"""
from __future__ import annotations

import re
from typing import List, Optional, Tuple

import numpy as np

from .. import log

# which parser read the last file: "native" | "python" | "none"
LAST_PARSE_PATH = "none"

_NA_STRINGS = {"", "na", "nan", "null", "n/a", "none", "unknown", "?"}


def _to_float(tok: str) -> float:
    t = tok.strip()
    if t.lower() in _NA_STRINGS:
        return np.nan
    try:
        return float(t)
    except ValueError:
        return np.nan


def _note_path(path: str, native: bool) -> None:
    """Record and log which parser reads ``path``."""
    global LAST_PARSE_PATH
    LAST_PARSE_PATH = "native" if native else "python"
    if native:
        log.info(f"parsing {path} with the native parser")
    else:
        log.warning(f"parsing {path} with the Python parser (the native "
                    "parser did not build)")


def detect_format(path: str, skip_header: bool = False) -> Tuple[str, str]:
    """Sniff the file format from the first non-empty lines.

    Returns (kind, delimiter) with kind in {"libsvm", "csv", "tsv"}.
    Mirrors the reference's sampling logic (parser.cpp:64-141
    GetDelimiterAndNumColumns / DecideDataType): a line whose non-first tokens
    are ``idx:value`` pairs is LibSVM; otherwise the delimiter with the most
    consistent column count wins.
    """
    from .vfs import open_text
    lines: List[str] = []
    with open_text(path) as fh:
        for raw in fh:
            s = raw.strip()
            if s:
                lines.append(s)
            if len(lines) >= 32:
                break
    if not lines:
        log.fatal(f"Data file {path} is empty")
    if skip_header and len(lines) > 1:
        lines = lines[1:]

    def is_libsvm_line(line: str) -> bool:
        toks = line.replace("\t", " ").split()
        if len(toks) < 2:
            return False
        pairs = toks[1:]
        hits = sum(1 for t in pairs if ":" in t and
                   t.split(":", 1)[0].strip().lstrip("+-").isdigit())
        return hits >= max(1, len(pairs) - 1)

    if all(is_libsvm_line(ln) for ln in lines[:8] if ln):
        return "libsvm", " "
    # choose delimiter by consistency of column counts across sample lines
    best = ("tsv", "\t", -1)
    for kind, delim in (("tsv", "\t"), ("csv", ","), ("tsv", " ")):
        counts = [len(ln.split(delim)) for ln in lines]
        if min(counts) < 2:
            continue
        if len(set(counts)) == 1 and counts[0] > best[2]:
            best = (kind, delim, counts[0])
    if best[2] < 0:
        log.fatal(f"Cannot determine the delimiter of {path}")
    return best[0], best[1]


def _resolve_column(spec: str, header_names: Optional[List[str]]) -> int:
    """Column spec -> index. ``"2"`` -> 2; ``"name:foo"`` -> header lookup."""
    spec = spec.strip()
    if spec.startswith("name:"):
        name = spec[5:]
        if not header_names:
            log.fatal(f"Cannot use name:{name} without header")
        if name not in header_names:
            log.fatal(f"Column '{name}' not found in header")
        return header_names.index(name)
    return int(spec)


def _shift_past_label(idx: int, label_idx: int) -> int:
    """Integer column specs don't count the label column (config.h
    weight_column docs; dataset_loader.cpp erases the label name before
    building name2idx) — map a label-removed index back to raw file space."""
    if idx >= 0 and label_idx >= 0 and idx >= label_idx:
        return idx + 1
    return idx


def _resolve_columns(spec, header_names, label_idx: int = -1) -> List[int]:
    """Multi-column spec (ignore_column): 'name:a,b' or '0,1,2'."""
    if not spec:
        return []
    spec = str(spec).strip()
    if spec.startswith("name:"):
        names = spec[5:].split(",")
        return [_resolve_column(f"name:{n}", header_names) for n in names]
    return [_shift_past_label(int(s), label_idx)
            for s in spec.split(",") if s.strip() != ""]


class ParsedFile:
    """Loaded text data file with column roles applied."""

    def __init__(self, X: np.ndarray, label: Optional[np.ndarray],
                 weight: Optional[np.ndarray], group: Optional[np.ndarray],
                 init_score: Optional[np.ndarray],
                 feature_names: Optional[List[str]]):
        self.X = X
        self.label = label
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.feature_names = feature_names


def _load_sidecars(path: str):
    """Reference conventions: <file>.weight / .query / .init sidecar files
    (metadata.cpp:473 LoadWeights, :500 LoadQueryBoundaries, :521 LoadInitialScore)."""
    from .vfs import exists, open_file
    weight = group = init = None
    wpath = path + ".weight"
    if exists(wpath):
        with open_file(wpath, "rb") as fh:
            weight = np.loadtxt(fh, dtype=np.float64).reshape(-1)
        log.info(f"Loading weights from {wpath}")
    qpath = path + ".query"
    if exists(qpath):
        with open_file(qpath, "rb") as fh:
            group = np.loadtxt(fh, dtype=np.int64).reshape(-1)
        log.info(f"Loading query boundaries from {qpath}")
    ipath = path + ".init"
    if exists(ipath):
        with open_file(ipath, "rb") as fh:
            init = np.loadtxt(fh, dtype=np.float64)
        log.info(f"Loading initial scores from {ipath}")
    return weight, group, init


def _stream_line_chunks(path: str, chunk_bytes: int = 64 << 20):
    """Yield byte chunks ending on line boundaries (partial tail carried
    over) — the streaming primitive for two-round loading."""
    from .vfs import open_file
    carry = b""
    with open_file(path, "rb") as fh:
        while True:
            block = fh.read(chunk_bytes)
            if not block:
                break
            buf = carry + block
            cut = buf.rfind(b"\n")
            if cut < 0:
                carry = buf
                continue
            yield buf[: cut + 1]
            carry = buf[cut + 1:]
    if carry.strip():
        yield carry


def _load_delimited_two_round(path: str, delim: str, header: bool
                              ) -> np.ndarray:
    """Two-phase delimited load (reference: TextReader two-phase,
    utils/text_reader.h + two_round config): pass 1 counts rows/columns,
    pass 2 parses chunk-by-chunk into the preallocated matrix — peak memory
    is the f64 matrix plus ONE text chunk, not text + matrix together."""
    from ..native import get_lib, parse_delimited
    _note_path(path, get_lib() is not None)
    n_rows = 0
    ncol = 0
    first = True
    # requires a REAL second newline so a chunk's terminating '\n' at
    # end-of-chunk does not count as a blank line (chunks end at newline
    # boundaries; the unterminated final carry is whitespace-checked below)
    blank_re = re.compile(rb"(?:^|\n)[ \t\r]*\n")
    for chunk in _stream_line_chunks(path):
        if first:
            line = chunk.split(b"\n", 1)[0]
            ncol = line.count(delim.encode()) + 1
            first = False
        # fast path: newline count (+1 for a final unterminated line);
        # exact per-line scan only for chunks that contain blank lines
        if blank_re.search(chunk) or not chunk.strip():
            n_rows += sum(1 for ln in chunk.splitlines() if ln.strip())
        else:
            n_rows += chunk.count(b"\n") + (not chunk.endswith(b"\n"))
    if header:
        n_rows -= 1
    if n_rows <= 0 or ncol <= 0:
        log.fatal(f"Data file {path} has no data rows")
    out = np.empty((n_rows, ncol), dtype=np.float64)
    row = 0
    skip_first = header
    for chunk in _stream_line_chunks(path):
        part = parse_delimited(chunk, delim, skip_first=skip_first)
        if part is None:  # no native toolchain: python per-chunk fallback
            lines = [ln for ln in chunk.decode("utf-8", "replace").splitlines()
                     if ln.strip()]
            if skip_first and lines:
                lines = lines[1:]
            part = np.empty((len(lines), ncol), dtype=np.float64)
            for i, ln in enumerate(lines):
                toks = ln.rstrip("\r").split(delim)
                if len(toks) != ncol:
                    log.fatal(f"{path}: row has {len(toks)} columns, "
                              f"expected {ncol}")
                for j, t in enumerate(toks):
                    part[i, j] = _to_float(t)
        skip_first = False
        if part.shape[0]:
            if part.shape[1] != ncol:
                log.fatal(f"{path}: chunk with {part.shape[1]} columns, "
                          f"expected {ncol}")
            out[row: row + part.shape[0]] = part
            row += part.shape[0]
    if row != n_rows:
        log.fatal(f"{path}: two-round pass mismatch ({row} vs {n_rows} rows)")
    return out


def load_file(path: str, header: bool = False, label_column: str = "",
              weight_column: str = "", group_column: str = "",
              ignore_column: str = "", num_features_hint: int = 0,
              two_round: bool = False) -> ParsedFile:
    """Load a CSV/TSV/LibSVM data file with column roles.

    Defaults mirror the reference (config.h label_column docs): label is
    column 0 of the used columns unless specified; LibSVM labels are the
    leading bare token of each row.
    """
    from .vfs import exists as _vfs_exists
    if not _vfs_exists(path):
        log.fatal(f"Data file {path} does not exist")
    kind, delim = detect_format(path, skip_header=header)

    sw, sg, si = _load_sidecars(path)

    if kind == "libsvm":
        if two_round:
            log.warning("two_round streaming is implemented for delimited "
                        "files only; the LibSVM path loads in one pass")
        X, y = _load_libsvm(path, num_features_hint)
        return ParsedFile(X, y, sw, sg, si, None)

    header_names: Optional[List[str]] = None
    if header:
        from .vfs import open_text
        with open_text(path) as fh:
            first_line = fh.readline().rstrip("\n\r")
        header_names = [t.strip() for t in first_line.split(delim)]

    if two_round:
        # streaming two-phase load (reference: TextReader two-phase +
        # two_round config): the raw text never sits fully in RAM
        mat = _load_delimited_two_round(path, delim, bool(header))
        raw_bytes = b""
    else:
        # native multithreaded parser (native/fastio.cpp, the analog of the
        # reference's C++ CSVParser/TSVParser); NumPy/Python fallback below
        from ..native import parse_delimited
        from .vfs import open_file
        with open_file(path, "rb") as fh:
            raw_bytes = fh.read()
        mat = parse_delimited(raw_bytes, delim, skip_first=bool(header))
    _note_path(path, mat is not None)
    if mat is None:
        rows: List[List[str]] = []
        first = True
        for line in raw_bytes.decode("utf-8", "replace").splitlines():
            s_line = line.rstrip("\r")
            if not s_line.strip():
                continue
            if first and header:
                first = False
                continue
            first = False
            rows.append(s_line.split(delim))
        if not rows:
            log.fatal(f"Data file {path} has no data rows")
        ncol = len(rows[0])
        mat = np.empty((len(rows), ncol), dtype=np.float64)
        for i, toks in enumerate(rows):
            if len(toks) != ncol:
                log.fatal(f"{path}: row {i} has {len(toks)} columns, "
                          f"expected {ncol}")
            for j, t in enumerate(toks):
                mat[i, j] = _to_float(t)
    ncol = mat.shape[1]

    label_idx = _resolve_column(label_column, header_names) if label_column \
        else 0
    weight_idx = _resolve_column(weight_column, header_names) \
        if weight_column else -1
    group_idx = _resolve_column(group_column, header_names) if group_column \
        else -1
    # integer specs are in label-removed space (config.h: "doesn't count the
    # label column"); name: specs resolve in raw header space
    if weight_column and not str(weight_column).strip().startswith("name:"):
        weight_idx = _shift_past_label(weight_idx, label_idx)
    if group_column and not str(group_column).strip().startswith("name:"):
        group_idx = _shift_past_label(group_idx, label_idx)
    ignore = set(_resolve_columns(ignore_column, header_names, label_idx))

    label = mat[:, label_idx] if label_idx >= 0 else None
    weight = mat[:, weight_idx] if weight_idx >= 0 else sw
    if group_idx >= 0:
        # in-file group column holds a query id per row; convert to sizes
        qid = mat[:, group_idx].astype(np.int64)
        change = np.nonzero(np.diff(qid))[0]
        bounds = np.concatenate([[0], change + 1, [len(qid)]])
        group = np.diff(bounds)
    else:
        group = sg

    feat_cols = [j for j in range(ncol)
                 if j not in ignore and j != label_idx and j != weight_idx
                 and j != group_idx]
    X = np.ascontiguousarray(mat[:, feat_cols])
    names = [header_names[j] for j in feat_cols] if header_names else None
    return ParsedFile(X, label, weight, group, si, names)


def _load_libsvm(path: str, num_features_hint: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """LibSVM rows: ``label idx:val idx:val ...`` (0- or 1-based indices kept
    as-is, matching the reference's zero_as_missing-friendly dense fill)."""
    from ..native import parse_libsvm
    from .vfs import open_file
    with open_file(path, "rb") as fh:
        raw_bytes = fh.read()
    res = parse_libsvm(raw_bytes, num_features_hint)
    _note_path(path, res is not None)
    if res is not None:
        return res
    labels: List[float] = []
    entries: List[List[Tuple[int, float]]] = []
    max_idx = -1
    from .vfs import open_text
    with open_text(path) as fh:
        for raw in fh:
            s = raw.strip()
            if not s:
                continue
            toks = s.replace("\t", " ").split()
            labels.append(_to_float(toks[0]))
            row: List[Tuple[int, float]] = []
            for t in toks[1:]:
                if ":" not in t:
                    continue
                k, v = t.split(":", 1)
                idx = int(k)
                row.append((idx, _to_float(v)))
                if idx > max_idx:
                    max_idx = idx
            entries.append(row)
    nf = max(max_idx + 1, num_features_hint)
    X = np.zeros((len(entries), nf), dtype=np.float64)  # absent == 0 (sparse)
    for i, row in enumerate(entries):
        for j, v in row:
            X[i, j] = v
    return X, np.asarray(labels, dtype=np.float64)
