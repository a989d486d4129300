"""Atomic artifact persistence: CSV + TOML.

Parity: reference src/caliscope/persistence.py:21-125 (atomic tmp+fsync+rename
writes). The reference uses rtoml (Rust); here reading uses stdlib tomllib and
writing uses a small first-party emitter that produces the same structures the
reference's TOML files use (tables, nested lists of numbers, strings, bools),
so camera_array.toml / aniposelib TOML round-trip bit-compatibly in structure.

Host-only copy of caliscope_tpu/persistence.py, plus a pandas-free CSV
reader/writer: the JAX package goes through pandas at the CSV boundary, and
the port writes the same bytes (header, ``repr`` floats, empty cells for
NaN, ``\n`` line ends) with the standard library alone; and a grey 8-bit
PNG encoder (zlib and struct), where the JAX package goes through PIL.
"""

from __future__ import annotations

import csv
import math
import os
import struct
import tempfile
import tomllib
import zlib
from pathlib import Path
from typing import Any

from caliscope_tpu_torch.exceptions import PersistenceError

__all__ = [
    "PersistenceError", "load_toml", "read_csv_columns", "safe_write_toml", "safe_write_text",
    "toml_dumps", "write_csv_columns", "write_png_gray",
]


def _fmt_value(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return "nan"
        if math.isinf(v):
            return "inf" if v > 0 else "-inf"
        if v == int(v) and abs(v) < 1e15:
            return f"{v:.1f}"
        return repr(v)
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_fmt_value(x) for x in v) + "]"
    if hasattr(v, "tolist"):  # numpy array / scalar
        return _fmt_value(v.tolist())
    if hasattr(v, "item"):
        return _fmt_value(v.item())
    raise PersistenceError(f"Cannot serialize value of type {type(v)} to TOML")


def _is_table(v: Any) -> bool:
    return isinstance(v, dict)


def _is_table_array(v: Any) -> bool:
    return isinstance(v, (list, tuple)) and len(v) > 0 and all(isinstance(x, dict) for x in v)


def _quote_name(name: str) -> str:
    return ".".join(p if p.replace("_", "").replace("-", "").isalnum() else '"' + p + '"' for p in name.split("."))


def _emit_table(out: list[str], table: dict, prefix: str) -> None:
    scalars = {k: v for k, v in table.items() if not _is_table(v) and not _is_table_array(v)}
    arrays = {k: v for k, v in table.items() if _is_table_array(v)}
    subtables = {k: v for k, v in table.items() if _is_table(v)}
    for k, v in scalars.items():
        if v is None:
            continue  # missing key == null, matching the reference's convention
        key = k if k.replace("_", "").replace("-", "").isalnum() else '"' + k + '"'
        out.append(f"{key} = {_fmt_value(v)}")
    for k, rows in arrays.items():
        name = f"{prefix}.{k}" if prefix else k
        for row in rows:
            out.append("")
            out.append(f"[[{_quote_name(name)}]]")
            _emit_table(out, row, name)
    for k, v in subtables.items():
        name = f"{prefix}.{k}" if prefix else k
        out.append("")
        out.append(f"[{_quote_name(name)}]")
        _emit_table(out, v, name)


def toml_dumps(data: dict) -> str:
    out: list[str] = []
    _emit_table(out, data, "")
    return "\n".join(out).lstrip("\n") + "\n"


def _atomic_write(path: Path, data: str | bytes) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix="." + path.name + ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb" if isinstance(data, bytes) else "w") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError as e:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise PersistenceError(f"Failed to write {path}: {e}") from e


def safe_write_toml(data: dict, path: Path | str) -> None:
    _atomic_write(Path(path), toml_dumps(data))


def safe_write_text(text: str, path: Path | str) -> None:
    _atomic_write(Path(path), text)


def load_toml(path: Path | str) -> dict:
    path = Path(path)
    if not path.exists():
        raise PersistenceError(f"TOML file not found: {path}")
    try:
        with open(path, "rb") as f:
            return tomllib.load(f)
    except tomllib.TOMLDecodeError as e:
        raise PersistenceError(f"Invalid TOML in {path}: {e}") from e


def _fmt_csv_cell(v) -> str:
    if isinstance(v, float):
        return "" if math.isnan(v) else repr(v)
    return str(v)


def write_csv_columns(columns: dict, path: Path | str) -> None:
    """Write named 1-D numpy columns as CSV, cell for cell as
    ``pandas.DataFrame(columns).to_csv(index=False)`` writes them."""
    names = list(columns)
    cols = [c.tolist() for c in columns.values()]
    lines = [",".join(names)]
    lines += [",".join(_fmt_csv_cell(v) for v in row) for row in zip(*cols)]
    safe_write_text("\n".join(lines) + "\n", Path(path))


def read_csv_columns(path: Path | str) -> dict[str, list[str]]:
    """Read a CSV with a header row into {column name: list of cell strings}."""
    path = Path(path)
    if not path.exists():
        raise PersistenceError(f"CSV file not found: {path}")
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        raise PersistenceError(f"CSV file {path} has no header row")
    header, body = rows[0], rows[1:]
    return {name: [r[i] if i < len(r) else "" for r in body] for i, name in enumerate(header)}


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png_gray(image, path: Path | str) -> None:
    """Write a (H, W) uint8 array as a grey 8-bit PNG: one IHDR, one IDAT
    of zlib-compressed rows each led by filter type 0 (none), IEND."""
    if image.ndim != 2 or image.dtype.name != "uint8":
        raise PersistenceError(f"write_png_gray takes a (H, W) uint8 array, got {image.shape} {image.dtype}")
    h, w = image.shape
    rows = bytearray()
    for row in image:
        rows += b"\x00" + row.tobytes()
    _atomic_write(
        Path(path),
        b"\x89PNG\r\n\x1a\n"
        + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
        + _png_chunk(b"IDAT", zlib.compress(bytes(rows), 6))
        + _png_chunk(b"IEND", b""),
    )
