"""Stage checkpointing: save/load pipeline Frames.

Counterpart of ``sarlacc_tpu/utils/serialize.py`` with the same file
format (one ``.npz`` holding the arrays plus a JSON manifest under
``__manifest__``), so a file written by either package loads in the other.

The reference's checkpoint model is stage materialization: every API
returns a self-describing DataFrame whose metadata carries what downstream
stages need (filepath, penalties, adaptor sequences), and later stages
re-derive sequence bytes from the FASTQ.  That model stays, with explicit
persistence added: a Frame (with nested frames and SeqBatch columns)
round-trips through one file.
"""

from __future__ import annotations

import json

import numpy as np

from ..core.encode import SeqBatch
from ..core.frame import Frame

__all__ = ["save_frame", "load_frame"]


def _flatten(frame: Frame, prefix: str, arrays: dict, manifest: dict) -> None:
    manifest["type"] = "frame"
    manifest["nrow"] = len(frame)
    manifest["metadata"] = _jsonable_meta(frame.metadata, arrays, prefix + "@meta")
    if frame.rownames is not None:
        manifest["rownames"] = frame.rownames
    cols = manifest["columns"] = {}
    for name, col in frame.columns.items():
        key = f"{prefix}.{name}"
        if isinstance(col, Frame):
            cols[name] = {}
            _flatten(col, key, arrays, cols[name])
        elif isinstance(col, SeqBatch):
            cols[name] = {"type": "seqbatch", "names": col.names}
            arrays[key + "#codes"] = col.codes
            arrays[key + "#lengths"] = col.lengths
            if col.quals is not None:
                arrays[key + "#quals"] = col.quals
        elif isinstance(col, np.ndarray):
            cols[name] = {"type": "array"}
            arrays[key] = col
        else:
            cols[name] = {"type": "list", "values": _jsonable(col)}


def _jsonable(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (np.integer, np.floating, np.bool_)):
        return v.item()
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return v


def _jsonable_meta(meta: dict, arrays: dict, prefix: str) -> dict:
    out = {}
    for k, v in meta.items():
        if isinstance(v, np.ndarray):
            arrays[f"{prefix}.{k}"] = v
            out[k] = {"__array__": f"{prefix}.{k}"}
        else:
            out[k] = _jsonable(v)
    return out


def save_frame(frame: Frame, path: str) -> None:
    """Persist a Frame to ``path`` (.npz)."""
    arrays: dict[str, np.ndarray] = {}
    manifest: dict = {}
    _flatten(frame, "root", arrays, manifest)
    arrays["__manifest__"] = np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8
    )
    np.savez_compressed(path, **arrays)


def _rebuild(manifest: dict, prefix: str, arrays) -> Frame:
    cols: dict = {}
    for name, desc in manifest.get("columns", {}).items():
        key = f"{prefix}.{name}"
        t = desc.get("type")
        if t == "frame":
            cols[name] = _rebuild(desc, key, arrays)
        elif t == "seqbatch":
            quals = arrays[key + "#quals"] if key + "#quals" in arrays else None
            cols[name] = SeqBatch(
                arrays[key + "#codes"],
                arrays[key + "#lengths"],
                quals,
                desc.get("names"),
            )
        elif t == "array":
            cols[name] = arrays[key]
        else:
            cols[name] = desc["values"]
    meta = {}
    for k, v in manifest.get("metadata", {}).items():
        if isinstance(v, dict) and "__array__" in v:
            meta[k] = arrays[v["__array__"]]
        else:
            meta[k] = v
    return Frame(
        cols,
        metadata=meta,
        rownames=manifest.get("rownames"),
        nrow=manifest.get("nrow"),
    )


def load_frame(path: str) -> Frame:
    with np.load(path, allow_pickle=False) as data:
        manifest = json.loads(bytes(data["__manifest__"]).decode())
        arrays = {k: data[k] for k in data.files if k != "__manifest__"}
    return _rebuild(manifest, "root", arrays)
