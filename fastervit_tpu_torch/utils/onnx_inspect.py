"""Minimal pure-python ONNX ModelProto reader (no `onnx` package needed; a
copy of fastervit_tpu/utils/onnx_inspect.py).

The reference ships a polygraphy/graphsurgeon fold-constants Optimizer and
an onnxsim pass over its exported artifact (onnx_convert.py:97-152). Our
export leg applies torch.onnx's built-in constant folding at export time
(utils/export.export_onnx optimize=True); this module provides the
*verification* half — structural inspection of the serialized ModelProto —
in an environment where the `onnx` python package cannot be installed.

Implements just enough protobuf wire-format decoding (varints + length-
delimited fields) to walk ModelProto -> GraphProto -> NodeProto and report
op-type histograms, initializer counts, and graph IO — the quantities a
fold-constants pass changes.

Wire schema (onnx.proto3):
  ModelProto:  ir_version=1 varint, opset_import=8 (domain=1, version=2),
               graph=7
  GraphProto:  node=1, name=2, initializer=5 (TensorProto), input=11,
               output=12 (ValueInfoProto: name=1)
  NodeProto:   input=1, output=2, name=3, op_type=4
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Iterator, Tuple


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        result |= (b & 0x7F) << shift
        pos += 1
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, int, bytes]]:
    """Yield (field_number, wire_type, payload) over a message buffer;
    varints yield their int value, everything else yields raw bytes."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:  # varint
            val, pos = _read_varint(buf, pos)
            yield field, wt, val
        elif wt == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            yield field, wt, buf[pos:pos + ln]
            pos += ln
        elif wt == 5:  # 32-bit
            yield field, wt, buf[pos:pos + 4]
            pos += 4
        elif wt == 1:  # 64-bit
            yield field, wt, buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wt} at {pos}")


def _value_info_name(buf: bytes) -> str:
    for f, wt, v in _fields(buf):
        if f == 1 and wt == 2:
            return v.decode("utf-8", "replace")
    return ""


def inspect_onnx(path: str) -> Dict:
    """-> {'ir_version', 'opsets': {domain: version}, 'num_nodes',
    'op_types': Counter, 'num_initializers', 'inputs': [...],
    'outputs': [...]}"""
    with open(path, "rb") as f:
        buf = f.read()
    info = {"ir_version": None, "opsets": {}, "num_nodes": 0,
            "op_types": Counter(), "num_initializers": 0,
            "inputs": [], "outputs": []}
    graph = None
    for f_no, wt, v in _fields(buf):
        if f_no == 1 and wt == 0:
            info["ir_version"] = v
        elif f_no == 8 and wt == 2:
            domain, version = "", 0
            for ff, wwt, vv in _fields(v):
                if ff == 1 and wwt == 2:
                    domain = vv.decode("utf-8", "replace")
                elif ff == 2 and wwt == 0:
                    version = vv
            info["opsets"][domain] = version
        elif f_no == 7 and wt == 2:
            graph = v
    if graph is None:
        raise ValueError(f"{path}: no GraphProto (field 7) found")
    for f_no, wt, v in _fields(graph):
        if wt != 2:
            continue
        if f_no == 1:  # node
            info["num_nodes"] += 1
            for ff, wwt, vv in _fields(v):
                if ff == 4 and wwt == 2:
                    info["op_types"][vv.decode("utf-8", "replace")] += 1
        elif f_no == 5:  # initializer
            info["num_initializers"] += 1
        elif f_no == 11:
            info["inputs"].append(_value_info_name(v))
        elif f_no == 12:
            info["outputs"].append(_value_info_name(v))
    return info


def check_constant_folded(path: str, max_constant_nodes: int = 0) -> Dict:
    """Assert the artifact looks constant-folded (the reference Optimizer's
    postcondition): at most `max_constant_nodes` runtime Constant nodes —
    folded graphs carry constants as initializers instead. Returns the
    inspection dict for further checks."""
    info = inspect_onnx(path)
    n_const = info["op_types"].get("Constant", 0)
    if n_const > max_constant_nodes:
        raise AssertionError(
            f"{path}: {n_const} Constant nodes remain (> "
            f"{max_constant_nodes}); constant folding did not run")
    return info
