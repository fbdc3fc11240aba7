"""Pure-python/numpy evaluator for exported ONNX graphs (a copy of
fastervit_tpu/utils/onnx_eval.py) — closes the
reference's onnx_test.py:13-18 gap (run the exported artifact on real
inputs) in an image with no onnxruntime and no `onnx` package.

utils/onnx_inspect.py already decodes the protobuf wire format enough to
*count* things; this module decodes the rest (initializer tensors, node
attributes) and executes the graph with numpy, covering the op set
torch.onnx emits for the FasterViT family (Conv, Gemm/MatMul,
LayerNormalization, BatchNormalization, window reshape/transpose algebra,
Erf-GELU, Softmax, the dynamic-batch Shape/Gather/Concat chains, ...).

This is a *verification* evaluator: correctness and zero dependencies
over speed. The export carries a dynamic batch axis, so evaluating at a
batch size never seen at export time exercises the data-dependent shape
machinery the same way the reference's ORT smoke test exercises its
unseen 1024 resolution. tests/test_torch_export.py compares the evaluated
graph of `utils.export.export_onnx` against the port's logits.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from fastervit_tpu_torch.utils.onnx_inspect import _fields

_DTYPE = {1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16,
          5: np.int16, 6: np.int32, 7: np.int64, 9: np.bool_,
          10: np.float16, 11: np.float64, 12: np.uint32, 13: np.uint64}


def _varints(buf: bytes) -> List[int]:
    out, pos = [], 0
    while pos < len(buf):
        result = shift = 0
        while True:
            b = buf[pos]
            result |= (b & 0x7F) << shift
            pos += 1
            if not b & 0x80:
                break
            shift += 7
        out.append(result)
    return out


def _zigzag_ok(v: int) -> int:
    # proto int64 varints are two's-complement (not zigzag) for TensorProto
    return v - (1 << 64) if v >= (1 << 63) else v


def _decode_tensor(buf: bytes) -> np.ndarray:
    dims: List[int] = []
    dtype = 1
    raw = None
    floats: List[float] = []
    int32s: List[int] = []
    int64s: List[int] = []
    for f, wt, v in _fields(buf):
        if f == 1:
            dims.extend(_varints(v) if wt == 2 else [v])
        elif f == 2:
            dtype = v
        elif f == 4:   # float_data (packed)
            floats.extend(np.frombuffer(v, np.float32).tolist()
                          if wt == 2 else
                          [np.frombuffer(v, np.float32)[0]])
        elif f == 5:
            int32s.extend(_varints(v) if wt == 2 else [v])
        elif f == 7:
            int64s.extend(_varints(v) if wt == 2 else [v])
        elif f == 9:
            raw = v
    np_dtype = _DTYPE[dtype]
    if raw is not None:
        arr = np.frombuffer(raw, np_dtype)
    elif floats:
        arr = np.asarray(floats, np_dtype)
    elif int64s:
        arr = np.asarray([_zigzag_ok(x) for x in int64s], np_dtype)
    elif int32s:
        arr = np.asarray(int32s, np_dtype)
    else:
        arr = np.zeros(0, np_dtype)
    return arr.reshape(dims) if dims else (arr.reshape(()) if arr.size == 1
                                           else arr)


def _decode_attr(buf: bytes):
    name = None
    val = None
    ints: List[int] = []
    flts: List[float] = []
    for f, wt, v in _fields(buf):
        if f == 1:
            name = v.decode()
        elif f == 2:
            val = np.frombuffer(v, np.float32)[0]
        elif f == 3:
            val = _zigzag_ok(v)
        elif f == 4:
            val = v.decode(errors="replace")
        elif f == 5:
            val = _decode_tensor(v)
        elif f == 7:
            flts.extend(np.frombuffer(v, np.float32).tolist()
                        if wt == 2 else [np.frombuffer(v, np.float32)[0]])
        elif f == 8:
            ints.extend([_zigzag_ok(x) for x in _varints(v)]
                        if wt == 2 else [_zigzag_ok(v)])
    if ints:
        val = ints
    elif flts:
        val = flts
    return name, val


class Node:
    __slots__ = ("op", "inputs", "outputs", "attrs", "name")

    def __init__(self, buf: bytes):
        self.inputs: List[str] = []
        self.outputs: List[str] = []
        self.attrs: Dict[str, object] = {}
        self.op = ""
        self.name = ""
        for f, wt, v in _fields(buf):
            if f == 1:
                self.inputs.append(v.decode())
            elif f == 2:
                self.outputs.append(v.decode())
            elif f == 3:
                self.name = v.decode()
            elif f == 4:
                self.op = v.decode()
            elif f == 5:
                k, val = _decode_attr(v)
                self.attrs[k] = val


def _value_info_name(buf: bytes) -> str:
    for f, wt, v in _fields(buf):
        if f == 1:
            return v.decode()
    return ""


class OnnxGraph:
    def __init__(self, path: str):
        with open(path, "rb") as f:
            model = f.read()
        graph = None
        for f_, wt, v in _fields(model):
            if f_ == 7:
                graph = v
        if graph is None:
            raise ValueError("no GraphProto in model")
        self.nodes: List[Node] = []
        self.initializers: Dict[str, np.ndarray] = {}
        self.inputs: List[str] = []
        self.outputs: List[str] = []
        for f_, wt, v in _fields(graph):
            if f_ == 1:
                self.nodes.append(Node(v))
            elif f_ == 5:
                name = None
                for ff, _, vv in _fields(v):
                    if ff == 8:
                        name = vv.decode()
                self.initializers[name] = _decode_tensor(v)
            elif f_ == 11:
                self.inputs.append(_value_info_name(v))
            elif f_ == 12:
                self.outputs.append(_value_info_name(v))
        self.inputs = [n for n in self.inputs if n not in self.initializers]


def _conv(x, w, b, attrs):
    group = int(attrs.get("group", 1))
    kh, kw = w.shape[2], w.shape[3]
    sh, sw = attrs.get("strides", [1, 1])
    dh, dw = attrs.get("dilations", [1, 1])
    pads = attrs.get("pads", [0, 0, 0, 0])
    ph0, pw0, ph1, pw1 = pads
    xp = np.pad(x, ((0, 0), (0, 0), (ph0, ph1), (pw0, pw1)))
    n, c, hp, wp = xp.shape
    m = w.shape[0]
    cg = w.shape[1]
    ho = (hp - (dh * (kh - 1) + 1)) // sh + 1
    wo = (wp - (dw * (kw - 1) + 1)) // sw + 1
    out = np.zeros((n, m, ho, wo), np.float32)
    mg = m // group
    for g in range(group):
        xg = xp[:, g * cg:(g + 1) * cg]
        wg = w[g * mg:(g + 1) * mg].reshape(mg, -1)
        patches = [xg[:, :, i * dh:i * dh + ho * sh:sh,
                      j * dw:j * dw + wo * sw:sw]
                   for i in range(kh) for j in range(kw)]
        cols = np.stack(patches, 2).reshape(n, cg * kh * kw, ho * wo)
        out[:, g * mg:(g + 1) * mg] = (
            wg @ cols).reshape(n, mg, ho, wo) if n == 1 else np.einsum(
            "mk,nkp->nmp", wg, cols).reshape(n, mg, ho, wo)
    if b is not None:
        out = out + b.reshape(1, -1, 1, 1)
    return out.astype(np.float32)


def _avg_pool(x, attrs, global_pool=False):
    if global_pool:
        return x.mean(axis=(2, 3), keepdims=True).astype(x.dtype)
    kh, kw = attrs["kernel_shape"]
    sh, sw = attrs.get("strides", [kh, kw])
    pads = attrs.get("pads", [0, 0, 0, 0])
    assert not any(pads), "padded AveragePool not needed by this family"
    n, c, h, w = x.shape
    ho = (h - kh) // sh + 1
    wo = (w - kw) // sw + 1
    out = np.zeros((n, c, ho, wo), x.dtype)
    for i in range(kh):
        for j in range(kw):
            out += x[:, :, i:i + ho * sh:sh, j:j + wo * sw:sw]
    return out / (kh * kw)


try:
    from scipy.special import erf as _erf
except Exception:                                    # pragma: no cover
    _erf = np.vectorize(math.erf, otypes=[np.float32])


def _slice(env, node):
    data = env[node.inputs[0]]
    starts = env[node.inputs[1]].astype(np.int64)
    ends = env[node.inputs[2]].astype(np.int64)
    axes = (env[node.inputs[3]].astype(np.int64)
            if len(node.inputs) > 3 and node.inputs[3]
            else np.arange(len(starts)))
    steps = (env[node.inputs[4]].astype(np.int64)
             if len(node.inputs) > 4 and node.inputs[4]
             else np.ones(len(starts), np.int64))
    sl = [slice(None)] * data.ndim
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        sl[int(ax)] = slice(int(st), None if en >= 2**62 else int(en),
                            int(sp))
    return data[tuple(sl)]


def _pad(env, node):
    data = env[node.inputs[0]]
    pads = env[node.inputs[1]].astype(np.int64)
    mode = node.attrs.get("mode", "constant")
    cval = 0.0
    if len(node.inputs) > 2 and node.inputs[2]:
        cval = float(env[node.inputs[2]])
    nd = data.ndim
    pw = [(int(pads[i]), int(pads[i + nd])) for i in range(nd)]
    if mode == "constant":
        return np.pad(data, pw, constant_values=cval)
    return np.pad(data, pw, mode={"reflect": "reflect",
                                  "edge": "edge"}[mode])


def evaluate(graph: OnnxGraph, feeds: Dict[str, np.ndarray],
             stop_at: Optional[str] = None) -> Dict[str, np.ndarray]:
    """Execute the graph (nodes are topologically sorted per ONNX spec).
    Returns {output_name: array}."""
    env: Dict[str, np.ndarray] = dict(graph.initializers)
    env.update(feeds)
    env[""] = None
    for node in graph.nodes:
        op = node.op
        a = node.attrs
        x = [env[i] for i in node.inputs] if node.inputs else []
        if op == "Constant":
            out = a.get("value")
            if out is None:
                out = np.asarray(a.get("value_float",
                                       a.get("value_int")))
        elif op == "Identity":
            out = x[0]
        elif op == "Shape":
            out = np.asarray(x[0].shape, np.int64)
        elif op == "Reshape":
            shape = x[1].astype(np.int64).copy()
            for i, s in enumerate(shape):
                if s == 0 and not a.get("allowzero", 0):
                    shape[i] = x[0].shape[i]
            out = x[0].reshape([int(s) for s in shape])
        elif op == "Flatten":
            ax = int(a.get("axis", 1))
            out = x[0].reshape(int(np.prod(x[0].shape[:ax]) or 1), -1)
        elif op == "Transpose":
            out = x[0].transpose(a.get("perm"))
        elif op == "Unsqueeze":
            axes = (x[1].astype(np.int64).ravel().tolist()
                    if len(x) > 1 else a.get("axes"))
            out = x[0]
            for ax in sorted(int(v) for v in axes):
                out = np.expand_dims(out, ax)
        elif op == "Squeeze":
            axes = (x[1].astype(np.int64).ravel().tolist()
                    if len(x) > 1 else a.get("axes"))
            out = np.squeeze(x[0], axis=tuple(int(v) for v in axes))
        elif op == "Concat":
            out = np.concatenate([v for v in x], axis=int(a["axis"]))
        elif op == "Gather":
            out = np.take(x[0], x[1].astype(np.int64), axis=int(
                a.get("axis", 0)))
        elif op == "Cast":
            out = x[0].astype(_DTYPE[int(a["to"])])
        elif op == "Add":
            out = x[0] + x[1]
        elif op == "Sub":
            out = x[0] - x[1]
        elif op == "Mul":
            out = x[0] * x[1]
        elif op == "Div":
            out = x[0] / x[1]
        elif op == "Pow":
            out = x[0] ** x[1]
        elif op == "Sqrt":
            out = np.sqrt(x[0])
        elif op == "Erf":
            out = _erf(x[0].astype(np.float64)).astype(x[0].dtype)
        elif op == "Sigmoid":
            out = 1.0 / (1.0 + np.exp(-x[0]))
        elif op == "Relu":
            out = np.maximum(x[0], 0)
        elif op == "Equal":
            out = x[0] == x[1]
        elif op == "Where":
            out = np.where(x[0], x[1], x[2])
        elif op == "Expand":
            out = np.broadcast_to(
                x[0], np.broadcast_shapes(tuple(int(v) for v in x[1]),
                                          x[0].shape)).copy()
        elif op == "Range":
            out = np.arange(int(x[0]), int(x[1]), int(x[2]), np.int64)
        elif op == "ConstantOfShape":
            fill = a.get("value")
            fill_val = fill.ravel()[0] if fill is not None else 0.0
            dt = fill.dtype if fill is not None else np.float32
            out = np.full([int(v) for v in x[0]], fill_val, dt)
        elif op == "Softmax":
            ax = int(a.get("axis", -1))
            e = np.exp(x[0] - x[0].max(axis=ax, keepdims=True))
            out = e / e.sum(axis=ax, keepdims=True)
        elif op == "ReduceMean":
            axes = (tuple(int(v) for v in x[1].ravel())
                    if len(x) > 1 and x[1] is not None
                    else tuple(a.get("axes", range(x[0].ndim))))
            out = x[0].mean(axis=axes,
                            keepdims=bool(a.get("keepdims", 1)))
        elif op == "MatMul":
            out = np.matmul(x[0], x[1])
        elif op == "Gemm":
            va = x[0].T if a.get("transA") else x[0]
            vb = x[1].T if a.get("transB") else x[1]
            out = float(a.get("alpha", 1.0)) * (va @ vb)
            if len(x) > 2 and x[2] is not None:
                out = out + float(a.get("beta", 1.0)) * x[2]
        elif op == "LayerNormalization":
            ax = int(a.get("axis", -1))
            eps = float(a.get("epsilon", 1e-5))
            axes = tuple(range(ax % x[0].ndim, x[0].ndim))
            mu = x[0].mean(axis=axes, keepdims=True)
            var = x[0].var(axis=axes, keepdims=True)
            out = (x[0] - mu) / np.sqrt(var + eps)
            out = out * x[1] + (x[2] if len(x) > 2 else 0.0)
        elif op == "BatchNormalization":
            eps = float(a.get("epsilon", 1e-5))
            scale, bias, mean, var = x[1], x[2], x[3], x[4]
            shape = (1, -1) + (1,) * (x[0].ndim - 2)
            out = ((x[0] - mean.reshape(shape))
                   / np.sqrt(var.reshape(shape) + eps)
                   * scale.reshape(shape) + bias.reshape(shape))
        elif op == "Conv":
            out = _conv(x[0], x[1], x[2] if len(x) > 2 else None, a)
        elif op == "AveragePool":
            out = _avg_pool(x[0], a)
        elif op == "GlobalAveragePool":
            out = _avg_pool(x[0], a, global_pool=True)
        elif op == "Slice":
            out = _slice(env, node)
        elif op == "Pad":
            out = _pad(env, node)
        elif op == "Split":
            ax = int(a.get("axis", 0))
            if len(x) > 1 and x[1] is not None:
                sizes = np.cumsum(x[1].astype(np.int64))[:-1]
            else:
                sizes = len(node.outputs)
            parts = np.split(x[0], sizes, axis=ax)
            for name, part in zip(node.outputs, parts):
                env[name] = part
            continue
        else:
            raise NotImplementedError(
                f"op {op} (node {node.name}) — extend utils/onnx_eval.py")
        env[node.outputs[0]] = out
        if stop_at and node.outputs[0] == stop_at:
            break
    return {name: env[name] for name in graph.outputs if name in env}


def run_onnx(path: str, feeds: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return evaluate(OnnxGraph(path), feeds)
