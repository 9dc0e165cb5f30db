"""Graph executor for utils/onnx_lite.py models on torch (port of
``utils/onnx_exec.py::build_jax_fn``); :func:`run` is the numpy executor
of utils/onnx_numpy.py (the reference's ``run``), the oracle it is held to.

:func:`build_torch_fn` compiles a graph into ``fn(params, **inputs) ->
dict`` that runs the nodes with torch ops on the inputs' device.  It covers
the reference executor's op set: the face graphs' (Conv, Relu, PRelu, Add,
Mul, Div, MatMul, Sigmoid, Clip, MaxPool, Pad, Reshape, Transpose, Concat,
Gather, Squeeze, Unsqueeze, NonMaxSuppression) and the matting exports'
(Cast, Shape, Slice, Sub, Sqrt, Tanh, LeakyRelu, HardSigmoid, HardSwish,
Softmax, Flatten, GlobalAveragePool, AveragePool, ReduceMean,
BatchNormalization, Split, Resize).  An op outside it raises when the
graph is built.

Nothing in a call reads back from the device: the shape-like operands
(``Reshape`` shapes, ``Pad`` pads and value, ``Clip`` bounds, ``Slice``
bounds, axes, split sizes, the NMS thresholds) are read from the
initializers once, at build time (an operand made at run time by a
``Shape`` chain is a host array too), and the resize taps are host
constants copied once per geometry (ops/consts.py::device_const).  The
weights go to the device once, at build.  NonMaxSuppression becomes a
fixed-capacity greedy select (ops/detect.py::nms_padded) whose output
carries a ``<name>__valid`` mask beside it, as the reference's does.

Graphs exported for batch 1 run on a batch: a ``Reshape`` whose target
starts with a constant 1 keeps the input's leading axis instead, so K
images go through as one ``[K, ...]`` batch (the face graphs reshape only
per-image activations).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from video_stream_segmenetation_tpu_torch.ops.consts import device_const
from video_stream_segmenetation_tpu_torch.ops.detect import nms_padded
from video_stream_segmenetation_tpu_torch.utils.onnx_lite import _DTYPES, Model, Node
from video_stream_segmenetation_tpu_torch.utils.onnx_numpy import (  # noqa: F401 (run)
    _conv_attrs,
    _linear_taps,
    _nearest_idx,
    _pair_pads,
    _resize_axis,
    run,
)

_TORCH_DTYPES = {
    np.float32: torch.float32, np.uint8: torch.uint8, np.int8: torch.int8,
    np.int16: torch.int16, np.int32: torch.int32, np.int64: torch.int64,
    np.bool_: torch.bool, np.float16: torch.float16, np.float64: torch.float64,
}


def _text(node: Node, key: str, default: str) -> str:
    v = node.attr(key, default.encode())
    return v.decode() if isinstance(v, bytes) else (v or default)


class _Static:
    """Operand ``k`` of a node that must be known on the host: an
    initializer (read at build time), absent (None), or a host array made
    at run time (a ``Shape`` chain); a device tensor is refused."""

    def __init__(self, node: Node, k: int, consts: dict):
        self.node, self.k = node, k
        self.absent = k >= len(node.inputs) or not node.inputs[k]
        self.value = None if self.absent else consts.get(node.inputs[k])

    def __call__(self, i):
        if self.absent or self.value is not None:
            return self.value
        v = i[self.k]
        if isinstance(v, np.ndarray):
            return v
        raise NotImplementedError(f"{self.node.op_type} ({self.node.name}): operand "
                                  f"{self.node.inputs[self.k]!r} must be static")


def _ints(v):
    return None if v is None else [int(a) for a in np.asarray(v).reshape(-1)]


def _take(x: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """``jnp.take(x, idx, axis)`` for any index shape, negative indices
    counted from the end."""
    axis = axis % x.ndim
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    out = torch.index_select(x, axis, idx.reshape(-1))
    return out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])


def _compile(node: Node, consts: dict, nms_capacity: int):
    """The node's ``run(inputs) -> output`` (a tuple for several outputs;
    NonMaxSuppression: ``(indices, valid)``).  Raises for an op outside
    the set."""
    op = node.op_type
    if op == "Conv":
        strides, dil, group, pads, _ = _conv_attrs(node)
        w_init = consts.get(node.inputs[1])
        if w_init is not None and w_init.ndim != 4:
            raise NotImplementedError(f"Conv ({node.name}): {w_init.ndim - 2}-D; the "
                                      "executor runs 2-D convolutions")
        (pt, pb), (pl, pr) = _pair_pads(pads)

        def run(i):
            x = i[0].to(torch.float32)
            if (pt, pl) != (pb, pr):
                x = F.pad(x, (pl, pr, pt, pb))
                pad = (0, 0)
            else:
                pad = (pt, pl)
            b = i[2] if len(i) > 2 and i[2] is not None else None
            return F.conv2d(x, i[1].to(torch.float32), b, strides, pad, dil, group)
        return run
    if op == "Relu":
        return lambda i: torch.clamp(i[0], min=0)
    if op == "PRelu":
        def run(i):
            slope = i[1]
            if slope.ndim == 3:
                slope = slope[None]
            elif slope.ndim == 1 and i[0].ndim == 4:
                slope = slope[None, :, None, None]
            return torch.where(i[0] >= 0, i[0], i[0] * slope)
        return run
    if op in ("Add", "Sub", "Mul", "Div", "MatMul"):
        f = {"Add": torch.add, "Sub": torch.sub, "Mul": torch.mul, "Div": torch.div,
             "MatMul": torch.matmul}[op]
        return lambda i: f(i[0], i[1])
    if op in ("Sigmoid", "Sqrt", "Tanh"):
        f = {"Sigmoid": torch.sigmoid, "Sqrt": torch.sqrt, "Tanh": torch.tanh}[op]
        return lambda i: f(i[0])
    if op == "Clip":
        bounds = [_Static(node, k, consts) for k in (1, 2)]

        def bound(b, i):
            if b.absent:
                return None
            if b.value is not None:
                return float(np.asarray(b.value).reshape(()))
            return i[b.k]
        return lambda i: torch.clamp(i[0], bound(bounds[0], i), bound(bounds[1], i))
    if op == "MaxPool":
        strides, _d, _g, pads, kernel = _conv_attrs(node)
        pp = _pair_pads(pads)
        ceil = int(node.attr("ceil_mode", 0) or 0)

        def run(i):
            x = i[0]
            (t, b), (l, r) = pp
            if ceil:  # extend the end padding so the window count rounds up
                hh, ww = x.shape[2] + t + b, x.shape[3] + l + r
                oh = -(-(hh - kernel[0]) // strides[0]) + 1
                ow = -(-(ww - kernel[1]) // strides[1]) + 1
                b += max(0, (oh - 1) * strides[0] + kernel[0] - hh)
                r += max(0, (ow - 1) * strides[1] + kernel[1] - ww)
            if t or b or l or r:
                x = F.pad(x, (l, r, t, b), value=float("-inf"))
            return F.max_pool2d(x, tuple(kernel), tuple(strides))
        return run
    if op == "Pad":
        spads, scval = _Static(node, 1, consts), _Static(node, 2, consts)
        mode = _text(node, "mode", "constant")
        if mode not in ("constant", "reflect", "edge"):
            raise NotImplementedError(f"Pad ({node.name}): mode {mode!r}")

        def run(i):
            pads = _ints(spads(i))
            if pads is None:
                pads = node.attr("pads")
            cv = scval(i)
            nd = i[0].ndim
            flat = []
            for a in reversed(range(nd)):
                flat += [int(pads[a]), int(pads[a + nd])]
            if mode == "constant":
                return F.pad(i[0], flat, value=0.0 if cv is None else float(np.asarray(cv)))
            if any(flat[4:]):
                raise NotImplementedError(f"Pad ({node.name}): {mode} on a leading axis")
            return F.pad(i[0], flat[:4], mode="reflect" if mode == "reflect" else "replicate")
        return run
    if op == "Reshape":
        sshape = _Static(node, 1, consts)

        def run(i):
            x = i[0]
            shape = [x.shape[k] if s == 0 else s for k, s in enumerate(_ints(sshape(i)))]
            if shape and shape[0] == 1:
                shape[0] = x.shape[0]  # a batch-1 export's leading axis: the batch
            return x.reshape(shape)
        return run
    if op == "Transpose":
        perm = node.attr("perm")
        return lambda i: i[0].permute(perm if perm is not None
                                      else list(reversed(range(i[0].ndim))))
    if op == "Concat":
        axis = int(node.attr("axis", 0))
        return lambda i: torch.cat(list(i), dim=axis)
    if op == "Gather":
        axis = int(node.attr("axis", 0) or 0)
        return lambda i: _take(i[0], i[1], axis)
    if op in ("Squeeze", "Unsqueeze"):
        saxes = _Static(node, 1, consts)

        def axes_of(i):
            a = _ints(saxes(i))
            return a if a is not None else node.attr("axes")
        if op == "Squeeze":
            def run(i):
                axes = axes_of(i)
                x = i[0]
                if not axes:
                    return x.squeeze()
                keep = [d for k, d in enumerate(x.shape)
                        if k not in {a % x.ndim for a in axes}]
                return x.reshape(keep)
            return run

        def run(i):
            out = i[0]
            for a in sorted(axes_of(i)):
                out = out.unsqueeze(a)
            return out
        return run
    if op == "NonMaxSuppression":
        center = int(node.attr("center_point_box", 0) or 0)
        thr = {k: _Static(node, k, consts) for k in (3, 4)}

        def threshold(k, i, default):
            st = thr[k]
            if st.absent:
                return default
            v = st.value if st.value is not None else i[k]
            if isinstance(v, torch.Tensor):  # a graph input: compared on the device
                return v.reshape(())
            return float(np.asarray(v).reshape(()))

        def run(i):
            boxes, scores = i[0], i[1]
            if center:
                cx, cy, w, h = boxes.unbind(-1)
                boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
            idx, valid = nms_padded(boxes[0], scores[0, 0], nms_capacity,
                                    threshold(3, i, 0.0), threshold(4, i, float("-inf")))
            zeros = torch.zeros((nms_capacity, 1), dtype=torch.int32, device=idx.device)
            return torch.cat([zeros, zeros, idx[:, None]], dim=1), valid
        return run
    if op == "Cast":
        np_dtype = _DTYPES[int(node.attr("to"))]
        dtype = _TORCH_DTYPES.get(np_dtype)
        if dtype is None:
            raise NotImplementedError(f"Cast ({node.name}): to {np_dtype.__name__}")

        def run(i):
            x = i[0]
            return x.astype(np_dtype) if isinstance(x, np.ndarray) else x.to(dtype)
        return run
    if op == "Shape":
        return lambda i: np.asarray(tuple(i[0].shape), np.int64)
    if op == "Slice":
        st = {k: _Static(node, k, consts) for k in (1, 2, 3, 4)}
        if st[4].value is not None and np.any(np.asarray(st[4].value) <= 0):
            raise NotImplementedError(f"Slice ({node.name}): steps must be positive")

        def run(i):
            starts, ends = _ints(st[1](i)), _ints(st[2](i))
            axes = _ints(st[3](i)) or list(range(len(starts)))
            steps = _ints(st[4](i)) or [1] * len(starts)
            sl = [slice(None)] * i[0].ndim
            for s0, e0, ax, sp in zip(starts, ends, axes, steps):
                sl[ax] = slice(s0, e0, sp)
            return i[0][tuple(sl)]
        return run
    if op == "LeakyRelu":
        al = float(node.attr("alpha", 0.01) or 0.01)
        return lambda i: torch.where(i[0] >= 0, i[0], al * i[0])
    if op == "HardSigmoid":
        al, be = node.attr("alpha"), node.attr("beta")
        al = 0.2 if al is None else float(al)
        be = 0.5 if be is None else float(be)
        return lambda i: torch.clamp(al * i[0] + be, 0.0, 1.0)
    if op == "HardSwish":
        return lambda i: i[0] * torch.clamp(i[0] / 6.0 + 0.5, 0.0, 1.0)
    if op == "Softmax":
        ax = node.attr("axis")
        ax = -1 if ax is None else int(ax)
        return lambda i: torch.softmax(i[0], dim=ax)
    if op == "Flatten":
        ax = int(node.attr("axis", 1) or 1)

        def run(i):
            lead = 1
            for d in i[0].shape[:ax]:
                lead *= d
            return i[0].reshape(lead, -1)
        return run
    if op == "GlobalAveragePool":
        return lambda i: i[0].mean(dim=tuple(range(2, i[0].ndim)), keepdim=True)
    if op == "AveragePool":
        strides, _d, _g, pads, kernel = _conv_attrs(node)
        (t, b), (l, r) = _pair_pads(pads)
        icp = int(node.attr("count_include_pad", 0) or 0)

        def window_sum(x):
            return F.avg_pool2d(F.pad(x, (l, r, t, b)), tuple(kernel), tuple(strides),
                                divisor_override=1)

        def run(i):
            summed = window_sum(i[0])
            if icp:
                return summed / float(kernel[0] * kernel[1])
            ones = torch.ones((1, 1) + tuple(i[0].shape[-2:]), dtype=i[0].dtype,
                              device=i[0].device)
            return summed / torch.clamp(window_sum(ones), min=1.0)
        return run
    if op == "ReduceMean":
        saxes = _Static(node, 1, consts)
        kd = node.attr("keepdims")
        kd = bool(1 if kd is None else int(kd))

        def run(i):
            axes = node.attr("axes")
            if axes is None:
                axes = _ints(saxes(i))
            if not axes:
                return i[0].mean().reshape([1] * i[0].ndim if kd else [])
            return i[0].mean(dim=tuple(axes), keepdim=kd)
        return run
    if op == "BatchNormalization":
        eps = node.attr("epsilon")
        eps = 1e-5 if eps is None else float(eps)

        def run(i):
            x, sc, bb, mean, var = i[:5]
            shp = [1, -1] + [1] * (x.ndim - 2)
            return (sc.reshape(shp) * (x - mean.reshape(shp))
                    / torch.sqrt(var.reshape(shp) + eps) + bb.reshape(shp))
        return run
    if op == "Split":
        ax = int(node.attr("axis", 0) or 0)
        ssp = _Static(node, 1, consts)

        def run(i):
            sp = node.attr("split")
            if sp is None:
                sp = _ints(ssp(i))
            if sp is None:
                kk = len(node.outputs)
                sp = [i[0].shape[ax] // kk] * kk
            return torch.split(i[0], [int(s) for s in sp], dim=ax)
        return run
    if op == "Resize":
        mode = _text(node, "mode", "nearest")
        coord = _text(node, "coordinate_transformation_mode", "half_pixel")
        nearest_mode = _text(node, "nearest_mode", "round_prefer_floor")
        if mode not in ("nearest", "linear"):
            raise NotImplementedError(f"Resize ({node.name}): mode {mode!r}")
        st = {k: _Static(node, k, consts) for k in range(1, len(node.inputs))}

        def sizes_of(i):
            x = i[0]
            if len(node.inputs) > 3 and not st[3].absent:
                return _ints(st[3](i))
            scales = np.asarray(st[2 if len(node.inputs) > 2 else 1](i)).reshape(-1)
            if not scales.size:
                raise NotImplementedError("Resize: neither scales nor sizes given")
            return [int(np.floor(x.shape[k] * scales[k])) for k in range(x.ndim)]

        def run(i):
            x = i[0]
            oh, ow = sizes_of(i)[-2:]
            h, w = x.shape[-2], x.shape[-1]
            key = ("onnx_resize", mode, coord, nearest_mode, h, w, oh, ow)

            def taps(n_in, n_out, part):
                src = _resize_axis(n_in, n_out, coord)
                if mode == "nearest":
                    return _nearest_idx(src, n_in, nearest_mode)
                i0, i1, w1 = _linear_taps(src, n_in)
                return (i0, i1, w1.astype(np.float32),
                        (1 - w1).astype(np.float32))[part]

            def const(axis, part):
                n_in, n_out = (h, oh) if axis == 0 else (w, ow)
                return device_const(key + (axis, part), x.device,
                                    lambda: taps(n_in, n_out, part))
            if mode == "nearest":
                return torch.index_select(torch.index_select(x, -2, const(0, 0)), -1,
                                          const(1, 0))
            top = (torch.index_select(x, -2, const(0, 0)) * const(0, 3)[:, None]
                   + torch.index_select(x, -2, const(0, 1)) * const(0, 2)[:, None])
            return (torch.index_select(top, -1, const(1, 0)) * const(1, 3)
                    + torch.index_select(top, -1, const(1, 1)) * const(1, 2))
        return run
    raise NotImplementedError(f"op {op} ({node.name})")


def build_torch_fn(model: Model, nms_capacity: int = 16, device="cpu"):
    """Compile the graph into ``fn(params, **inputs) -> dict`` (the graph's
    outputs by name; a NonMaxSuppression output also ``<name>__valid``).
    Returns ``(fn, params)``: params are the initializers as tensors on
    ``device``, moved there once.  Raises NotImplementedError for an op
    outside the set."""
    g = model.graph
    consts = dict(g.initializers)
    params = {k: torch.as_tensor(np.array(v), device=device) for k, v in consts.items()}
    steps = [(node, _compile(node, consts, nms_capacity)) for node in g.nodes]

    def fn(p, **feeds):
        vals = dict(p)
        vals.update(feeds)
        for node, run in steps:
            out = run([vals[n] if n else None for n in node.inputs])
            if node.op_type == "NonMaxSuppression":
                out, vals[node.outputs[0] + "__valid"] = out
            if len(node.outputs) == 1:
                vals[node.outputs[0]] = out
            else:
                for k, name in enumerate(node.outputs):
                    vals[name] = out[k]
        res = {name: vals[name] for name in g.outputs}
        for name in g.outputs:
            if name + "__valid" in vals:
                res[name + "__valid"] = vals[name + "__valid"]
        return res

    return fn, params
