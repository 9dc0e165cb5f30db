"""The numpy executor of utils/onnx_lite.py graphs (port of the
reference's ``utils/onnx_exec.py::run`` and its ``_np_*`` helpers).

:func:`run` executes a graph node by node in numpy (im2col convolutions,
ONNX's greedy NonMaxSuppression, the Resize coordinate modes): the
independent oracle that utils/onnx_exec.py::build_torch_fn is held against
(``face_parity.py``'s ``port_fidelity``, ``blaze_nms``).  It imports
neither torch nor JAX, so it runs where neither is installed.  Its op set
is the reference executor's: the face graphs' (Conv, Relu, PRelu, Add,
Mul, Div, MatMul, Sigmoid, Clip, MaxPool, Pad, Reshape, Transpose, Concat,
Gather, Squeeze, Unsqueeze, NonMaxSuppression) and the matting exports'
(Shape, Cast, Slice, Sub, Sqrt, Tanh, LeakyRelu, HardSigmoid, HardSwish,
Softmax, Flatten, GlobalAveragePool, AveragePool, ReduceMean,
BatchNormalization, Split, Resize).  The helpers that read a node's
attributes and the Resize coordinates are shared with
utils/onnx_exec.py.
"""

from __future__ import annotations

import numpy as np

from video_stream_segmenetation_tpu_torch.utils.onnx_lite import _DTYPES, Model, Node

# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------


def _conv_attrs(node: Node, default_spatial: int = 2):
    strides = tuple(node.attr("strides", [1] * default_spatial))
    dilations = tuple(node.attr("dilations", [1] * default_spatial))
    group = int(node.attr("group", 1) or 1)
    pads = node.attr("pads")
    kernel = node.attr("kernel_shape")
    return strides, dilations, group, pads, kernel


def _pair_pads(pads, ndim_sp=2):
    """ONNX pads [x0_begin, x1_begin, ..., x0_end, x1_end] -> per-axis."""
    if pads is None:
        return [(0, 0)] * ndim_sp
    half = len(pads) // 2
    return [(pads[i], pads[i + half]) for i in range(half)]


# ---------------------------------------------------------------------------
# NumPy oracle
# ---------------------------------------------------------------------------


def _np_conv(x, w, b, strides, dilations, group, pads):
    n, cin, h, wd = x.shape
    cout, cin_g, kh, kw = w.shape
    (pt, pb_), (pl, pr) = _pair_pads(pads)[0], _pair_pads(pads)[1]
    xp = np.pad(x, ((0, 0), (0, 0), (pt, pb_), (pl, pr)))
    sh, sw = strides
    dh, dw = dilations
    oh = (xp.shape[2] - (dh * (kh - 1) + 1)) // sh + 1
    ow = (xp.shape[3] - (dw * (kw - 1) + 1)) // sw + 1
    out = np.empty((n, cout, oh, ow), np.float32)
    cpg_out = cout // group
    for g in range(group):
        xg = xp[:, g * cin_g:(g + 1) * cin_g]
        wg = w[g * cpg_out:(g + 1) * cpg_out]
        # im2col: [n, cin_g*kh*kw, oh*ow]
        cols = np.empty((n, cin_g, kh, kw, oh, ow), np.float32)
        for i in range(kh):
            for j in range(kw):
                cols[:, :, i, j] = xg[
                    :, :,
                    i * dh:i * dh + oh * sh:sh,
                    j * dw:j * dw + ow * sw:sw,
                ]
        out[:, g * cpg_out:(g + 1) * cpg_out] = np.einsum(
            "ncijhw,ocij->nohw", cols, wg, optimize=True
        )
    if b is not None:
        out += b[None, :, None, None]
    return out


def _np_maxpool(x, kernel, strides, pads, ceil_mode=0):
    kh, kw = kernel
    sh, sw = strides
    (pt, pb_), (pl, pr) = _pair_pads(pads)[0], _pair_pads(pads)[1]
    xp = np.pad(
        x, ((0, 0), (0, 0), (pt, pb_), (pl, pr)),
        constant_values=-np.inf,
    )
    H, W = xp.shape[2], xp.shape[3]
    if ceil_mode:
        oh = -(-(H - kh) // sh) + 1
        ow = -(-(W - kw) // sw) + 1
        eh = (oh - 1) * sh + kh - H
        ew = (ow - 1) * sw + kw - W
        if eh > 0 or ew > 0:
            xp = np.pad(
                x, ((0, 0), (0, 0), (pt, pb_ + max(eh, 0)), (pl, pr + max(ew, 0))),
                constant_values=-np.inf,
            )
    else:
        oh = (H - kh) // sh + 1
        ow = (W - kw) // sw + 1
    out = np.full((x.shape[0], x.shape[1], oh, ow), -np.inf, np.float32)
    for i in range(kh):
        for j in range(kw):
            out = np.maximum(out, xp[:, :, i:i + oh * sh:sh, j:j + ow * sw:sw])
    return out


def _np_nms(boxes, scores, max_out, iou_thr, score_thr, center_box=0):
    """ONNX NonMaxSuppression.  center_box=1: boxes are (cx, cy, w, h)
    (the blaze.onnx convention); 0: corner format (either axis order —
    IoU is order-symmetric).

    boxes [num_batches, num_boxes, 4], scores
    [num_batches, num_classes, num_boxes].  Returns selected indices
    [K, 3] = (batch, class, box)."""
    if center_box:
        cx, cy, w, h = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
        boxes = np.stack(
            [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=-1
        )
    sel = []
    nb, _, _ = boxes.shape
    nc = scores.shape[1]
    for b in range(nb):
        for c in range(nc):
            s = scores[b, c]
            order = np.argsort(-s)
            order = order[s[order] > score_thr]
            kept: list[int] = []
            for idx in order:
                if len(kept) >= max_out:
                    break
                bx = boxes[b, idx]
                ok = True
                for kidx in kept:
                    kb = boxes[b, kidx]
                    yy0 = max(min(bx[0], bx[2]), min(kb[0], kb[2]))
                    xx0 = max(min(bx[1], bx[3]), min(kb[1], kb[3]))
                    yy1 = min(max(bx[0], bx[2]), max(kb[0], kb[2]))
                    xx1 = min(max(bx[1], bx[3]), max(kb[1], kb[3]))
                    inter = max(0.0, yy1 - yy0) * max(0.0, xx1 - xx0)
                    a1 = abs((bx[2] - bx[0]) * (bx[3] - bx[1]))
                    a2 = abs((kb[2] - kb[0]) * (kb[3] - kb[1]))
                    union = a1 + a2 - inter
                    if union > 0 and inter / union > iou_thr:
                        ok = False
                        break
                if ok:
                    kept.append(int(idx))
            sel.extend([(b, c, k) for k in kept])
    return np.asarray(sel, np.int64).reshape(-1, 3)


def run(model: Model, feeds: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Execute the graph with NumPy.  feeds: graph inputs by name."""
    g = model.graph
    vals: dict[str, np.ndarray] = dict(g.initializers)
    for name, _shape in g.inputs:
        if name not in feeds:
            raise ValueError(f"missing graph input {name!r}")
    vals.update({k: np.asarray(v) for k, v in feeds.items()})

    for node in g.nodes:
        i = [vals[n] if n else None for n in node.inputs]
        op = node.op_type
        if op == "Conv":
            strides, dil, group, pads, _ = _conv_attrs(node)
            out = _np_conv(i[0], i[1], i[2] if len(i) > 2 else None,
                           strides, dil, group, pads)
        elif op == "Relu":
            out = np.maximum(i[0], 0)
        elif op == "PRelu":
            slope = i[1]
            if slope.ndim == 3:  # [C,1,1] -> broadcast over NCHW
                slope = slope[None]
            elif slope.ndim == 1 and i[0].ndim == 4:
                slope = slope[None, :, None, None]
            out = np.where(i[0] >= 0, i[0], i[0] * slope)
        elif op == "Add":
            out = i[0] + i[1]
        elif op == "Mul":
            out = i[0] * i[1]
        elif op == "Div":
            out = i[0] / i[1]
        elif op == "MatMul":
            out = i[0] @ i[1]
        elif op == "Sigmoid":
            x = i[0]
            out = np.where(
                x >= 0,
                1.0 / (1.0 + np.exp(-np.clip(x, 0, None))),
                np.exp(np.clip(x, None, 0)) / (1.0 + np.exp(np.clip(x, None, 0))),
            )
        elif op == "Clip":
            lo = i[1] if len(i) > 1 and i[1] is not None else None
            hi = i[2] if len(i) > 2 and i[2] is not None else None
            out = np.clip(i[0],
                          -np.inf if lo is None else lo,
                          np.inf if hi is None else hi)
        elif op == "MaxPool":
            strides, _dil, _grp, pads, kernel = _conv_attrs(node)
            out = _np_maxpool(i[0], kernel, strides, pads,
                              int(node.attr("ceil_mode", 0) or 0))
        elif op == "Pad":
            mode = node.attr("mode", b"constant")
            pads = (np.asarray(i[1]).tolist() if len(i) > 1 and i[1] is not None
                    else node.attr("pads"))
            cval = float(np.asarray(i[2])) if len(i) > 2 and i[2] is not None else 0.0
            nd = i[0].ndim
            pp = [(int(pads[k]), int(pads[k + nd])) for k in range(nd)]
            if mode in (b"constant", "constant", None):
                out = np.pad(i[0], pp, constant_values=cval)
            elif mode in (b"reflect", "reflect"):
                out = np.pad(i[0], pp, mode="reflect")
            else:
                out = np.pad(i[0], pp, mode="edge")
        elif op == "Reshape":
            shape = [int(s) for s in np.asarray(i[1])]
            shape = [i[0].shape[k] if s == 0 else s for k, s in enumerate(shape)]
            out = i[0].reshape(shape)
        elif op == "Transpose":
            out = np.transpose(i[0], node.attr("perm"))
        elif op == "Concat":
            out = np.concatenate([x for x in i], axis=int(node.attr("axis", 0)))
        elif op == "Gather":
            out = np.take(i[0], np.asarray(i[1], np.int64),
                          axis=int(node.attr("axis", 0) or 0))
        elif op == "Squeeze":
            axes = (tuple(int(a) for a in np.asarray(i[1]))
                    if len(i) > 1 and i[1] is not None
                    else node.attr("axes"))
            out = np.squeeze(i[0], axis=tuple(axes) if axes else None)
        elif op == "Unsqueeze":
            axes = (tuple(int(a) for a in np.asarray(i[1]))
                    if len(i) > 1 and i[1] is not None
                    else tuple(node.attr("axes")))
            out = i[0]
            for a in sorted(axes):
                out = np.expand_dims(out, a)
        elif op == "NonMaxSuppression":
            boxes, scores = i[0], i[1]
            max_out = int(np.asarray(i[2]).reshape(-1)[0]) if len(i) > 2 and i[2] is not None else 2**31
            iou_thr = float(np.asarray(i[3]).reshape(-1)[0]) if len(i) > 3 and i[3] is not None else 0.0
            score_thr = float(np.asarray(i[4]).reshape(-1)[0]) if len(i) > 4 and i[4] is not None else -np.inf
            out = _np_nms(boxes, scores, max_out, iou_thr, score_thr,
                          int(node.attr("center_point_box", 0) or 0))
        elif op == "Shape":
            out = np.asarray(i[0].shape, np.int64)
        elif op == "Cast":
            out = i[0].astype(_onnx_dtype(int(node.attr("to"))))
        elif op == "Slice":
            out = _np_slice(i)
        elif op == "Sub":
            out = i[0] - i[1]
        elif op == "Sqrt":
            out = np.sqrt(i[0])
        elif op == "Tanh":
            out = np.tanh(i[0])
        elif op == "LeakyRelu":
            al = float(node.attr("alpha", 0.01) or 0.01)
            out = np.where(i[0] >= 0, i[0], al * i[0])
        elif op == "HardSigmoid":
            al = node.attr("alpha")
            be = node.attr("beta")
            al = 0.2 if al is None else float(al)
            be = 0.5 if be is None else float(be)
            out = np.clip(al * i[0] + be, 0.0, 1.0)
        elif op == "HardSwish":
            out = i[0] * np.clip(i[0] / 6.0 + 0.5, 0.0, 1.0)
        elif op == "Softmax":
            ax = node.attr("axis")
            ax = -1 if ax is None else int(ax)
            e = np.exp(i[0] - i[0].max(axis=ax, keepdims=True))
            out = e / e.sum(axis=ax, keepdims=True)
        elif op == "Flatten":
            ax = int(node.attr("axis", 1) or 1)
            out = i[0].reshape(int(np.prod(i[0].shape[:ax], initial=1)), -1)
        elif op == "GlobalAveragePool":
            out = i[0].mean(axis=tuple(range(2, i[0].ndim)), keepdims=True)
        elif op == "AveragePool":
            strides, _d, _g2, pads, kernel = _conv_attrs(node)
            out = _np_avgpool(
                i[0], kernel, strides, pads,
                int(node.attr("count_include_pad", 0) or 0),
            )
        elif op == "ReduceMean":
            axes = node.attr("axes")
            if axes is None and len(i) > 1 and i[1] is not None:
                axes = [int(a) for a in np.asarray(i[1])]
            kd = int(node.attr("keepdims", 1))
            kd = bool(1 if kd is None else kd)
            out = i[0].mean(axis=tuple(axes) if axes else None, keepdims=kd)
        elif op == "BatchNormalization":
            x, sc, bb, mean, var = i[:5]
            eps = node.attr("epsilon")
            eps = 1e-5 if eps is None else float(eps)
            shp = [1, -1] + [1] * (x.ndim - 2)
            out = (
                sc.reshape(shp) * (x - mean.reshape(shp))
                / np.sqrt(var.reshape(shp) + eps) + bb.reshape(shp)
            )
        elif op == "Split":
            ax = int(node.attr("axis", 0) or 0)
            sp = node.attr("split")
            if sp is None and len(i) > 1 and i[1] is not None:
                sp = [int(s) for s in np.asarray(i[1])]
            if sp is None:
                kk = len(node.outputs)
                sp = [i[0].shape[ax] // kk] * kk
            out = np.split(i[0], np.cumsum(sp)[:-1].tolist(), axis=ax)
        elif op == "Resize":
            out = _np_resize(i, node)
        else:
            raise NotImplementedError(f"op {op} ({node.name})")
        for k, name in enumerate(node.outputs):
            vals[name] = out if len(node.outputs) == 1 else out[k]
    return {name: vals[name] for name in g.outputs}


def _onnx_dtype(code: int):
    return _DTYPES[code]


def _np_avgpool(x, kernel, strides, pads, count_include_pad):
    n, c, h, w = x.shape
    pp = _pair_pads(pads)
    xp = np.pad(x, ((0, 0), (0, 0), pp[0], pp[1]))
    ones = np.pad(np.ones((h, w), x.dtype), pp)
    kh, kw = kernel
    sh, sw = strides
    oh = (xp.shape[2] - kh) // sh + 1
    ow = (xp.shape[3] - kw) // sw + 1
    out = np.zeros((n, c, oh, ow), x.dtype)
    cnt = np.zeros((oh, ow), x.dtype)
    for dy in range(kh):
        for dx in range(kw):
            out += xp[:, :, dy:dy + sh * oh:sh, dx:dx + sw * ow:sw]
            cnt += ones[dy:dy + sh * oh:sh, dx:dx + sw * ow:sw]
    if count_include_pad:
        return out / float(kh * kw)
    return out / np.maximum(cnt, 1.0)


def _resize_axis(n_in: int, n_out: int, coord: str):
    """Per-axis source coordinates for ONNX Resize (float positions)."""
    xo = np.arange(n_out, dtype=np.float64)
    scale = n_out / n_in
    if coord in ("align_corners",):
        if n_out == 1:
            return np.zeros(1)
        return xo * (n_in - 1) / (n_out - 1)
    if coord in ("asymmetric",):
        return xo / scale
    if coord in ("pytorch_half_pixel",):
        if n_out == 1:
            return np.zeros(1)
        return (xo + 0.5) / scale - 0.5
    # default: half_pixel
    return (xo + 0.5) / scale - 0.5


def _resize_params(node, i, ndim):
    """Resolve (out_sizes, mode, coord, nearest_mode) from a Resize node.
    opset-10 form (X, scales) and opset-11+ (X, roi, scales, sizes)."""
    mode = node.attr("mode", b"nearest")
    mode = mode.decode() if isinstance(mode, bytes) else (mode or "nearest")
    coord = node.attr("coordinate_transformation_mode", b"half_pixel")
    coord = coord.decode() if isinstance(coord, bytes) else (coord or "half_pixel")
    nearest_mode = node.attr("nearest_mode", b"round_prefer_floor")
    nearest_mode = (nearest_mode.decode() if isinstance(nearest_mode, bytes)
                    else (nearest_mode or "round_prefer_floor"))
    x = i[0]
    sizes = None
    if len(i) > 3 and i[3] is not None:
        sizes = [int(s) for s in np.asarray(i[3])]
    else:
        scales_idx = 2 if len(i) > 2 else 1
        scales = np.asarray(i[scales_idx]).reshape(-1)
        if scales.size:
            sizes = [int(np.floor(x.shape[k] * scales[k])) for k in range(ndim)]
    if sizes is None:
        raise NotImplementedError("Resize: neither scales nor sizes given")
    return sizes, mode, coord, nearest_mode


def _nearest_idx(src: np.ndarray, n_in: int, nearest_mode: str):
    if nearest_mode == "floor":
        idx = np.floor(src)
    elif nearest_mode == "ceil":
        idx = np.ceil(src)
    elif nearest_mode == "round_prefer_ceil":
        idx = np.floor(src + 0.5)
    else:  # round_prefer_floor
        idx = np.ceil(src - 0.5)
    return np.clip(idx, 0, n_in - 1).astype(np.int64)


def _linear_taps(src: np.ndarray, n_in: int):
    i0 = np.clip(np.floor(src), 0, n_in - 1).astype(np.int64)
    i1 = np.clip(i0 + 1, 0, n_in - 1)
    w1 = np.clip(src - np.floor(src), 0.0, 1.0)
    # when src < 0 the ONNX reference clamps coordinates (extrapolation
    # weight still uses the fractional part of the clamped position)
    w1 = np.where(src < 0, 0.0, np.where(src > n_in - 1, 1.0, w1))
    return i0, i1, w1


def _np_resize(i, node):
    """ONNX Resize on the 2 trailing (spatial) axes of an NCHW tensor --
    the form every matting/face model in scope uses (the reference's own
    patch.py rewrites exactly these attrs: mode/coords/rounding,
    client/src/patch.py:35-50)."""
    x = i[0]
    sizes, mode, coord, nearest_mode = _resize_params(node, i, x.ndim)
    oh, ow = sizes[-2], sizes[-1]
    h, w = x.shape[-2], x.shape[-1]
    if list(sizes[:-2]) != list(x.shape[:-2]):
        raise NotImplementedError("Resize on non-spatial axes")
    sy = _resize_axis(h, oh, coord)
    sx = _resize_axis(w, ow, coord)
    if mode == "nearest":
        yi = _nearest_idx(sy, h, nearest_mode)
        xi = _nearest_idx(sx, w, nearest_mode)
        return x[..., yi, :][..., xi]
    if mode != "linear":
        raise NotImplementedError(f"Resize mode {mode}")
    y0, y1, wy = _linear_taps(sy, h)
    x0, x1, wx = _linear_taps(sx, w)
    top = x[..., y0, :] * (1 - wy)[..., :, None] + x[..., y1, :] * wy[..., :, None]
    return (
        top[..., x0] * (1 - wx) + top[..., x1] * wx
    ).astype(x.dtype, copy=False)


def _np_slice(i):
    data = i[0]
    starts = np.asarray(i[1]).tolist()
    ends = np.asarray(i[2]).tolist()
    axes = (np.asarray(i[3]).tolist() if len(i) > 3 and i[3] is not None
            else list(range(len(starts))))
    steps = (np.asarray(i[4]).tolist() if len(i) > 4 and i[4] is not None
             else [1] * len(starts))
    sl = [slice(None)] * data.ndim
    for s, e, a, st in zip(starts, ends, axes, steps):
        sl[a] = slice(s, e, st)
    return data[tuple(sl)]
