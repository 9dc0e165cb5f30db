"""Checkpoint / resume (port of ``utils/checkpoint.py``) in the port's own
numpy format: the card's machine has no orbax.

The reference's model "checkpoints" are static ONNX files fetched at
startup (model.ts:12-67); per-stream state is reset on reload.  Here:

* :func:`save_params` / :func:`restore_params`: a tree (nested dicts, lists
  and tuples of numpy arrays, tensors and scalars; None leaves) <-> a
  directory holding one ``.npz`` of bridge.py::save_export's layout and
  nothing else.  A bf16 leaf is stored as its uint16 bits with a dtype
  tag and comes back bit for bit, as a bf16 tensor (numpy has no bf16);
* :func:`face_checkpoint_paths`: the reference's geometry-keyed names;
* :func:`save_engine` / :func:`restore_engine`: an Engine's trees, stream
  state and knobs, for a planned restart (cold start stays the documented
  recovery path: zero recurrent state, the EMA's first frame copied).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

import numpy as np
import torch

from video_stream_segmenetation_tpu_torch.bridge import SEP, load_export, save_export

PARAMS_FILE = "params.npz"
# the archive's entry that describes the tree: which leaves were bf16,
# tensors or None, which nodes were lists, tuples or empty dicts (by their
# SEP-joined paths)
META = "__tree__"


def _encode(tree, path: str, meta: dict):
    """``tree`` as nested dicts of numpy arrays (what bridge.save_export
    writes), what they cannot say recorded in ``meta``."""
    if isinstance(tree, (dict, list, tuple)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        if not isinstance(tree, dict):
            meta["seq"][path] = [type(tree).__name__, len(tree)]
        elif not tree:
            meta["empty"].append(path)
        out = {}
        for k, v in items:
            sub = f"{path}{SEP}{k}" if path else str(k)
            if v is None:
                meta["none"].append(sub)
            else:
                out[str(k)] = _encode(v, sub, meta)
        return out
    if not isinstance(tree, torch.Tensor):
        return np.asarray(tree)
    meta["torch"].append(path)
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        meta["bf16"].append(path)
        return t.view(torch.int16).numpy().view(np.uint16).copy()
    return t.numpy().copy()


def save_params(path: str, tree, overwrite: bool = True) -> None:
    """Write ``tree`` into the directory ``path`` (replaced if it exists and
    ``overwrite``; else FileExistsError)."""
    path = os.path.abspath(path)
    if os.path.exists(path):
        if not overwrite:
            raise FileExistsError(path)
        shutil.rmtree(path)
    os.makedirs(path)
    meta = {"seq": {}, "none": [], "torch": [], "bf16": [], "empty": []}
    encoded = _encode(tree, "", meta)
    encoded[META] = np.asarray(json.dumps(meta))
    save_export(os.path.join(path, PARAMS_FILE), encoded)


def _cast_like(leaf, like):
    """``leaf`` with the template leaf's dtype (and device, for a tensor)."""
    if isinstance(like, torch.Tensor):
        t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.asarray(leaf))
        return t.to(device=like.device, dtype=like.dtype)
    if isinstance(like, np.ndarray):
        a = leaf.float().numpy() if isinstance(leaf, torch.Tensor) else leaf
        return np.asarray(a).astype(like.dtype)
    return leaf


def _decode(node, path: str, meta: dict, like):
    """The tree :func:`_encode` made of ``node``, each leaf cast like
    ``like``'s where a template is given."""
    if not isinstance(node, dict):
        if path in meta["bf16"]:
            leaf = torch.from_numpy(node.view(np.int16).copy()).view(torch.bfloat16)
        elif path in meta["torch"]:
            leaf = torch.from_numpy(node.copy())
        else:
            leaf = node
        return leaf if like is None else _cast_like(leaf, like)
    kind, n = meta["seq"].get(path, (None, 0))
    if kind:
        keys = [str(i) for i in range(n)]
    else:  # the entries that have no leaf below them come from meta
        keys = list(node)
        for p in (*meta["seq"], *meta["empty"], *meta["none"]):
            head, _, k = p.rpartition(SEP)
            if head == path and k not in keys:
                keys.append(k)
    out = {}
    for k in keys:
        sub = f"{path}{SEP}{k}" if path else k
        if sub in meta["none"]:
            out[k] = None
            continue
        sub_like = None
        if isinstance(like, dict):
            sub_like = like.get(k)
        elif isinstance(like, (list, tuple)) and int(k) < len(like):
            sub_like = like[int(k)]
        out[k] = _decode(node.get(k, {}), sub, meta, sub_like)
    if kind is None:
        return out
    items = list(out.values())
    return tuple(items) if kind == "tuple" else items


def restore_params(path: str, like=None):
    """Read a tree :func:`save_params` wrote into ``path``.  Arrays come
    back as numpy arrays, tensors as CPU tensors (bf16 ones bit for bit),
    lists, tuples and None leaves as they were; with ``like`` (a template
    tree) each leaf takes its template leaf's dtype and, for a tensor, its
    device."""
    flat = load_export(os.path.join(os.path.abspath(path), PARAMS_FILE))
    meta = json.loads(str(flat.pop(META)))
    return _decode(flat, "", meta, like)


def face_checkpoint_paths(ckpt_dir: str, fd_size: int, lmk_size: int):
    """Geometry-keyed face checkpoint paths (tools/train_face.py naming:
    facefinder keyed by FD, landmarknet by LMK; no suffix at the
    reference geometry 256/192).  Returns (fd_path, lmk_path)."""
    fd_suf = "" if fd_size == 256 else f"_{fd_size}"
    lmk_suf = "" if lmk_size == 192 else f"_{lmk_size}"
    return (
        os.path.join(ckpt_dir, "facefinder" + fd_suf),
        os.path.join(ckpt_dir, "landmarknet" + lmk_suf),
    )


def save_engine(path: str, engine) -> None:
    """Snapshot an Engine: the trees its models are built from
    (``engine.params``), the stream state and the knobs."""
    whole, whole_knobs = engine.state, engine.knobs  # on a mesh each a gathered copy
    state = {f.name: getattr(whole, f.name) for f in dataclasses.fields(whole)}
    knobs = {f.name: getattr(whole_knobs, f.name) for f in dataclasses.fields(whole_knobs)}
    save_params(path, {"params": engine.params, "stream_state": state, "knobs": knobs})


def restore_engine(path: str, engine) -> None:
    """Restore a snapshot into an existing Engine of the same statics and
    stream count: its models rebuilt from the saved trees by the builders
    ``load_matting_params`` and ``load_face_params`` use, then the stream
    state and the knobs, on the engine's device in its dtypes.  A knob
    missing from the snapshot (one added after it was taken) restores at
    the engine's default."""
    from video_stream_segmenetation_tpu_torch.runtime.config import default_knobs
    from video_stream_segmenetation_tpu_torch.runtime.state import StreamState

    restored = restore_params(path)
    params = restored["params"]
    if params.get("face") is not None and params.get("lmk") is not None:
        engine._face_params = {"face": params["face"], "lmk": params["lmk"]}
    engine.face_models = engine._build_face_models()
    engine.load_matting_tree(params["matte"])  # the matting model, then the steps

    def like(saved, cur):
        return None if saved is None else _cast_like(saved, cur)

    ss = restored["stream_state"]
    fields = {}
    whole = engine.state  # on a mesh a gathered copy: read once
    for f in dataclasses.fields(whole):
        cur = getattr(whole, f.name)
        saved = ss.get(f.name)
        if f.name == "rec":
            # the model's state in the engine's own structure
            fields["rec"] = tuple(_cast_like(v, c) for v, c in zip(saved or (), cur))
        else:
            fields[f.name] = cur if cur is None else like(saved, cur)
    engine.state = StreamState(**fields)
    defaults = default_knobs(engine.num_streams, ema_adapt=engine.statics.ema_adapt_default,
                             device=engine.device)
    kn = {}
    for f in dataclasses.fields(defaults):
        saved = restored["knobs"].get(f.name)
        cur = getattr(defaults, f.name)
        kn[f.name] = cur if saved is None else _cast_like(saved, cur)
    engine.knobs = type(defaults)(**kn)
