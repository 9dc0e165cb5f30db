"""Weight bridge from the JAX package's parameters, as numpy trees, and the
loader of the committed exports.

The machine with the card has no JAX, flax or orbax, so nothing here reads
a checkpoint.  A caller that has the reference restores its checkpoint
there and hands the arrays over as nested dicts of numpy arrays; the
trained weights the port serves on the card are committed as numpy
archives under ``weights/`` (written by ``tests/test_torch_weights.py::
export``, which restores the checkpoints with the reference).

* :func:`params_from_jax`: the reference's float MatteNetHD tree
  (``{"params", "batch_stats"}``) -> the port's int8 serving dict, through
  the port's own quantizer.
* :func:`load_quantized`: the reference's already-quantized dict
  (``quantize_mattenet_hd`` output) -> the same serving dict.
* :func:`load_quantized_face`: the reference's quantized FaceFinder or
  LandmarkNet dict (``models/quantized_face.py``) -> the dict the port's
  int8 face models (models/quantized_face.py) take.
* :func:`float_tree`: a reference flax float tree (MatteNet, with one
  class or K, RecurrentMatteNet, SaliencyNet, the float MatteNetHD at any
  plan and K, FaceFinder, LandmarkNet) -> the numpy tree the port's float
  models load.
* :func:`load_export` / :func:`save_export`: one tree <-> one ``.npz``
  (``np.load(..., allow_pickle=False)``; numpy is all they need).
* :func:`trained_weights`: the committed trained weights a preset serves,
  as ``Engine(params=..., face_params=...)`` takes them (a KeyError names
  the checkpoint of a float MatteNetHD form with no committed export).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from video_stream_segmenetation_tpu_torch.models.quantized import quantize_mattenet_hd

WEIGHTS_DIR = Path(__file__).resolve().parent / "weights"
# separates the levels of a nested dict in an export's array names (the
# serving dict's own keys hold '/')
SEP = ":"
# quantized-dict entries the port does not serve: the int8 det head and
# the int8-stem variant
_UNSERVED = {"det_q", "stem_wq", "stem_mult", "stem_b2"}


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def params_from_jax(tree: dict, stem_stride: int = 10, decoder: str = "pico",
                    statics=None) -> dict:
    """Float tree of the ``decoder`` plan (numpy leaves, or anything
    ``np.asarray`` takes) -> int8 serving dict; for ``statics`` that serve
    the float MatteNetHD (``matting_precision='bf16'``) the float tree
    itself, with numpy leaves (:func:`float_tree`)."""
    if statics is not None and statics.matting_precision == "bf16":
        return float_tree(tree)
    return quantize_mattenet_hd(_numpy_tree(tree), stem_stride, decoder)


def load_quantized(q: dict) -> dict:
    """The reference's quantized dict of any plan (numpy leaves; ``stem_w``
    may be a bfloat16 array) -> the port's serving dict: every int8 conv
    (``wq`` s8, ``mult``, ``bias`` f32), SE dense layer and float head
    (``kernel``, ``bias`` f32) it serves; the rest is dropped."""
    out = {
        "stem_w": np.asarray(q["stem_w"]).astype(np.float32),
        "stem_b": np.asarray(q["stem_b"], np.float32),
    }
    for name, layer in q.items():
        if name in _UNSERVED or not isinstance(layer, dict):
            continue
        if "wq" in layer:
            out[name] = {"wq": np.asarray(layer["wq"], np.int8),
                         "mult": np.asarray(layer["mult"], np.float32),
                         "bias": np.asarray(layer["bias"], np.float32)}
        else:
            out[name] = {f: np.asarray(layer[f], np.float32) for f in ("kernel", "bias")}
    return out


def load_quantized_face(q: dict) -> dict:
    """The reference's quantized face dict (numpy leaves, or anything
    ``np.asarray`` takes): every int8 conv as ``wq`` s8, ``mult`` and
    ``bias`` f32; LandmarkNet's float ``Dense_0`` as ``kernel`` and
    ``bias`` f32."""
    out = {}
    for name, layer in q.items():
        if "wq" in layer:
            out[name] = {"wq": np.asarray(layer["wq"], np.int8),
                         "mult": np.asarray(layer["mult"], np.float32),
                         "bias": np.asarray(layer["bias"], np.float32)}
        else:
            out[name] = {f: np.asarray(layer[f], np.float32) for f in ("kernel", "bias")}
    return out


def float_tree(tree: dict) -> dict:
    """A reference flax float tree ``{"params", "batch_stats"}`` (MatteNet,
    RecurrentMatteNet, SaliencyNet, the plan-A MatteNetHD, FaceFinder,
    LandmarkNet) -> the same tree with f32 numpy leaves."""
    return {k: _numpy_tree(v) for k, v in tree.items() if k in ("params", "batch_stats")}


def flatten(tree: dict, prefix: str = "") -> dict:
    """A nested dict of arrays -> ``{"a:b:c": array}`` (``SEP``-joined keys)."""
    out = {}
    for k, v in tree.items():
        if SEP in k:
            raise ValueError(f"key {k!r} holds the separator {SEP!r}")
        if isinstance(v, dict):
            out.update(flatten(v, prefix + k + SEP))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def unflatten(flat) -> dict:
    """The nested dict of :func:`flatten`'s keys and values."""
    out: dict = {}
    for name, v in flat.items():
        *parents, leaf = name.split(SEP)
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def save_export(path, tree: dict) -> None:
    """Write a nested dict of arrays as one compressed ``.npz``."""
    np.savez_compressed(path, **flatten(tree))


def load_export(path) -> dict:
    """Read an archive of :func:`save_export` back into the nested dict."""
    with np.load(path, allow_pickle=False) as z:
        return unflatten({name: z[name] for name in z.files})


# the float models of the natural layout by matting_arch (the active,
# blaze_tracking and branch presets; rvm; u2), the plan-A MatteNetHD of its
# native input (fast) and the K-class MatteNet (multiclass)
MATTENET_EXPORT = "mattenet"
FLOAT_EXPORTS = {"feedforward": MATTENET_EXPORT, "recurrent": "rvm", "saliency": "u2net"}
NATIVE_EXPORT = "mattenet_hd"
NATURAL_MULTICLASS_EXPORT = "mattenet_multiclass"
# the int8 checkpoints by plan (the reference's names), one class and K=4
EXPORTS = {"full": "mattenet_hd10", "light": "mattenet_hd10_lite",
           "micro": "mattenet_hd10_micro", "pico": "mattenet_hd10_pico",
           "nano": "mattenet_hd10_nano", "femto": "mattenet_hd10_femto"}
MULTICLASS_EXPORTS = {"pico": "mattenet_hd10_mc_pico", "nano": "mattenet_hd10_mc"}
# the float trees of stem-stride-10 checkpoints, by (plan, classes): what the
# photo-background trainers warm-start from (train/realbg.py) and the float
# presets serve; the checkpoint's name with "_f32"
FLOAT_HD_EXPORTS = {("pico", 1): "mattenet_hd10_pico_f32",
                    ("pico", 4): "mattenet_hd10_mc_pico_f32"}
FLOAT_HD_STRIDE = 10


def trained_weights(statics, weights_dir=WEIGHTS_DIR) -> dict:
    """The committed trained weights of a preset: ``{"params":
    :func:`matting_weights`, "face_params": :func:`face_weights`}``."""
    return {"params": matting_weights(statics, weights_dir),
            "face_params": face_weights(statics, weights_dir)}


def matting_weights(statics, weights_dir=WEIGHTS_DIR) -> dict:
    """The committed trained matting tree of a preset: the float tree of the
    natural layout's model (K classes: the K-class MatteNet,
    ``mattenet_multiclass``; ``matting_input='resized'``: by
    ``matting_arch``, ``FLOAT_EXPORTS``: MatteNet, RVM, U2Net), or of the
    float MatteNetHD (``matting_precision='bf16'``: plan A, one class, on
    either layout, ``mattenet_hd``; at stem stride 10 the pico of one class
    and of K=4, ``FLOAT_HD_EXPORTS``; the other plans have no committed
    float export, and a KeyError names the checkpoint), else the int8
    serving dict of statics.matting_decoder (``EXPORTS[plan]`` for one
    class, ``MULTICLASS_EXPORTS[plan]`` for K)."""
    d = Path(weights_dir)
    plan = statics.matting_decoder
    if statics.frame_layout == "natural" and statics.num_classes > 1:
        matting = NATURAL_MULTICLASS_EXPORT
    elif statics.matting_input == "native" and statics.matting_precision == "bf16":
        if statics.s2d_block < 8 and statics.num_classes == 1:
            matting = NATIVE_EXPORT  # plan A: the same tree over either layout
        elif (statics.s2d_block == FLOAT_HD_STRIDE
              and (plan, statics.num_classes) in FLOAT_HD_EXPORTS):
            matting = FLOAT_HD_EXPORTS[plan, statics.num_classes]
        else:
            ckpt = (EXPORTS if statics.num_classes == 1 else MULTICLASS_EXPORTS).get(plan)
            where = (f"its trained float tree is the reference's orbax checkpoint "
                     f"checkpoints/{ckpt} (restore it with JAX and pass it through "
                     "float_tree)" if statics.s2d_block >= 8 and ckpt
                     else "the reference has no trained tree of it")
            raise KeyError(f"no committed float export of the MatteNetHD at s2d_block="
                           f"{statics.s2d_block}, matting_decoder={plan!r}, num_classes="
                           f"{statics.num_classes}: {where}; serve seeded weights "
                           "(params=None) knowingly")
    elif statics.matting_input == "resized":
        matting = FLOAT_EXPORTS[statics.matting_arch]
    else:
        matting = (EXPORTS if statics.num_classes == 1 else MULTICLASS_EXPORTS)[plan]
    return load_export(d / f"{matting}.npz")


def face_weights(statics, weights_dir=WEIGHTS_DIR) -> dict:
    """The committed trained face models of ``statics``' geometry, ``{"face",
    "lmk"}`` (no suffix at fd 256 / lmk 192, else '_<size>', as the
    reference's checkpoints are named)."""
    d = Path(weights_dir)
    fd_suf = "" if statics.fd_size == 256 else f"_{statics.fd_size}"
    lmk_suf = "" if statics.lmk_size == 192 else f"_{statics.lmk_size}"
    return {"face": load_export(d / f"facefinder{fd_suf}.npz"),
            "lmk": load_export(d / f"landmarknet{lmk_suf}.npz")}


def load_frames(weights_dir=WEIGHTS_DIR) -> tuple[np.ndarray, np.ndarray]:
    """The committed 720p test frames ``[2, 720, 1280, 3]`` u8 (a rendered
    person whose face the trained detector finds) and their ground-truth
    alpha at the 288x512 mask grid ``[2, 288, 512]`` u8 (x255)."""
    with np.load(Path(weights_dir) / "frames_720p.npz", allow_pickle=False) as z:
        return z["frames"], z["alpha_288x512"]
