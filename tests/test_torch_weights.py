"""The trained weights and test frames the port serves on the card,
committed under video_stream_segmenetation_tpu_torch/weights/ (the card's
machine has no JAX or orbax, so it cannot read the checkpoints or render
the frames).

Regenerate them with

    python -c "from tests.test_torch_weights import export; export()"

:func:`export` restores each checkpoint with the JAX package, quantizes
the matting trunks with the reference's ``quantize_mattenet_hd`` (the
port's ``bridge.load_quantized`` keeps what it serves), keeps the float
trees (the natural layout's MatteNet, the face models), and writes one
compressed ``.npz`` a tree (``bridge.save_export``), plus two 720p frames
of ``utils/clips.py::articulated_clip(features=True)``.  The test below
re-exports into a temporary directory and holds every array against the
committed files.
"""

from pathlib import Path

import jax
import numpy as np

from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu import models
from video_stream_segmenetation_tpu.models.quantized import quantize_mattenet_hd
from video_stream_segmenetation_tpu.utils.checkpoint import restore_params
from video_stream_segmenetation_tpu.utils.clips import articulated_clip
from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.models import quantized as TQ

CKPT = Path(__file__).resolve().parents[1] / "checkpoints"
# (checkpoint name, plan, classes)
TRUNKS = (("mattenet_hd10_micro", "micro", 1), ("mattenet_hd10_pico", "pico", 1),
          ("mattenet_hd10_mc_pico", "pico", 4), ("mattenet_hd10_mc", "nano", 4),
          ("mattenet_hd10", "full", 1), ("mattenet_hd10_lite", "light", 1),
          ("mattenet_hd10_nano", "nano", 1), ("mattenet_hd10_femto", "femto", 1))
# float trees: the natural layout's MatteNet, RecurrentMatteNet,
# SaliencyNet, plan-A MatteNetHD (fast) and K=4 MatteNet (multiclass), and
# the face models
FLOAT = ("mattenet", "facefinder", "facefinder_128", "landmarknet", "landmarknet_128",
         "rvm", "u2net", "mattenet_hd", "mattenet_multiclass", *bridge.FLOAT_HD_EXPORTS.values())
# the float trees of int8-served checkpoints, exported under other names
# (bridge.FLOAT_HD_EXPORTS): the photo-background trainers' warm starts
FLOAT_FROM = {name: name.removesuffix("_f32") for name in bridge.FLOAT_HD_EXPORTS.values()}
# the committed frames: frames 0 and 7 of this clip (720p, procedural
# background, face features painted; the head lies inside the frame)
FRAMES_CLIP = dict(n_frames=8, hw=(720, 1280), seed=2, features=True)
FRAMES_PICK = (0, 7)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def export(out_dir=bridge.WEIGHTS_DIR, frames: bool = True, only=None) -> list[Path]:
    """Write the exports into ``out_dir`` (with ``only``, those of these
    names); returns the files written."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written = []
    for name, plan, k in TRUNKS:
        if only is not None and name not in only:
            continue
        model = models.MatteNetHD(stem_stride=10, head_upsample=4, num_classes=k,
                                  decoder=plan)
        q = quantize_mattenet_hd(model, restore_params(str(CKPT / name)))
        bridge.save_export(out / f"{name}.npz", bridge.load_quantized(_numpy(q)))
        written.append(out / f"{name}.npz")
    for name in FLOAT:
        if only is not None and name not in only:
            continue
        tree = bridge.float_tree(_numpy(restore_params(str(CKPT / FLOAT_FROM.get(name, name)))))
        bridge.save_export(out / f"{name}.npz", tree)
        written.append(out / f"{name}.npz")
    if frames:
        clip = articulated_clip(**FRAMES_CLIP)
        # ground-truth alpha at the mask grid, nearest taps, u8 (x255)
        iy = (np.arange(288) * 720) // 288
        ix = (np.arange(512) * 1280) // 512
        alpha = clip.alpha[list(FRAMES_PICK)][:, iy][:, :, ix]
        np.savez_compressed(out / "frames_720p.npz",
                            frames=clip.frames[list(FRAMES_PICK)],
                            alpha_288x512=np.round(alpha * 255.0).astype(np.uint8))
        written.append(out / "frames_720p.npz")
    return written


def test_committed_exports_reproduce(tmp_path):
    files = export(tmp_path)
    assert len(files) == len(TRUNKS) + len(FLOAT) + 1
    for f in files:
        committed = bridge.WEIGHTS_DIR / f.name
        with np.load(f, allow_pickle=False) as a, np.load(committed, allow_pickle=False) as b:
            assert sorted(a.files) == sorted(b.files), f.name
            for k in a.files:
                assert a[k].dtype == b[k].dtype, (f.name, k)
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{f.name}:{k}")


def test_loaded_exports_are_served_trees():
    """The committed trees load with numpy alone into what Engine takes."""
    from video_stream_segmenetation_tpu_torch.runtime.presets import preset

    for name, plan, k in (("fast_int8_micro", "micro", 1), ("fast_int8_pico", "pico", 1),
                          ("multiclass_fast_pico", "pico", 4), ("multiclass_fast", "nano", 4),
                          ("fast_int8", "full", 1), ("fast_int8_lite", "light", 1),
                          ("fast_int8_nano", "nano", 1), ("fast_int8_femto", "femto", 1)):
        w = bridge.trained_weights(preset(name))
        assert w["params"]["d2dn"]["wq"].dtype == np.int8
        assert TQ.plan_of(w["params"]) == plan and TQ.num_classes_of(w["params"]) == k
        assert set(w["face_params"]) == {"face", "lmk"}
        assert w["face_params"]["face"]["params"]["ConvBN_0"]["Conv_0"]["kernel"].shape \
            == (3, 3, 3, 32)
    w = bridge.trained_weights(preset("active"))
    assert w["params"]["params"]["Conv_2"]["kernel"].shape == (1, 1, 16, 1)
    assert w["params"]["params"]["MobileEncoder_0"]["ConvBN_0"]["Conv_0"]["kernel"].dtype \
        == np.float32
    for name, leaf in (("rvm", ("ConvGRU_0", "Conv_0")), ("u2", ("RSU_0", "ConvBN_0"))):
        tree = bridge.trained_weights(preset(name))["params"]["params"]
        assert leaf[0] in tree and leaf[1] in tree[leaf[0]]
    frames, alpha = bridge.load_frames()
    assert frames.shape == (2, 720, 1280, 3) and frames.dtype == np.uint8
    assert alpha.shape == (2, 288, 512) and 0 < alpha.mean() < 255


def test_float_pico_exports_serve():
    """The float pico trees (one class and K=4) load with numpy alone,
    through bridge.trained_weights for the float presets at stem stride 10,
    into the MatteNetHD they warm-start; other plans still name the
    checkpoint."""
    import pytest

    from video_stream_segmenetation_tpu_torch.models.mattenet_hd import MatteNetHD
    from video_stream_segmenetation_tpu_torch.runtime.presets import preset

    for name, k in (("fast_int8_pico", 1), ("multiclass_fast_pico", 4)):
        tree = bridge.trained_weights(preset(name, matting_precision="bf16"))["params"]
        assert set(tree) == {"params", "batch_stats"}
        assert MatteNetHD(10, 4, "pico", params=tree, device="cpu").num_classes == k
    with pytest.raises(KeyError, match="checkpoints/mattenet_hd10_nano"):
        bridge.trained_weights(preset("fast_int8_nano", matting_precision="bf16"))
