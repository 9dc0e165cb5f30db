"""End-to-end demo (port of ``examples/virtual_business_card.py``): the
reference application's "digital dress code", offline.

Synthetic webcam clips for N streams -> Engine (segmentation and the full
refinement chain) through a StreamScheduler over the native frame pool ->
personalized generated backgrounds (templates and privacy levels) ->
composited frames written as PNGs, with the control endpoint up while it
serves.

    python -m video_stream_segmenetation_tpu_torch.examples.virtual_business_card \\
        --frames 12 --out OUT [--device cpu] [--checkpoint WEIGHTS.npz] [--hd]

``--checkpoint`` takes an ``.npz`` export (e.g. the committed
``weights/mattenet.npz``); ``--hd`` serves ``fast_int8`` at 720p on the
committed ``mattenet_hd10.npz`` with the face pair that
utils/checkpoint.py::face_checkpoint_paths names.  :func:`run` is the
function form: it returns the composited frames.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=2)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "vbc"))
    ap.add_argument("--privacy", default="medium", choices=["low", "medium", "high"])
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--checkpoint", default=None,
                    help="an .npz export of the matting weights (e.g. "
                    "video_stream_segmenetation_tpu_torch/weights/mattenet.npz)")
    ap.add_argument("--hd", action="store_true",
                    help="serve at 720p (288x512 mask) with the fast_int8 stack on the "
                    "committed weights/mattenet_hd10.npz")
    return ap.parse_args(argv)


def business_backgrounds(streams: int, privacy: str, frame_hw) -> list:
    """One personalized background renderer a stream, from the sample
    content data's employees in turn, over a blue gradient."""
    from video_stream_segmenetation_tpu_torch import background as bgm

    data = bgm.sample_app_data()
    out = []
    for _, emp_key in zip(range(streams), list(data.employees) * streams):
        emp = data.employees[emp_key]
        r = bgm.BackgroundRenderer(data.templates[emp.default_template_id], emp,
                                   privacy=privacy, canvas_hw=frame_hw)
        grad = np.zeros((*frame_hw, 3), np.uint8)
        grad[..., 2] = np.linspace(30, 130, frame_hw[1], dtype=np.uint8)[None, :]
        grad[..., 0] = 25
        r.set_image("background", grad)
        out.append(r)
    return out


def run(args: argparse.Namespace) -> list[np.ndarray]:
    """Serve the demo; returns the composited frames, one ``[streams, H, W,
    3]`` u8 array a time step (PNGs of the first, middle and last steps go
    to ``args.out``)."""
    from PIL import Image

    from video_stream_segmenetation_tpu_torch.bridge import WEIGHTS_DIR
    from video_stream_segmenetation_tpu_torch.runtime.config import PipelineStatics
    from video_stream_segmenetation_tpu_torch.runtime.presets import preset
    from video_stream_segmenetation_tpu_torch.runtime.scheduler import StreamScheduler
    from video_stream_segmenetation_tpu_torch.service.engine import Engine
    from video_stream_segmenetation_tpu_torch.service.server import ControlServer
    from video_stream_segmenetation_tpu_torch.utils.checkpoint import face_checkpoint_paths
    from video_stream_segmenetation_tpu_torch.utils.clips import synthetic_clip

    if args.hd:
        frame_hw = (720, 1280)
        statics = dataclasses.replace(preset("fast_int8"), background="image")
        checkpoint = args.checkpoint or WEIGHTS_DIR / "mattenet_hd10.npz"
    else:
        frame_hw = (240, 320)
        statics = PipelineStatics(frame_hw=frame_hw, mask_hw=(96, 128), fd_size=128,
                                  lmk_size=96, background="image")
        checkpoint = args.checkpoint
    engine = Engine(num_streams=args.streams, statics=statics, device=args.device)
    if checkpoint:
        engine.load_matting_params(checkpoint)
    # the trained face models of the geometry, where they are committed
    fd, lmk = (p + ".npz" for p in face_checkpoint_paths(str(WEIGHTS_DIR), statics.fd_size,
                                                         statics.lmk_size))
    if os.path.isfile(fd):
        engine.load_face_params(fd, lmk if os.path.isfile(lmk) else None)
    sched = StreamScheduler(engine, use_native_pool=True)

    renderers = {}
    for r in business_backgrounds(args.streams, args.privacy, frame_hw):
        slot = sched.admit()
        renderers[slot] = r
        engine.set_background(slot, r.render())

    server = ControlServer(engine, renderers=renderers).start()
    print(f"control endpoint: http://127.0.0.1:{server.port}/stats")
    os.makedirs(args.out, exist_ok=True)
    clips = [synthetic_clip(n_frames=args.frames, hw=frame_hw, seed=s, motion=2.0)
             for s in range(args.streams)]
    served = []
    try:
        for t in range(args.frames):
            for s in range(args.streams):
                sched.push_frame(s, clips[s].frames[t])
            out = sched.step()
            frames = out["frame"].cpu().numpy()
            served.append(frames)
            if t in (0, args.frames // 2, args.frames - 1):
                for s in range(args.streams):
                    Image.fromarray(frames[s]).save(os.path.join(args.out,
                                                                 f"stream{s}_t{t:03d}.png"))
        print("metrics:", out["metrics"])
    finally:
        server.stop()
        sched.stop()
    print(f"wrote frames to {args.out}")
    return served


def main(argv=None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
