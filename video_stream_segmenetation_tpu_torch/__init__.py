"""PyTorch/CUDA port of ``video_stream_segmenetation_tpu``.

The JAX package beside this one is the reference; this package mirrors its
module names (``runtime/``, ``ops/``, ``models/``, ``kernels/``,
``service/``) so each counterpart is easy to find.  It imports ``torch``
and never JAX or the reference package.  Hand-written CUDA kernels for
Hopper (``csrc/``) replace the reference's Pallas kernels; each sits beside
its plain PyTorch version in ``kernels/``.

Served through :class:`service.engine.Engine`: the reference's default
``active`` preset (``PipelineStatics()``) on its kernel routes, the
``fast_int8*`` presets and the ``multiclass_fast*`` presets
(``runtime/presets.py``).  The stateless entry points are ``segment``,
``composite`` and ``process_frame`` (``api.py``):

    from video_stream_segmenetation_tpu_torch import segment, composite, Engine
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy: importing the package loads no model until the API is touched
    if name in ("segment", "composite", "process_frame"):
        from video_stream_segmenetation_tpu_torch import api

        return getattr(api, name)
    if name == "Engine":
        from video_stream_segmenetation_tpu_torch.service.engine import Engine

        return Engine
    raise AttributeError(name)
