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
(``runtime/presets.py``).
"""

__version__ = "0.1.0"
