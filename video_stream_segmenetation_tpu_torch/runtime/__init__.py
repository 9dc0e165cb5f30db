"""Runtime: per-stream state, live knobs, presets, the pipeline step and
the serving rollouts.

``make_step_rollout`` and ``make_round_rollout`` (runtime/rollout.py) are
exported here, as the reference's runtime exports them; they load on first
use, because the ops the pipeline imports read runtime/config.py.
"""

_ROLLOUTS = ("make_round_rollout", "make_step_rollout")


def __getattr__(name):
    if name in _ROLLOUTS:
        from video_stream_segmenetation_tpu_torch.runtime import rollout

        return getattr(rollout, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted([*globals(), *_ROLLOUTS])
