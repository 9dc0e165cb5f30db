"""Personalized background generator (port of the reference's
``background/``): the template schema, the sample data and the PIL
renderer.  ``BackgroundRenderer`` is imported on first use, so the schema
and the data need no PIL."""

from video_stream_segmenetation_tpu_torch.background.data import sample_app_data  # noqa: F401
from video_stream_segmenetation_tpu_torch.background.schema import (  # noqa: F401
    PRIVACY_RANK,
    AppData,
    Employee,
    Shadow,
    Template,
    TemplateLayer,
    text_for_layer,
)


def __getattr__(name):
    if name == "BackgroundRenderer":
        from video_stream_segmenetation_tpu_torch.background.render import BackgroundRenderer

        return BackgroundRenderer
    raise AttributeError(name)
