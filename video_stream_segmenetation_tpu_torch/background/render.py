"""Background renderer: templates -> 1920x1080 RGB arrays (a copy of the
reference's ``background/render.py``; it needs PIL).

The rework of the reference client's Canvas2D background generator
(updateCanvas, client/customization.ts:35-78): render once per background
change on the host (PIL); the engine keeps the result on its device
(Engine.set_background) and composites it each frame.  Supported layers match the reference: text
with optional shadow and multiline (drawMultilineText :80), images
(:67-70), rounded rects (:71-76); layers are privacy-gated (:45);
background image or black fill (:41-42).
"""

from __future__ import annotations

import functools
import logging
import re

import numpy as np
from PIL import Image, ImageDraw, ImageFilter, ImageFont

from video_stream_segmenetation_tpu_torch.background.schema import (
    CANVAS_H,
    CANVAS_W,
    PRIVACY_RANK,
    AppData,
    Employee,
    Template,
    TemplateLayer,
    text_for_layer,
)

log = logging.getLogger("vst.background")

_FONT_RE = re.compile(r"(?:(bold|italic)\s+)?(\d+)px\s+(.+)", re.I)


@functools.lru_cache(maxsize=64)
def _load_font(size: int, bold: bool = False) -> ImageFont.FreeTypeFont:
    candidates = [
        "/usr/share/fonts/truetype/dejavu/DejaVuSans-Bold.ttf" if bold
        else "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
        "/usr/share/fonts/truetype/liberation/LiberationSans-Regular.ttf",
    ]
    for path in candidates:
        try:
            return ImageFont.truetype(path, size)
        except OSError:
            continue
    try:
        return ImageFont.load_default(size)
    except TypeError:  # older PIL
        return ImageFont.load_default()


def _parse_font(spec: str | None):
    """Parse a CSS-ish '"bold 48px Rubik"' spec (the template font tier)."""
    if not spec:
        return _load_font(24)
    m = _FONT_RE.match(spec.strip())
    if not m:
        return _load_font(24)
    style, size, _family = m.groups()
    return _load_font(int(size), bold=(style or "").lower() == "bold")


class BackgroundRenderer:
    """Stateful renderer for one stream's personalized background.

    Mirrors the customization module's mutable state (currentState /
    currentTemplate / images / currentPrivacy, customization.ts:27-29):
    mutate via setters, then `render()` -> uint8 [1080, 1920, 3].
    """

    def __init__(
        self,
        template: Template,
        employee: Employee,
        privacy: str = "medium",
        canvas_hw: tuple[int, int] = (CANVAS_H, CANVAS_W),
    ):
        self.template = template
        self.employee = employee
        self.privacy = privacy
        self.canvas_hw = canvas_hw
        self.images: dict[str, Image.Image] = {}
        self._cache: np.ndarray | None = None

    # --- mutation API (each invalidates the cache = updateCanvas call)
    def set_privacy(self, level: str):
        """setPrivacyLevel (customization.ts:33)."""
        if level not in PRIVACY_RANK:
            raise ValueError(f"unknown privacy level: {level}")
        self.privacy = level
        self._cache = None

    def set_employee_field(self, field: str, value: str):
        """Live text-input binding (customization.ts:140-145)."""
        setattr(self.employee, field, value)
        self._cache = None

    def set_image(self, key: str, image) -> None:
        """Upload binding: background / qr_code / company_logo
        (customization.ts:133-138).  image: PIL image, numpy array or
        path."""
        if isinstance(image, (str,)):
            image = Image.open(image)
        elif isinstance(image, np.ndarray):
            image = Image.fromarray(image)
        self.images[key] = image.convert("RGB") if key == "background" else image.convert("RGBA")
        self._cache = None

    def set_template(self, template: Template):
        self.template = template
        self._cache = None

    # --- rendering
    def render(self) -> np.ndarray:
        """uint8 [H, W, 3].  Cached until the next mutation."""
        if self._cache is not None:
            return self._cache
        h, w = self.canvas_hw
        if "background" in self.images:
            canvas = self.images["background"].resize((w, h)).convert("RGB")
        else:
            canvas = Image.new("RGB", (w, h), (0, 0, 0))  # black fill (:42)
        canvas = canvas.convert("RGBA")
        level = PRIVACY_RANK[self.privacy]
        sx, sy = w / CANVAS_W, h / CANVAS_H  # templates author at 1920x1080

        for layer in self.template.layers:
            if PRIVACY_RANK[layer.privacy] > level:
                continue  # privacy gate (:45)
            if layer.type == "text":
                self._draw_text(canvas, layer, sx, sy)
            elif layer.type == "image":
                self._draw_image(canvas, layer, sx, sy)
            elif layer.type == "roundedRect":
                self._draw_rect(canvas, layer, sx, sy)
            else:
                log.warning("unknown layer type %r skipped", layer.type)

        self._cache = np.asarray(canvas.convert("RGB"), dtype=np.uint8)
        return self._cache

    def _draw_text(self, canvas: Image.Image, layer: TemplateLayer, sx, sy):
        text = text_for_layer(layer, self.employee)
        if not text:
            return
        font = _parse_font(layer.font)
        color = layer.color or "#FFFFFF"
        anchor = {"left": "ls", "center": "ms", "right": "rs"}[layer.align]
        lines = text.split("\n")

        def draw_lines(dr, ox=0.0, oy=0.0, fill=color):
            for i, line in enumerate(lines):
                dr.text(
                    ((layer.x + ox) * sx, (layer.y + oy + i * layer.line_height) * sy),
                    line,
                    font=font,
                    fill=fill,
                    anchor=anchor,
                )

        if layer.shadow:
            sh = layer.shadow
            shadow_im = Image.new("RGBA", canvas.size, (0, 0, 0, 0))
            draw_lines(
                ImageDraw.Draw(shadow_im), sh.offset_x, sh.offset_y, sh.color
            )
            if sh.blur > 0:
                shadow_im = shadow_im.filter(ImageFilter.GaussianBlur(sh.blur / 2))
            canvas.alpha_composite(shadow_im)
        draw_lines(ImageDraw.Draw(canvas))

    def _draw_image(self, canvas: Image.Image, layer: TemplateLayer, sx, sy):
        img = self.images.get(layer.content)
        if img is None or not layer.width or not layer.height:
            return  # missing image degrades gracefully (:69 complete check)
        img = img.resize((max(1, int(layer.width * sx)), max(1, int(layer.height * sy))))
        canvas.alpha_composite(
            img.convert("RGBA"), (int(layer.x * sx), int(layer.y * sy))
        )

    def _draw_rect(self, canvas: Image.Image, layer: TemplateLayer, sx, sy):
        if not layer.width or not layer.height:
            return
        dr = ImageDraw.Draw(canvas, "RGBA")
        dr.rounded_rectangle(
            [
                layer.x * sx,
                layer.y * sy,
                (layer.x + layer.width) * sx,
                (layer.y + layer.height) * sy,
            ],
            radius=(layer.radius or 0) * min(sx, sy),
            fill=layer.color or "#FFFFFF",
        )
