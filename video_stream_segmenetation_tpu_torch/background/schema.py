"""Background-template data model ("virtual business card"); a copy of the
reference's ``background/schema.py``.

Re-creates the reference customization schema (client/customization.ts:1-6
and client/data.json): a `Template` is an ordered list of layers (text /
image / rounded-rect), each with a privacy tier; an `Employee` is the
identity record whose fields feed the text layers; `AppData` bundles
backgrounds, templates and employee presets.  Privacy levels gate layer
rendering: a layer renders iff its level <= the current level
(customization.ts:38-45).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Literal

PrivacyLevel = Literal["low", "medium", "high"]
PRIVACY_RANK = {"low": 1, "medium": 2, "high": 3}

CANVAS_W, CANVAS_H = 1920, 1080  # updateCanvas geometry (customization.ts:37)


@dataclasses.dataclass
class Shadow:
    color: str = "#000000"
    blur: float = 4.0
    offset_x: float = 2.0
    offset_y: float = 2.0


@dataclasses.dataclass
class TemplateLayer:
    type: Literal["text", "image", "roundedRect"]
    privacy: PrivacyLevel
    content: str  # employee field name / image key / ignored for rects
    x: float
    y: float
    font: str | None = None  # "bold 48px Rubik"-style spec
    color: str | None = None
    align: Literal["left", "center", "right"] = "left"
    line_height: float = 40.0
    width: float | None = None
    height: float | None = None
    shadow: Shadow | None = None
    radius: float | None = None


@dataclasses.dataclass
class Template:
    name: str
    layers: list[TemplateLayer]


@dataclasses.dataclass
class Employee:
    """The 12-field identity record (customization.ts:5)."""

    full_name: str = ""
    position: str = ""
    company: str = ""
    department: str = ""
    office_location: str = ""
    email: str = ""
    telegram: str = ""
    qr_code_url: str = ""
    company_logo_url: str = ""
    slogan: str = ""
    default_template_id: str = ""
    default_background: str = ""


@dataclasses.dataclass
class AppData:
    background_options: list[str]
    templates: dict[str, Template]
    employees: dict[str, Employee]

    @classmethod
    def from_json(cls, text: str) -> "AppData":
        """Load the data.json content tier.  Accepts the reference's field
        spelling (camelCase layer keys like lineHeight)."""
        raw = json.loads(text)
        templates = {}
        for key, t in raw.get("templates", {}).items():
            layers = []
            for l in t.get("layers", []):
                sh = l.get("shadow")
                layers.append(
                    TemplateLayer(
                        type=l["type"],
                        privacy=l.get("privacy", "low"),
                        content=l.get("content", ""),
                        x=l.get("x", 0),
                        y=l.get("y", 0),
                        font=l.get("font"),
                        color=l.get("color"),
                        align=l.get("align", "left"),
                        line_height=l.get("lineHeight", l.get("line_height", 40)),
                        width=l.get("width"),
                        height=l.get("height"),
                        shadow=Shadow(
                            color=sh.get("color", "#000"),
                            blur=sh.get("blur", 4),
                            offset_x=sh.get("offsetX", sh.get("offset_x", 2)),
                            offset_y=sh.get("offsetY", sh.get("offset_y", 2)),
                        )
                        if sh
                        else None,
                        radius=l.get("radius"),
                    )
                )
            templates[key] = Template(name=t.get("name", key), layers=layers)
        employees = {}
        for key, e in raw.get("employees", {}).items():
            employees[key] = Employee(
                **{
                    f.name: e.get(f.name, "")
                    for f in dataclasses.fields(Employee)
                }
            )
        return cls(
            background_options=raw.get("background_options", []),
            templates=templates,
            employees=employees,
        )


def text_for_layer(layer: TemplateLayer, employee: Employee) -> str:
    """Resolve a text layer's content: the 'department_and_company'
    special-case joins two fields with a newline (customization.ts:59)."""
    if layer.content == "department_and_company":
        return f"{employee.department}\n{employee.company}"
    return getattr(employee, layer.content, "") or ""
