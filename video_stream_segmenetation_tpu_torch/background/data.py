"""Sample content data (tier 3 of the config system); a copy of the
reference's ``background/data.py``.

Plays the role of the reference's /data.json (client/data.json: stock
backgrounds, templates with privacy-tiered layers, employee presets) with
original sample content following the same schema.
"""

from __future__ import annotations

import json

from video_stream_segmenetation_tpu_torch.background.schema import AppData

SAMPLE_DATA = {
    "background_options": [],
    "templates": {
        "badge_left": {
            "name": "Left-aligned badge",
            "layers": [
                {
                    "type": "roundedRect",
                    "privacy": "low",
                    "content": "",
                    "x": 60,
                    "y": 760,
                    "width": 720,
                    "height": 260,
                    "color": "#1B1B2FCC",
                    "radius": 24,
                },
                {
                    "type": "text",
                    "privacy": "low",
                    "content": "full_name",
                    "x": 100,
                    "y": 840,
                    "font": "bold 56px Sans",
                    "color": "#FFFFFF",
                    "shadow": {"color": "#000000", "blur": 6, "offsetX": 2, "offsetY": 2},
                },
                {
                    "type": "text",
                    "privacy": "low",
                    "content": "position",
                    "x": 100,
                    "y": 905,
                    "font": "36px Sans",
                    "color": "#C9C9E8",
                },
                {
                    "type": "text",
                    "privacy": "medium",
                    "content": "department_and_company",
                    "x": 100,
                    "y": 955,
                    "font": "28px Sans",
                    "color": "#9F9FC9",
                    "lineHeight": 34,
                },
                {
                    "type": "text",
                    "privacy": "high",
                    "content": "email",
                    "x": 520,
                    "y": 905,
                    "font": "26px Sans",
                    "color": "#8FE3C0",
                },
                {
                    "type": "image",
                    "privacy": "medium",
                    "content": "qr_code",
                    "x": 1700,
                    "y": 860,
                    "width": 160,
                    "height": 160,
                },
                {
                    "type": "image",
                    "privacy": "low",
                    "content": "company_logo",
                    "x": 1700,
                    "y": 60,
                    "width": 160,
                    "height": 80,
                },
            ],
        },
        "minimal_center": {
            "name": "Minimal centered",
            "layers": [
                {
                    "type": "text",
                    "privacy": "low",
                    "content": "full_name",
                    "x": 960,
                    "y": 990,
                    "font": "bold 48px Sans",
                    "color": "#FFFFFF",
                    "align": "center",
                    "shadow": {"color": "#000000", "blur": 8, "offsetX": 0, "offsetY": 2},
                },
                {
                    "type": "text",
                    "privacy": "medium",
                    "content": "slogan",
                    "x": 960,
                    "y": 1040,
                    "font": "30px Sans",
                    "color": "#DDDDDD",
                    "align": "center",
                },
            ],
        },
    },
    "employees": {
        "demo": {
            "full_name": "Alex Example",
            "position": "Staff Engineer",
            "company": "Example Corp",
            "department": "Video Platform",
            "office_location": "Building 7\nFloor 3",
            "email": "alex@example.com",
            "telegram": "@alex",
            "qr_code_url": "",
            "company_logo_url": "",
            "slogan": "Streams at the speed of light",
            "default_template_id": "badge_left",
            "default_background": "",
        },
        "demo2": {
            "full_name": "Sam Sample",
            "position": "Designer",
            "company": "Example Corp",
            "department": "Brand",
            "office_location": "Remote",
            "email": "sam@example.com",
            "telegram": "@sam",
            "qr_code_url": "",
            "company_logo_url": "",
            "slogan": "Make it look easy",
            "default_template_id": "minimal_center",
            "default_background": "",
        },
    },
}


def sample_app_data() -> AppData:
    return AppData.from_json(json.dumps(SAMPLE_DATA))
