"""Static HTML result galleries.

Counterpart of the reference's ``video_prediction/utils/html.py`` (``HTML``
class with ``add_header`` / ``add_images`` / ``save``) used by the eval
scripts for qualitative side-by-side comparison pages. Zero dependencies —
plain string assembly, images/GIFs referenced relative to the page.

A copy of ``video_prediction_tpu/utils/html.py`` (copied because importing
the JAX package imports jax); ``tests/test_torch_configs.py`` keeps the two
equal.
"""

from __future__ import annotations

import os
from typing import List, Sequence


class HTML:
    def __init__(self, web_dir: str, title: str = "results", refresh: int = 0):
        self.web_dir = web_dir
        self.title = title
        self.refresh = refresh
        self.img_dir = os.path.join(web_dir, "images")
        os.makedirs(self.img_dir, exist_ok=True)
        self._body: List[str] = []

    def get_image_dir(self) -> str:
        return self.img_dir

    def add_header(self, text: str) -> None:
        self._body.append(f"<h3>{text}</h3>")

    def add_text(self, text: str) -> None:
        self._body.append(f"<p>{text}</p>")

    def add_images(
        self,
        ims: Sequence[str],
        txts: Sequence[str],
        links: Sequence[str] | None = None,
        height: int = 256,
    ) -> None:
        """One table row of images (paths relative to ``web_dir``)."""
        links = links or ims
        cells = []
        for im, txt, link in zip(ims, txts, links):
            cells.append(
                "<td halign='center' style='word-wrap: break-word;' valign='top'>"
                f"<p><a href='{link}'><img src='{im}' style='height:{height}px'></a><br>{txt}</p></td>"
            )
        self._body.append("<table border='1' style='table-layout: fixed;'><tr>" + "".join(cells) + "</tr></table>")

    def save(self, filename: str = "index.html") -> str:
        refresh = f"<meta http-equiv='refresh' content='{self.refresh}'>" if self.refresh else ""
        doc = (
            f"<!DOCTYPE html><html><head><title>{self.title}</title>{refresh}</head>"
            f"<body>{''.join(self._body)}</body></html>"
        )
        path = os.path.join(self.web_dir, filename)
        with open(path, "w") as f:
            f.write(doc)
        return path
