"""Static HTML image-grid page writer (port of ``cat_tpu/utils/html.py``,
the same page).

Pages live at ``<web_dir>/index.html`` with images under
``<web_dir>/images/``; ``add_header`` appends an <h3>, ``add_images``
appends one fixed-layout table row of linked thumbnails with captions,
``save`` renders to disk.  Built on the standard library.
"""

from __future__ import annotations

import html as _html
import os
from typing import List, Sequence


class HTML:
    def __init__(self, web_dir: str, title: str, refresh: int = 0,
                 img_prefix: str = "images"):
        """``img_prefix`` is the directory (relative to ``web_dir``) that
        ``add_images`` names resolve against — ``"images"`` for the
        reference contract, ``""`` for pages indexing an existing layout
        (e.g. the eval dump's input/Sfake/Tfake subdirs)."""
        self.title = title
        self.web_dir = web_dir
        self._img_prefix = img_prefix
        self.img_dir = os.path.join(web_dir, img_prefix) if img_prefix else web_dir
        os.makedirs(self.img_dir, exist_ok=True)
        self._body: List[str] = []
        self._refresh = refresh

    def get_image_dir(self) -> str:
        return self.img_dir

    def add_header(self, text: str) -> None:
        self._body.append(f"<h3>{_html.escape(text)}</h3>")

    def add_images(self, ims: Sequence[str], txts: Sequence[str],
                   links: Sequence[str], width: int = 400) -> None:
        cells = []
        for im, txt, link in zip(ims, txts, links):
            href = _html.escape(os.path.join(self._img_prefix, link), quote=True)
            src = _html.escape(os.path.join(self._img_prefix, im), quote=True)
            cells.append(
                '<td style="word-wrap: break-word;" halign="center" '
                'valign="top"><p>'
                f'<a href="{href}"><img style="width:{width}px" src="{src}">'
                f"</a><br><p>{_html.escape(txt)}</p></p></td>"
            )
        self._body.append(
            '<table border="1" style="table-layout: fixed;"><tr>'
            + "".join(cells) + "</tr></table>"
        )

    def render(self) -> str:
        head = [f"<title>{_html.escape(self.title)}</title>"]
        if self._refresh > 0:
            head.append(f'<meta http-equiv="refresh" content="{self._refresh}">')
        return (
            "<!DOCTYPE html>\n<html>\n<head>\n"
            + "\n".join(head)
            + "\n</head>\n<body>\n"
            + "\n".join(self._body)
            + "\n</body>\n</html>\n"
        )

    def save(self) -> str:
        path = os.path.join(self.web_dir, "index.html")
        with open(path, "w") as f:
            f.write(self.render())
        return path
