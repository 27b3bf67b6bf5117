"""Auto-refreshing HTML monitoring gallery (the port's own copy of
`dwcgan_tpu/utils/html.py`; reference `utils.py:97-129`)."""

from __future__ import annotations

import os


def _row(f, title: str, img_rel: str, width: int):
    f.write(f"<h3>{title}</h3>\n")
    f.write(f'<p><a href="{img_rel}"><img src="{img_rel}" '
            f'style="width:{width}px"></a><br><p>\n')


def write_html_gallery(path: str, iterations: int, image_save_iter: int,
                       image_dir: str = "images", width: int = 1536):
    """Rebuild index.html: current training grid + every saved snapshot,
    newest first, with a 30s meta-refresh."""
    with open(path, "w") as f:
        f.write("<!DOCTYPE html>\n<html>\n<head>\n")
        f.write(f"<title>{os.path.basename(path)}</title>\n")
        f.write('<meta http-equiv="refresh" content="30">\n</head>\n<body>\n')
        _row(f, "current", f"{image_dir}/train_current.jpg", width)
        for j in range(iterations, image_save_iter - 1, -1):
            if j % image_save_iter == 0:
                _row(f, f"iteration [{j}] test", f"{image_dir}/test_{j:08d}.jpg", width)
                _row(f, f"iteration [{j}] train", f"{image_dir}/train_{j:08d}.jpg", width)
        f.write("</body></html>\n")
