"""Matlab-style plotting — the toolkit/plot.{h,cc} surface rendered
through matplotlib (Agg) instead of GL.

The reference exposes Plot:: with matlab nouns (toolkit/plot.h:12-20);
`Figure` carries the same verbs and writes PNG/SVG files (there is no
interactive GL window in a headless accelerator deployment — EggPlot-style live
plots become saved artifacts or notebook figures).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class Figure:
    def __init__(self, figsize=(7, 5)):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        self._plt = plt
        self.fig, self.ax = plt.subplots(figsize=figsize)

    def plot(self, x, y=None, *args, **kw):
        if y is None:
            self.ax.plot(np.asarray(x), *args, **kw)
        else:
            self.ax.plot(np.asarray(x), np.asarray(y), *args, **kw)
        return self

    def scatter(self, x, y, **kw):
        self.ax.scatter(np.asarray(x), np.asarray(y), **kw)
        return self

    def imshow(self, z, cmap="jet", **kw):
        self.ax.imshow(np.asarray(z), cmap=cmap, origin="lower", **kw)
        return self

    def xlabel(self, s):
        self.ax.set_xlabel(s)
        return self

    def ylabel(self, s):
        self.ax.set_ylabel(s)
        return self

    def title(self, s):
        self.ax.set_title(s)
        return self

    def legend(self, *a, **kw):
        self.ax.legend(*a, **kw)
        return self

    def grid(self, on=True):
        self.ax.grid(on)
        return self

    def axis_equal(self):
        self.ax.set_aspect("equal")
        return self

    def save(self, path: str, dpi: int = 120):
        self.fig.savefig(path, dpi=dpi, bbox_inches="tight")
        self._plt.close(self.fig)
        return path
