"""Artist data of matplotlib figures, to hold two plotting paths to the
same drawing without comparing pixels; and a fixture that records the
artists of every figure saved."""

import numpy as np
import pytest
from matplotlib.figure import Figure


def _artists(fig):
    """Per axes: line data, rectangle geometry, collection offsets and
    paths, image arrays, and texts."""
    out = []
    for ax in fig.axes:
        out.append({
            "lines": [np.asarray(ln.get_xydata(), float) for ln in ax.lines],
            "patches": [np.asarray([p.get_x(), p.get_y(), p.get_width(), p.get_height()], float)
                        for p in ax.patches if hasattr(p, "get_width")],
            "offsets": [np.asarray(c.get_offsets(), float) for c in ax.collections],
            "paths": [np.concatenate([p.vertices for p in c.get_paths()] or [np.zeros((0, 2))])
                      for c in ax.collections],
            "images": [np.asarray(im.get_array(), float) for im in ax.images],
            "texts": [t.get_text() for t in ax.texts] + [ax.get_title(loc="left"),
                                                         ax.get_title()],
            "xticks": [t.get_text() for t in ax.get_xticklabels()],
        })
    return out


def _assert_same_artists(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in g:
            assert len(g[key]) == len(w[key]), key
            for a, b in zip(g[key], w[key]):
                if isinstance(a, str):
                    assert a == b, key
                else:
                    np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.fixture
def drawn(monkeypatch):
    """Record the artists of every figure saved (``savefig``, and so each
    page of a ``PdfPages``)."""
    pages = []
    save = Figure.savefig

    def recording(self, *args, **kwargs):
        pages.append(_artists(self))
        return save(self, *args, **kwargs)

    monkeypatch.setattr(Figure, "savefig", recording)
    return pages
