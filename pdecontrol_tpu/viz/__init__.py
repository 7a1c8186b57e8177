"""Plots (optional: needs matplotlib and pillow, ``pip install .[plots]``)."""

import importlib.util


def available() -> bool:
    """Whether the plotting dependencies are installed."""
    return all(importlib.util.find_spec(m) is not None
               for m in ("matplotlib", "PIL"))
