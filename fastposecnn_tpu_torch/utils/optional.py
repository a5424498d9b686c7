"""Imports of the packages that only the figures and tables use.

The drawing (cv2), the figures (matplotlib) and the xlsx table (pandas)
import their package when called, never when the port is imported: the
GPU machine the port runs on may lack them. `need` imports one and, if it
does not import, raises an ImportError that names the package and what
needed it.
"""

from __future__ import annotations

import importlib

# module -> the package that provides it
PACKAGES = {"cv2": "opencv-python (cv2)", "matplotlib": "matplotlib", "pandas": "pandas"}


def need(module: str, what: str):
    """`importlib.import_module(module)`, or an ImportError naming the
    package and `what` needs it."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"{what} needs the package {PACKAGES.get(module, module)}, "
                          f"which does not import here ({e})") from e


def pyplot(what: str):
    """matplotlib's pyplot on the Agg backend (no display), through `need`."""
    matplotlib = need("matplotlib", what)
    matplotlib.use("Agg")
    return importlib.import_module("matplotlib.pyplot")
