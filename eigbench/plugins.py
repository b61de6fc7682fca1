"""Files of this folder found by name: ``<kind>/<name>.py``, loaded once."""

from __future__ import annotations

import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def load_plugin(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of this folder, loaded once."""
    key = f"eigbench._{kind}.{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, os.path.join(HERE, kind, f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        spec.loader.exec_module(module)
    return sys.modules[key]
