"""A module of the benchmark found by its name: ``<folder>/<name>.py``.

Traffic kinds (``kinds/``), per-layer metrics (``metrics/``) and the
reference's synthesis modes, learning-rate schedules and optimizers
(``reference/synthesis/``, ``reference/schedule/``,
``reference/optimizer/``) are each a file of their own, so that a new one
is a new file and no file that is there changes. A name may hold dots
(``idle_share.serve``).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

ROOT = Path(__file__).resolve().parent
_LOADED: dict = {}


def load(folder: str, name: str):
    """The module ``portbench/<folder>/<name>.py``, loaded once."""
    path = ROOT / folder / f"{name}.py"
    if path not in _LOADED:
        if not path.is_file():
            raise FileNotFoundError(f"no {folder} {name!r}: {path} is missing")
        ident = "_".join(["portbench", *folder.split("/"), name]) \
            .replace(".", "_").replace("-", "_")
        spec = importlib.util.spec_from_file_location(ident, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _LOADED[path] = module
    return _LOADED[path]
