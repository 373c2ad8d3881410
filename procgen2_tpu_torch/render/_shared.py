"""Load the JAX package's numpy-only asset modules without importing it.

`procgen2_tpu/render/atlas.py` (procedural sprites, backgrounds, pixel
banks) and `procgen2_tpu/render/phases.py` (quantized-camera phase
tables and tile phase banks) import only numpy. Importing them the usual
way would run `procgen2_tpu/__init__.py`, which imports jax and flax, and
a machine that runs the port need not have either. So both files are
loaded by path, under a synthetic parent package whose `__path__` is the
JAX package's `render/` directory; `phases.py`'s relative `.atlas` import
then resolves to the same module object. No copy of either file exists.
"""
from __future__ import annotations

import importlib.util
import pathlib
import sys
import types

_RENDER_DIR = (pathlib.Path(__file__).resolve().parents[2]
               / "procgen2_tpu" / "render")
_PARENT = "procgen2_tpu_torch._jax_render"


def _load(name: str):
    full = f"{_PARENT}.{name}"
    mod = sys.modules.get(full)
    if mod is not None:
        return mod
    if _PARENT not in sys.modules:
        parent = types.ModuleType(_PARENT)
        parent.__path__ = [str(_RENDER_DIR)]
        sys.modules[_PARENT] = parent
    path = _RENDER_DIR / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(
            f"{path} not found: the port reads the JAX package's asset "
            "modules from the same checkout")
    spec = importlib.util.spec_from_file_location(full, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[full] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[full]
        raise
    return mod


atlas = _load("atlas")
phases = _load("phases")
