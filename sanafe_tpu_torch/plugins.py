"""Plugin loading: Python modules replace the reference's dlopen plugins.

Counterpart of ``sanafe_tpu/plugins.py``. The reference resolves
``create_<ModelName>`` factory symbols from shared libraries at runtime
(``src/plugins.cpp:45-98``). Here a plugin is a Python file that calls
:func:`sanafe_tpu_torch.models.register_soma_model` (or ``register_model``)
at import time with a torch update function; architecture YAML ``plugin:``
paths ending in ``.py`` are executed on demand, once per resolved path.
Native ``.so`` plugins are not loadable (the compute path is PyTorch, not
C++ objects) — port them by registering a vectorized update function
instead; see ``sanafe_tpu_torch/models/hodgkin_huxley.py`` for a complete
example.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

_loaded: dict[str, object] = {}


def load_plugin(path: str | Path):
    """Import a Python plugin file (idempotent per resolved path)."""
    path = Path(path)
    key = str(path.resolve()) if path.exists() else str(path)
    if key in _loaded:
        return _loaded[key]
    if path.suffix == ".so":
        raise RuntimeError(
            f"Native plugin {path} cannot be loaded: this framework uses "
            "Python-registered models instead of dlopen plugins. Port the "
            "model with sanafe_tpu_torch.models.register_soma_model (see "
            "sanafe_tpu_torch/models/hodgkin_huxley.py)."
        )
    if not path.exists():
        raise FileNotFoundError(f"Plugin file not found: {path}")
    name = f"sanafe_tpu_torch_plugin_{path.stem}"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    _loaded[key] = module
    return module
