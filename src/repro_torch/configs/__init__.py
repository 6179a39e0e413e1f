"""Config registry: the paper's TMs (``matador_tm``) and one module per
architecture of the LM substrate, copied from the reference as data.

``get_config(name)`` returns the full ModelConfig; ``get_smoke_config(name)``
the reduced same-family config the CPU tests use (few layers, narrow
widths, tiny vocabulary).
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = (
    "tinyllama-1.1b",
    "qwen3-32b",
    "starcoder2-7b",
    "smollm-360m",
    "deepseek-v2-236b",
    "qwen3-moe-235b-a22b",
    "musicgen-large",
    "recurrentgemma-2b",
    "xlstm-1.3b",
    "pixtral-12b",
)

_MODULES = {name: "repro_torch.configs." + name.replace("-", "_").replace(".", "_")
            for name in ARCH_IDS}


def _load(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name])


def get_config(name: str) -> ModelConfig:
    return _load(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _load(name).SMOKE
