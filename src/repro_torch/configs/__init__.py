"""Architecture registry of the port (counterpart of :mod:`repro.configs`).

Each registered module exports ``config()`` (the published configuration)
and ``smoke_config()`` (a reduced same-family configuration for CPU
tests).  All ten of the reference's architectures are registered and
served by :mod:`repro_torch.launch.serve`.
"""
from __future__ import annotations

import importlib

ARCHS = [
    "hubert_xlarge",
    "mamba2_2p7b",
    "deepseek_v3_671b",
    "qwen3_moe_30b_a3b",
    "llama3_8b",
    "qwen2_1p5b",
    "mistral_large_123b",
    "granite_20b",
    "zamba2_2p7b",
    "qwen2_vl_2b",
]

_ALIASES = {
    "hubert-xlarge": "hubert_xlarge",
    "mamba2-2.7b": "mamba2_2p7b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "llama3-8b": "llama3_8b",
    "qwen2-1.5b": "qwen2_1p5b",
    "mistral-large-123b": "mistral_large_123b",
    "granite-20b": "granite_20b",
    "zamba2-2.7b": "zamba2_2p7b",
    "qwen2-vl-2b": "qwen2_vl_2b",
}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name)


def get_config(name: str, *, smoke: bool = False):
    arch = canonical(name)
    if arch not in ARCHS:
        raise KeyError(f"unknown architecture {name!r}; registered: {all_arch_ids()}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.smoke_config() if smoke else mod.config()


def all_arch_ids() -> list[str]:
    return list(_ALIASES)
