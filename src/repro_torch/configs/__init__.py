"""Architecture registry of the port (counterpart of :mod:`repro.configs`).

Each registered module exports ``config()`` (the published configuration)
and ``smoke_config()`` (a reduced same-family configuration for CPU
tests).  Ported: the MoE model ``qwen3-moe-30b-a3b`` and the dense family
(``llama3-8b``, ``qwen2-1.5b``, ``mistral-large-123b``, ``granite-20b``).
Every other architecture of the reference raises ``NotImplementedError``
naming the ROADMAP item that ports it.
"""
from __future__ import annotations

import importlib

ARCHS = ["qwen3_moe_30b_a3b", "llama3_8b", "qwen2_1p5b", "mistral_large_123b", "granite_20b"]

_ALIASES = {
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "llama3-8b": "llama3_8b",
    "qwen2-1.5b": "qwen2_1p5b",
    "mistral-large-123b": "mistral_large_123b",
    "granite-20b": "granite_20b",
}

# the reference's other architectures, not ported yet: alias -> (module,
# the ROADMAP Queue 1 item that ports it)
_NOT_PORTED = {
    "deepseek-v3-671b": ("deepseek_v3_671b", "3b"),
    "mamba2-2.7b": ("mamba2_2p7b", "3c"),
    "zamba2-2.7b": ("zamba2_2p7b", "3c"),
    "qwen2-vl-2b": ("qwen2_vl_2b", "3c"),
    "hubert-xlarge": ("hubert_xlarge", "3c"),
}


def canonical(name: str) -> str:
    return _ALIASES.get(name, _NOT_PORTED.get(name, (name,))[0])


def get_config(name: str, *, smoke: bool = False):
    arch = canonical(name)
    if arch not in ARCHS:
        for mod, item in _NOT_PORTED.values():
            if mod == arch:
                raise NotImplementedError(
                    f"architecture {name!r} is not ported yet (ROADMAP Queue 1 item {item}); "
                    f"ported: {all_arch_ids()}")
        raise KeyError(f"unknown architecture {name!r}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.smoke_config() if smoke else mod.config()


def all_arch_ids() -> list[str]:
    return list(_ALIASES)
