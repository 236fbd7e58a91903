"""Architecture registry: ``<arch-id>`` resolution for the LM path.

Each entry maps an architecture id to its config module (CONFIG
full-size, SMOKE reduced, SHAPES runnable cells).  All ten of the JAX
package's architectures are ported: the dense attention ones (token and
embed front ends, causal and bidirectional), the attention-free
rwkv6-1.6b, the MoE ones (qwen3-moe-235b-a22b, llama4-maverick-400b-a17b)
and the mamba/attention/MoE hybrid jamba-v0.1-52b.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Tuple

from repro_torch.configs.common import ShapeSpec
from repro_torch.models.model import ModelConfig

_MODULES: Dict[str, str] = {
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "internvl2-76b": "repro_torch.configs.internvl2_76b",
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "llama4-maverick-400b-a17b":
        "repro_torch.configs.llama4_maverick_400b_a17b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v01_52b",
}

ARCH_IDS: Tuple[str, ...] = tuple(_MODULES)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    config: ModelConfig
    smoke: ModelConfig
    shapes: Tuple[ShapeSpec, ...]

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.arch_id} does not run shape {name!r} "
                       f"(available: {[s.name for s in self.shapes]})")


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(_MODULES)}")
    mod = importlib.import_module(_MODULES[arch_id])
    return ArchSpec(arch_id=arch_id, config=mod.CONFIG, smoke=mod.SMOKE,
                    shapes=mod.SHAPES)


def all_cells() -> Tuple[Tuple[str, str], ...]:
    """Every runnable (arch, shape) pair: the dry run's matrix."""
    return tuple((aid, s.name) for aid in ARCH_IDS
                 for s in get_arch(aid).shapes)
