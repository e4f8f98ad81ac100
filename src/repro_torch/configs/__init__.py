"""Architecture registry: the 10 assigned architectures (+ the paper's own
small models for the FL reproduction) as selectable configs.

Each module exposes ``FULL`` (the exact assigned configuration) and
``SMOKE`` (a reduced same-family variant: <=2-ish layers, d_model<=512,
<=4 experts) plus cites its source in the module docstring.
"""
from __future__ import annotations

import importlib

ARCHS = (
    "gemma_2b",
    "whisper_medium",
    "deepseek_moe_16b",
    "kimi_k2_1t_a32b",
    "h2o_danube_1_8b",
    "granite_20b",
    "llama_3_2_vision_90b",
    "jamba_v0_1_52b",
    "minitron_8b",
    "falcon_mamba_7b",
)

# CLI ids (dashes) -> module names
ARCH_IDS = {a.replace("_", "-"): a for a in ARCHS}
ARCH_IDS.update({
    "gemma-2b": "gemma_2b",
    "whisper-medium": "whisper_medium",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "granite-20b": "granite_20b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "minitron-8b": "minitron_8b",
    "falcon-mamba-7b": "falcon_mamba_7b",
})


def get(arch_id: str, smoke: bool = False):
    mod_name = ARCH_IDS.get(arch_id, arch_id.replace("-", "_").replace(".", "_"))
    mod = importlib.import_module(f".{mod_name}", __package__)
    return mod.SMOKE if smoke else mod.FULL


def all_arch_ids():
    return [a.replace("_", "-") for a in ARCHS]
