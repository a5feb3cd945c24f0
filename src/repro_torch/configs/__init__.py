"""Model configurations of the port: the model zoo's architecture
registry (``--arch <id>`` ids -> ``ArchConfig``, port of
``repro/configs/__init__.py``) and ``spartus_lstm`` (Table II)."""
from repro_torch.configs.granite_34b import CONFIG as granite_34b
from repro_torch.configs.granite_moe_1b_a400m import CONFIG as granite_moe_1b_a400m
from repro_torch.configs.internlm2_20b import CONFIG as internlm2_20b
from repro_torch.configs.mamba2_130m import CONFIG as mamba2_130m
from repro_torch.configs.olmoe_1b_7b import CONFIG as olmoe_1b_7b
from repro_torch.configs.pixtral_12b import CONFIG as pixtral_12b
from repro_torch.configs.qwen2_0_5b import CONFIG as qwen2_0_5b
from repro_torch.configs.qwen3_1_7b import CONFIG as qwen3_1_7b
from repro_torch.configs.recurrentgemma_9b import CONFIG as recurrentgemma_9b
from repro_torch.configs.seamless_m4t_medium import CONFIG as seamless_m4t_medium

REGISTRY = {
    c.name: c
    for c in [
        qwen2_0_5b,
        qwen3_1_7b,
        granite_34b,
        internlm2_20b,
        mamba2_130m,
        pixtral_12b,
        granite_moe_1b_a400m,
        olmoe_1b_7b,
        seamless_m4t_medium,
        recurrentgemma_9b,
    ]
}


def get_arch(name: str):
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]
