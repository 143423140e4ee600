"""Architecture registry: --arch <id> resolution."""
from repro_torch.configs import (
    chatglm3_6b, command_r_35b, glm4_9b, llama4_maverick_400b_a17b,
    mamba2_130m, musicgen_medium, phi35_moe_42b_a6_6b, pixtral_12b,
    recurrentgemma_2b, stablelm_1_6b)

ARCHS = {
    m.CONFIG.name: m.CONFIG for m in (
        recurrentgemma_2b, llama4_maverick_400b_a17b, phi35_moe_42b_a6_6b,
        pixtral_12b, glm4_9b, stablelm_1_6b, command_r_35b, chatglm3_6b,
        musicgen_medium, mamba2_130m)
}


def get_config(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
