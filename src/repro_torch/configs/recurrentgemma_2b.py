"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, 1:2 pattern.
[arXiv:2402.19427; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    kv_heads=1,              # MQA
    head_dim=256,
    d_ff=7680,
    vocab=256000,
    layer_pattern=("rec", "rec", "attn"),   # 1 attn : 2 recurrent
    local_window=2048,
    lru_width=2560,
    logit_softcap=30.0,
    tie_embeddings=True,     # gemma-family weight tying
    subquadratic=True,       # RG-LRU state + windowed KV -> long_500k eligible
)
