"""llama4-maverick-400b-a17b [moe]: 128-expert top-1 MoE, alternating
dense/MoE layers, shared expert.  [hf:meta-llama/Llama-4-*; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    n_experts=128,
    top_k=1,
    moe_every=2,             # every other layer is MoE (llama4 interleave)
    shared_expert=True,
)
