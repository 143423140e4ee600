"""glm4-9b [dense]: RoPE, GQA kv=2.  [hf:THUDM/glm-4-9b; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab=151552,
)
