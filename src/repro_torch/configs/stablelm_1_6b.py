"""stablelm-1.6b [dense]: MHA (kv == heads).  [hf:stabilityai/stablelm-2-1_6b;
unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab=100352,
)
