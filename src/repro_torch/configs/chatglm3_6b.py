"""chatglm3-6b [dense]: RoPE 2d (approximated as standard RoPE; DESIGN.md),
GQA kv=2.  [arXiv:2406.12793; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab=65024,
)
