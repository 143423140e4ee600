"""musicgen-medium [audio]: decoder-only over EnCodec tokens (frontend stub).
[arXiv:2306.05284; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    kv_heads=24,             # MHA
    head_dim=64,
    d_ff=6144,
    vocab=2048,              # EnCodec codebook
    frontend="encodec_stub",
)
