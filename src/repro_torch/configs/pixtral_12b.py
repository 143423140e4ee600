"""pixtral-12b [vlm]: pixtral-ViT frontend (stub) + mistral-nemo backbone.
[hf:mistralai/Pixtral-12B-2409; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    frontend="vit_stub",     # input_specs() supplies patch embeddings
)
