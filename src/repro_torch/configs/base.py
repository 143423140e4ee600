"""Model/run configuration dataclasses for the LM framework."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description; one instance per assigned architecture."""
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1          # every k-th layer is MoE (llama4: 2)
    shared_expert: bool = False
    capacity_factor: float = 1.25
    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_kernel: int = 4
    # --- hybrid (recurrentgemma) ---
    local_window: int = 2048
    layer_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    lru_width: Optional[int] = None
    # --- positional / norm ---
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    logit_softcap: Optional[float] = None
    # --- modality frontend (stub per brief) ---
    frontend: str = "none"      # none | vit_stub | encodec_stub
    # --- dtypes ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # sub-quadratic? (drives long_500k eligibility)
    subquadratic: bool = False

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.kv_heads

    def layer_kind(self, i: int) -> str:
        """'attn' | 'rec' | 'ssm' layer types; 'moe' vs 'dense' is separate."""
        if self.family == "ssm":
            return "ssm"
        if self.layer_pattern:
            return self.layer_pattern[i % len(self.layer_pattern)]
        return "attn"

    def is_moe_layer(self, i: int) -> bool:
        if self.n_experts == 0:
            return False
        return (i % self.moe_every) == (self.moe_every - 1)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """One (arch x shape) execution cell."""
    model: ModelConfig
    mode: str                   # train | prefill | decode
    seq_len: int
    global_batch: int
    microbatch: Optional[int] = None  # global microbatch size (grad accum)
    remat: str = "dots"         # none | dots | full
    fsdp: bool = False          # ZeRO-style param/optimizer sharding on data
    moments_dtype: str = "float32"
    accum_dtype: str = "float32"      # grad-accumulation buffer dtype
    seq_shard: bool = False           # Megatron-SP: residual S dim on "model"
    learning_rate: float = 3e-4
    grad_compression: bool = False   # int8 + error feedback across pods
    scan_layers: bool = True


# The four assigned input shapes (LM-family transformers).
SHAPES = {
    "train_4k": dict(mode="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(mode="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(mode="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(mode="decode", seq_len=524288, global_batch=1),
}
