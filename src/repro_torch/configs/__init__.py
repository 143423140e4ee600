from repro_torch.configs.base import ModelConfig, RunConfig, SHAPES  # noqa: F401
from repro_torch.configs.registry import get_config, ARCHS  # noqa: F401
