"""Optimizers of the training path, as `repro/optim`: AdamW, the LR
schedule, int8 gradient compression and the BlockAMC preconditioner."""
from repro_torch.optim.adamw import AdamW, OptState  # noqa: F401
from repro_torch.optim.schedule import warmup_cosine  # noqa: F401
