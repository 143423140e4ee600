"""The training path, as `repro/train`: the step (loss, gradients,
microbatch accumulation, AdamW) and the trainer (data, step, metrics,
checkpoint / restart, watchdog).  The reference's `train/pipeline.py`
(pipeline parallelism over a mesh) comes with the port's mesh (ROADMAP.md
queue 1, the mesh slice)."""
from repro_torch.train.train_step import (  # noqa: F401
    TrainState, init_train_state, loss_fn, make_train_step)
