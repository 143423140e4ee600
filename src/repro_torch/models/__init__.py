"""The language-model path of the port: layers, GQA attention, the dense
decoder-only transformer (its forward differentiable and
rematerialisable for training), the serving steps, the batched generation
engine and the continuous-batching scheduler.  The reference's MoE, RG-LRU
and SSM blocks are not ported yet (ROADMAP.md queue 1, the language-model
blocks): a config that needs them raises NotImplementedError."""
