"""The language-model serving path of the port: layers, GQA attention,
the dense decoder-only transformer, the serving steps, the batched
generation engine and the continuous-batching scheduler.  The reference's
MoE, RG-LRU and SSM blocks are not ported yet (ROADMAP item 13): a config
that needs them raises NotImplementedError."""
