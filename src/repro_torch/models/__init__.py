"""The language-model path of the port: layers, GQA attention, the MoE,
RG-LRU and SSD blocks, the decoder-only transformer over every block kind
(its forward differentiable and rematerialisable for training), the
serving steps, the batched generation engine and the continuous-batching
scheduler."""
