"""BlockAMC core in PyTorch: converters, device non-idealities, the analog
circuits and the compile/execute pipeline of the block solver."""
