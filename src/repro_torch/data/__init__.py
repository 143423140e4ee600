"""Benchmark matrix generators of the paper, on `torch.Generator`s."""
