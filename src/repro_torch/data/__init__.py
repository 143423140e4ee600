"""Data of the port: the paper's benchmark matrix generators on
`torch.Generator`s (`matrices.py`) and the synthetic LM pipeline
(`pipeline.py`)."""
