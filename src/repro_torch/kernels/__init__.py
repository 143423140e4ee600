"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain PyTorch
versions.

  arena_mvm     - the arena-executor tile program (replaces the
                  reference's Pallas kernel `repro/kernels/arena_mvm.py`)
  banded_solve  - the block-Thomas sweeps of the nodal wire model
                  (replaces `repro/kernels/banded_solve.py`)
  crossbar_mvm  - the differential crossbar MVM with fused converters,
                  single array and stacked (replaces
                  `repro/kernels/crossbar_mvm.py`)
  schur_gemm    - the fused Schur-complement update A4 - A3 @ W
                  (replaces `repro/kernels/schur_gemm.py`)
  flash_attention - causal online-softmax attention forward (replaces
                  `repro/kernels/flash_attention.py`)

Use `repro_torch.kernels.ops` for the public entry points (a CPU tensor
runs the plain version in `ref.py`, a CUDA tensor launches the kernel) and
`repro_torch.kernels.ref` for the plain versions themselves.  Importing
this package builds nothing: the CUDA sources are compiled with `nvcc` on
first launch (`_build.py`).
"""
