"""kernel_build_s.prefill: the seconds this process spent compiling the
program's CUDA kernels with nvcc (the counter `kernel.build_s` of
`repro_torch.tracing`, which `kernels/_build.py` adds to), 0 where every
kernel was found built.  Part of `setup_s`."""
import program_spans


def read(run):
    rep = program_spans.report(run, "serve.prefill")
    if rep is None:
        return None
    return float(rep["counters"].get("kernel.build_s", 0.0))
