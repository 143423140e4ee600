"""ffn_share.prefill: the device time of the prefill's FFN blocks
(`lm.ffn`: each block's second norm, its SwiGLU FFN and the residual
add) over the device time of the window's prefills (`serve.prefill`), in
percent.  Read from the program's spans (`repro_torch.tracing`) on the
card."""
import program_spans

ROOT = "serve.prefill"


def read(run):
    rep = program_spans.report(run, ROOT)
    if rep is None:
        return None
    return (100.0 * program_spans.device_ms(rep, "lm.ffn")
            / program_spans.device_ms(rep, ROOT))
