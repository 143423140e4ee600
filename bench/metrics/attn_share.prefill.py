"""attn_share.prefill: the device time of the prefill's attention blocks
(`lm.attn`: each block's first norm, its projections, RoPE, the cache
write, the KV-head repeat and the flash kernel) over the device time of
the window's prefills (`serve.prefill`), in percent.  Read from the
program's spans (`repro_torch.tracing`) on the card."""
import program_spans

ROOT = "serve.prefill"


def read(run):
    rep = program_spans.report(run, ROOT)
    if rep is None:
        return None
    return (100.0 * program_spans.device_ms(rep, "lm.attn")
            / program_spans.device_ms(rep, ROOT))
