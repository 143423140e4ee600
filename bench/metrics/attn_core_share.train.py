"""attn_core_share.train: the device time of the training step's
attention core - `_layout`'s KV-head repeat and the chunked attention,
the part a fused kernel replaces - in the forward (`attn.core`), in
remat's recompute (`attn.core.recompute`) and in the backward
(`attn.core.bwd`), over the device time of the window's steps
(`train.step`), in percent.  Read from the program's spans
(`repro_torch.tracing`) on the card."""
import program_spans

ROOT = "train.step"


def read(run):
    rep = program_spans.report(run, ROOT)
    if rep is None:
        return None
    core = program_spans.device_ms(rep, "attn.core", "attn.core.recompute",
                                   "attn.core.bwd")
    return 100.0 * core / program_spans.device_ms(rep, ROOT)
