"""optimizer_ms.train: the device time of the optimiser's part of a
training step (`train.optimizer`: the learning-rate schedule, AdamW's
update and the gradient norm), in ms a step of the window.  Read from
the program's spans (`repro_torch.tracing`) on the card."""
import program_spans

ROOT = "train.step"


def read(run):
    rep = program_spans.report(run, ROOT)
    if rep is None:
        return None
    return (program_spans.device_ms(rep, "train.optimizer")
            / rep["spans"][ROOT]["calls"])
