"""The dry run's context-parallel prefill cells
(`repro_torch/launch/dryrun.py`), musicgen-medium's 24 heads and
llama4-maverick's 40 on a 16-wide "model" axis, against the reference's
per-chip work (`_torch_dryrun_ref.REF_SERVE`, `probes/ref_dryrun_serve.py`):
each traced on a fake 16x16 world of fake "cpu" tensors.  Their attention
takes the chunked route on the host as on the card, so the host's peak
stands for the card's, and each is held within 1.3x the reference's.  A
file of its own, beside `test_torch_dryrun_serve.py`, so that `--dist
loadfile` gives the two longest traces their own worker.
"""
import pytest

from _torch_dryrun_ref import peak_within, ratio


@pytest.mark.parametrize("arch", ["musicgen-medium",
                                  "llama4-maverick-400b-a17b"])
def test_context_parallel_prefill_splits_the_queries(arch):
    """24 and 40 heads on a 16-wide "model" axis: the queries split over
    it by their sequence on the chunked route (the attention op is not
    reached), where every rank of it had attended every query.  Each
    query chunk's live scores, one float32 copy beside the bf16 ones,
    stay within `attention.SCORE_BYTES` (22.046 and 39.902 GB a chip
    with 1024-query chunks; musicgen-medium 3.869 GB, 2.19x the
    reference's, with two float32 copies of 64 queries' scores and the
    projections gathered whole), and the peak within 1.3x the
    reference's."""
    got, r = ratio(arch, "prefill_32k")
    assert got <= 1.05, got
    assert r["flash_calls"] == 0
    peak_within(arch, r)
