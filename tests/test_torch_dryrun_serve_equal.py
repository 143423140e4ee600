"""The serving cells whose per-chip FLOPs already counted the
reference's before the serving repairs (`test_torch_dryrun_serve.py`):
each traced on a fake 16x16 world of fake "cpu" tensors
(`launch/dryrun.py`) and held to the reference's FLOPs a chip
(`_torch_dryrun_ref.REF_SERVE`, `probes/ref_dryrun_serve.py`) to 1e-3,
and a decode's peak to a chip's 80 GB (a dense prefill's host route, the
flash op's plain version, does not stand for the card's memory)."""
import pytest

from _torch_dryrun_ref import CHIP_BYTES, ratio

EQUAL_TOL = 1e-3

EQUAL = ([(a, "decode_32k") for a in (
    "glm4-9b", "chatglm3-6b", "command-r-35b", "pixtral-12b",
    "stablelm-1.6b", "musicgen-medium", "recurrentgemma-2b")]
    + [(a, "prefill_32k") for a in (
        "glm4-9b", "chatglm3-6b", "command-r-35b", "pixtral-12b",
        "stablelm-1.6b", "phi3.5-moe-42b-a6.6b")])


@pytest.mark.parametrize("arch,shape", EQUAL)
def test_cells_that_count_the_reference_flops(arch, shape):
    """The other traced serving cells count the reference's FLOPs a chip
    to 1e-3 (a decode's peak within a chip)."""
    got, r = ratio(arch, shape)
    assert abs(got - 1.0) <= EQUAL_TOL, got
    if shape == "decode_32k":
        assert r["memory"]["peak_bytes"] < CHIP_BYTES
