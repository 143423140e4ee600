"""The port's dry run of the serving cells and the paper's solver cell
(`repro_torch/launch/dryrun.py`) against the reference's per-chip work.

The reference's numbers are `_torch_dryrun_ref.REF_SERVE`, copied from
`python probes/ref_dryrun_serve.py` (jax 0.9.0, 256 or 512 fake XLA
host devices; nothing of the JAX package is imported here).  Each cell
is traced here on a fake world of fake "cpu" tensors (a torch built
without CUDA runs no method of a fake "cuda" one); `chip_smoke.py` phase
19 (d) traces the 16x16 cells on the card's host with fake "cuda" ones.

Held: the paper's solver at n=2048 with A split over the 16x16 mesh -
its FLOPs a chip within 2x the reference's and its arguments A's 1/256
block; the serving cells repaired for the production mesh within their
targets (1.05x the reference's FLOPs a chip; 1.15x for the SSD's, whose
24 heads the reference also splits unevenly over 16); every other cell
equal to the reference's to 1e-3 (`test_torch_dryrun_serve_equal.py`).
The host's attention route for a dense prefill is the flash op's plain
version, whose (S, S) scores do not stand for the card's memory, so
peaks are held to a chip's 80 GB only where the host's route is the
card's: decode, the recurrent and SSD cells, and the context-parallel
prefills, which take the chunked route on both.
"""
import pytest

from _torch_dryrun_ref import CHIP_BYTES, ratio


def test_the_solver_splits_a_and_its_gemms_over_the_mesh():
    """BlockAMC at n=2048, one stage, on 16x16 (the reference's
    `lower_solver_cell`): A comes in split over ("data", "model"), each
    chip holding its 128 x 128 block beside the whole b, the Schur
    pre-processing's GEMMs run on local blocks, each chip programs its
    own tiles, and the FLOPs a chip stay within 2x the reference's
    (266.8x while every chip built the whole plan from the whole A)."""
    got, r = ratio("blockamc-solver", "n2048_s1")
    assert got <= 2.0, (got, r["flops_per_chip"])
    assert r["memory"]["argument_bytes"] == (2048 // 16) ** 2 * 4 + 2048 * 4
    assert not any("plan" in d for d in r["differences"]), r["differences"]
    assert r["memory"]["peak_bytes"] < CHIP_BYTES


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_recurrentgemma_prefill_traces(mesh):
    """recurrentgemma-2b prefill_32k: the RG-LRU's gates are laid out as
    its input (rows and channels split, the sequence whole) before the
    scan, where a product over split channels had been reduced into a
    split of the sequence and the scan raised."""
    got, r = ratio("recurrentgemma-2b", "prefill_32k", mesh)
    assert got <= 1.05, got
    assert r["memory"]["peak_bytes"] < CHIP_BYTES


@pytest.mark.parametrize("arch", ["musicgen-medium",
                                  "llama4-maverick-400b-a17b"])
def test_context_parallel_prefill_splits_the_queries(arch):
    """24 and 40 heads on a 16-wide "model" axis: the queries split over
    it by their sequence on the chunked route (the attention op is not
    reached), where every rank of it had attended every query."""
    got, r = ratio(arch, "prefill_32k")
    assert got <= 1.05, got
    assert r["flash_calls"] == 0
    assert r["memory"]["peak_bytes"] < CHIP_BYTES


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_decode_routes_each_ranks_rows(arch):
    """decode_32k's 128 tokens make two dispatch groups over 16 "data"
    ranks: each rank routes its own rows, the (token, choice) experts
    alone are gathered, and the buffer's items are dealt out over the
    ranks, where every rank had routed every token and run both
    groups' slots."""
    got, r = ratio(arch, "decode_32k")
    assert got <= 1.05, got
    assert r["memory"]["peak_bytes"] < CHIP_BYTES


@pytest.mark.parametrize("shape,mesh", [("decode_32k", "16x16"),
                                        ("decode_32k", "2x16x16"),
                                        ("long_500k", "16x16")])
def test_ssd_serving_shares_the_model_axis(shape, mesh):
    """mamba2-130m's decode: the in-projection's 3352 features and the
    state's read-out channels shared over the ranks that do not split
    the batch ("model"; all 256 for long_500k's one row), where every
    rank had run them whole."""
    got, r = ratio("mamba2-130m", shape, mesh)
    assert got <= 1.15, got
    assert r["memory"]["peak_bytes"] < CHIP_BYTES


def test_ssd_prefill_within_the_reference_head_split():
    """mamba2-130m prefill_32k (within its target before the serving
    repairs too): the SSD shares its 24 heads two a rank over the 16
    ranks of "model", the reference pads them to 32 (`PERF.md`)."""
    got, r = ratio("mamba2-130m", "prefill_32k")
    assert got <= 1.15, got
    assert r["memory"]["peak_bytes"] < CHIP_BYTES
