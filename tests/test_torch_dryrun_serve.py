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
targets (1.05x the reference's FLOPs a chip; 1.02x for the SSD's, whose
channels and C B^T product are shared evenly over "model", and for
recurrentgemma-2b's long_500k, whose p . v heads are); every other cell
equal to the reference's to 1e-3 (`test_torch_dryrun_serve_equal.py`).
The host's attention route for a dense prefill is the flash op's plain
version, whose (S, S) scores do not stand for the card's memory, so
peaks are held only where the host's route is the card's: decode, the
recurrent and SSD cells, and the context-parallel prefills, which take
the chunked route on both (`test_torch_dryrun_serve_cp.py`) - every such
prefill's peak within 1.3x the reference's.  Cheap 2-layer traces hold
the dense prefill's cache to each rank's block and the SSD's
in-projection to each rank's share.
"""
import dataclasses

import pytest

from _torch_dryrun_ref import CHIP_BYTES, REF_SERVE, peak_within, ratio
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.launch import dryrun


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
    peak_within("recurrentgemma-2b", r, mesh)


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
    assert got <= 1.02, got
    assert r["memory"]["peak_bytes"] < CHIP_BYTES


def test_ssd_prefill_within_the_reference_head_split():
    """mamba2-130m prefill_32k: the SSD shares its 1536 channels 96 a
    rank over the 16 ranks of "model" (its 24 heads split evenly over no
    16-wide axis: two a rank had run 1.33x the even share of the
    inter-chunk products), the intra-chunk product on the heads a rank's
    channels touch (two, as the reference's 24 heads padded to 32), and
    the heads' shared C B^T on a share of the chunks, where every rank
    of "model" had repeated it (1.1309x the reference's FLOPs a chip);
    the peak within 1.3x the reference's (2.144 GB, 1.50x, while the
    in-projection and the gated norm ran on whole channels)."""
    got, r = ratio("mamba2-130m", "prefill_32k")
    assert got <= 1.02, got
    peak_within("mamba2-130m", r)


def test_recurrentgemma_long_context_decode_shares_the_pv_heads():
    """recurrentgemma-2b long_500k (one row against 2048 ring slots, 128
    a rank of "model"): p . v runs a share of the 10 heads on each rank
    that holds the same slots, where each ran all 10 (1.0860x the
    reference's FLOPs a chip); the gates' weights stay split for the
    decode token, its activation gathered instead (5.5x the reference's
    collective bytes a chip)."""
    got, r = ratio("recurrentgemma-2b", "long_500k")
    assert got <= 1.02, got
    ref_coll = REF_SERVE["recurrentgemma-2b|long_500k|16x16"][2]
    assert r["collective_bytes_per_chip"] <= 2 * ref_coll, \
        r["collective_bytes_per_chip"]
    assert r["memory"]["peak_bytes"] < CHIP_BYTES


def test_a_sharded_prefill_builds_no_whole_cache():
    """A 2-layer stablelm-width prefill (d 2048, 32 KV heads of 64; a
    512-token vocabulary, so that the embedding's gather does not set
    the peak) of 16 x 256 tokens on a fake 4x4 world: each rank builds
    its block of the KV cache (4 rows, 64 slots), so no storage live at
    the peak is as large as one layer's whole k (16.8 MB), and the peak
    stays under the 67.1 MB that gathering k and v whole and building
    both caches whole took."""
    cfg = dataclasses.replace(get_config("stablelm-1.6b"), n_layers=2,
                              vocab=512)
    b, s = 16, 256
    run = RunConfig(model=cfg, mode="prefill", seq_len=s, global_batch=b)
    r = dryrun.lower_cell("stablelm-1.6b", "prefill_32k", run_override=run,
                          mesh_shape=(4, 4), device="cpu")
    whole_k = b * s * cfg.kv_heads * cfg.head_dim * 2
    live = r["peak_live"]
    assert live and all(e["bytes"] < whole_k for e in live), live
    assert [2, b // 4, s // 4, cfg.kv_heads, cfg.head_dim] in [
        e["shape"] for e in live], live
    assert r["memory"]["temp_bytes"] < 4 * whole_k, r["memory"]


def test_a_sharded_ssd_prefill_gathers_no_whole_in_projection():
    """A 2-layer mamba2-130m prefill_32k (its widths, rows and tokens) on
    the 16x16 fake world: each rank of "model" gathers B, C and dt whole
    but z and x on its channels alone, and runs the conv and the gated
    norm there, so no storage live at the peak is the in-projection
    gathered whole, (2, 32768, 3352) bf16 (0.439 GB), or as large."""
    cfg = dataclasses.replace(get_config("mamba2-130m"), n_layers=2)
    run = dataclasses.replace(
        dryrun.make_run_config(get_config("mamba2-130m"), "prefill_32k"),
        model=cfg)
    r = dryrun.lower_cell("mamba2-130m", "prefill_32k", run_override=run,
                          device="cpu")
    b, s = run.global_batch // 16, run.seq_len
    d_inner = cfg.ssm_expand * cfg.d_model
    f = 2 * d_inner + 2 * cfg.ssm_state + d_inner // cfg.ssm_head_dim
    whole = b * s * f * 2
    live = r["peak_live"]
    assert live and all(e["shape"] != [b, s, f] and e["bytes"] < whole
                        for e in live), live
