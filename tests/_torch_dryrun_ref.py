"""The reference's dry-run numbers for the serving and solver cells
(`REF_SERVE`) and the port's traces of them, shared by
`tests/test_torch_dryrun_serve.py`, `test_torch_dryrun_serve_cp.py` and
`test_torch_dryrun_serve_equal.py` (three files, so that `--dist
loadfile` gives each its own worker).  Imports nothing of the JAX
package."""
import functools

from repro_torch.launch import dryrun

CHIP_BYTES = 80e9
PEAK_REF = 1.3          # a prefill's peak a chip against the reference's

# The reference's cells, a chip's (peak bytes - XLA's argument + temp -,
# FLOPs, collective bytes), keyed "arch|shape|mesh", as
# `PYTHONPATH=src python probes/ref_dryrun_serve.py --mesh 16x16` (and
# `--mesh 2x16x16`) prints them.
REF_SERVE = {
    "blockamc-solver|n2048_s1|16x16": (157378376, 24903680.0, 5587976.0),
    "blockamc-solver|n16384_s2|16x16": (844361544, 16099573760.0, 231107592.0),
    "recurrentgemma-2b|prefill_32k|16x16":
        (5371148016, 29334790471680.0, 48257264144.0),
    "recurrentgemma-2b|decode_32k|16x16":
        (371513492, 2977955840.0, 51483776.0),
    "recurrentgemma-2b|long_500k|16x16": (60312696, 30474240.0, 481884.0),
    "llama4-maverick-400b-a17b|prefill_32k|16x16":
        (23198684104, 239144037908480.0, 270685728784.0),
    "llama4-maverick-400b-a17b|decode_32k|16x16":
        (26542204924, 74535403520.0, 6378538880.0),
    "phi3.5-moe-42b-a6.6b|prefill_32k|16x16":
        (8581007936, 133178378944512.0, 122233536528.0),
    "phi3.5-moe-42b-a6.6b|decode_32k|16x16":
        (8990844348, 90596966400.0, 902047872.0),
    "pixtral-12b|prefill_32k|16x16":
        (6520656592, 177296417751040.0, 118344990736.0),
    "pixtral-12b|decode_32k|16x16": (10025609132, 22313697280.0, 206602368.0),
    "glm4-9b|prefill_32k|16x16":
        (4690658416, 154790776537088.0, 95828705296.0),
    "glm4-9b|decode_32k|16x16": (2788086284, 19516096512.0, 161892480.0),
    "stablelm-1.6b|prefill_32k|16x16":
        (1980244784, 36490093527040.0, 28477161488.0),
    "stablelm-1.6b|decode_32k|16x16": (11636419660, 4659871744.0, 27672704.0),
    "command-r-35b|prefill_32k|16x16":
        (9861104464, 406819826565120.0, 191415320592.0),
    "command-r-35b|decode_32k|16x16":
        (10905622444, 51757711360.0, 518504576.0),
    "chatglm3-6b|prefill_32k|16x16":
        (4538762224, 108353501528064.0, 65649311760.0),
    "chatglm3-6b|decode_32k|16x16": (1931547148, 13493075968.0, 110775424.0),
    "musicgen-medium|prefill_32k|16x16":
        (1767840792, 54425826361344.0, 70747594768.0),
    "musicgen-medium|decode_32k|16x16":
        (17164403860, 6646923264.0, 37232768.0),
    "mamba2-130m|prefill_32k|16x16":
        (1433217904, 926112006144.0, 38855439376.0),
    "mamba2-130m|decode_32k|16x16": (327004704, 133693440.0, 16219520.0),
    "mamba2-130m|long_500k|16x16": (47648580, 1056768.0, 1622924.0),
    "blockamc-solver|n2048_s1|2x16x16": (157378376, 24903680.0, 5587976.0),
    "blockamc-solver|n16384_s2|2x16x16":
        (844361544, 16099573760.0, 231107592.0),
    "recurrentgemma-2b|prefill_32k|2x16x16":
        (2829554288, 14667395235840.0, 23521342984.0),
    "recurrentgemma-2b|decode_32k|2x16x16":
        (352343684, 1488977920.0, 48392752.0),
    "recurrentgemma-2b|long_500k|2x16x16": (73460928, 58122240.0, 4145244.0),
    "llama4-maverick-400b-a17b|prefill_32k|2x16x16":
        (18406159176, 119572018954240.0, 137212825608.0),
    "llama4-maverick-400b-a17b|decode_32k|2x16x16":
        (20770801580, 61426892800.0, 6360895408.0),
    "phi3.5-moe-42b-a6.6b|prefill_32k|2x16x16":
        (4796435008, 66589189472256.0, 61466427400.0),
    "phi3.5-moe-42b-a6.6b|decode_32k|2x16x16":
        (5165606124, 85563801600.0, 890819648.0),
    "pixtral-12b|prefill_32k|2x16x16":
        (3475460816, 88648208875520.0, 59289149448.0),
    "pixtral-12b|decode_32k|2x16x16": (5260706652, 11156848640.0, 193822768.0),
    "glm4-9b|prefill_32k|2x16x16":
        (2524038128, 77395388268544.0, 46967128072.0),
    "glm4-9b|decode_32k|2x16x16": (1599623044, 9758048256.0, 149584944.0),
    "stablelm-1.6b|prefill_32k|2x16x16":
        (1032069808, 18245046763520.0, 13735886856.0),
    "stablelm-1.6b|decode_32k|2x16x16": (5865008124, 2329935872.0, 25108528.0),
    "command-r-35b|prefill_32k|2x16x16":
        (5540709072, 203409913282560.0, 93971087368.0),
    "command-r-35b|decode_32k|2x16x16":
        (6161272668, 25878855680.0, 495968304.0),
    "chatglm3-6b|prefill_32k|2x16x16":
        (2372142064, 54176750764032.0, 32879181832.0),
    "chatglm3-6b|decode_32k|2x16x16": (1095405444, 6746537984.0, 102140464.0),
    "musicgen-medium|prefill_32k|2x16x16":
        (909573144, 27212913180672.0, 35402182664.0),
    "musicgen-medium|decode_32k|2x16x16":
        (8607986628, 3323461632.0, 32845888.0),
    "mamba2-130m|prefill_32k|2x16x16":
        (705703024, 463056003072.0, 19429332488.0),
    "mamba2-130m|decode_32k|2x16x16": (172906640, 66846720.0, 9129648.0),
    "mamba2-130m|long_500k|2x16x16": (47648588, 1056768.0, 1610636.0),
}


@functools.lru_cache(maxsize=None)
def trace(arch, shape, mesh="16x16"):
    """The port's report of a cell, traced once a module."""
    if arch == "blockamc-solver":
        n, stages = (int(x[1:]) for x in shape.split("_"))
        return dryrun.lower_solver_cell(n=n, stages=stages, device="cpu",
                                        multi_pod=mesh == "2x16x16")
    return dryrun.lower_cell(arch, shape, multi_pod=mesh == "2x16x16",
                             device="cpu")


def ratio(arch, shape, mesh="16x16"):
    """(the port's FLOPs a chip over the reference's, the report)."""
    r = trace(arch, shape, mesh)
    assert r["mesh"] == mesh, r.get("error", r)
    return r["flops_per_chip"] / REF_SERVE[f"{arch}|{shape}|{mesh}"][1], r


def peak_within(arch, r, mesh="16x16"):
    """A prefill's peak a chip within PEAK_REF x the reference's."""
    peak = r["memory"]["peak_bytes"]
    bound = PEAK_REF * REF_SERVE[f"{arch}|prefill_32k|{mesh}"][0]
    assert peak <= bound, (peak, bound, r["peak_live"])
