"""Design probe: the arena kernel's product on the CUDA cores or the
tensor cores.

Builds `probes/arena_product.cu` (nvcc, sm_90a, into `probes/build/`) and
times, at the two shapes of `chip_smoke.py` phase 3 where the choice
matters, a chain of T dependent 64 x 64 tile products y <- A y + y0 per
block, the arena kernel's grid (its column slice KB, its blocks) and its
shared memory a block (so as many blocks share an SM):

  main path  M=16, K=8:    KB=1,  128 blocks
  wide       M=128, K=128: KB=16, 1024 blocks

with FMAs as `csrc/arena_mvm.cu` issues them (8 warps, the halving
butterfly); as 3xTF32 `wgmma` with A split once (one warpgroup, m64n8k8
or m64n16k8, 24 a tile: the tensor cores' best case); and, at 16
columns, as a kernel instance would have to run them (`tc_split`: A
split into the tiles on the chain every tile by two warpgroups, each
running 24 m64n8k8 for 8 columns), at the FMA instance's blocks an SM and
at one block an SM (what the split tiles' 40 KB of shared memory leave
at this case).  Each variant is first held to a float64 evaluation on
the host at 1e-5 of max|y|.  Times are CUDA-event medians of 7 batches
of 20 launches at T=23 (the Fig. 8 program) and T=230; a tile of the chain
is their difference over 207.

    python3 probes/arena_product.py         (on a card; exits 2 without)
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
REL_TOL = 1e-5


def _build() -> ctypes.CDLL:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels._build import NVCC_FLAGS, _nvcc
    out = ROOT / "probes" / "build" / "libarena_product.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(out),
         str(ROOT / "probes" / "arena_product.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.probe_run.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                              + [ctypes.c_int] * 2
                              + [ctypes.c_longlong, ctypes.c_void_p])
    lib.probe_run.restype = ctypes.c_int
    return lib


def _time_ms(fn, reps=7, per_batch=20):
    times = []
    for _ in range(reps):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(per_batch):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / per_batch)
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("arena_product: no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {smi}")
    lib = _build()
    from repro_torch.kernels import arena_mvm
    from repro_torch.kernels._launch import smem_optin
    dev = torch.device("cuda")
    arena_lib, _ = arena_mvm._entry()
    rng = np.random.default_rng(17)
    results = []
    ok = True
    for label, m, k in (("main path", 16, 8), ("wide", 128, 128)):
        s, t_prog, j, c = 704, 23, 3, 64      # the Fig. 8 program (phase 3)
        inst, kb, stages = arena_mvm.device_plan(dev, m, s, k, t_prog, c, j)
        blocks = m * -(-k // kb)
        pad = arena_lib.arena_smem_bytes(s, t_prog, j, c, kb, stages)
        a = (rng.normal(size=(blocks, 64, 64)) * 0.5 / 8).astype(np.float32)
        y0 = rng.uniform(-1, 1, (blocks, 64, kb)).astype(np.float32)
        ops_d, y0_d = torch.from_numpy(a).to(dev), torch.from_numpy(y0).to(dev)
        out = torch.empty_like(y0_d)
        want = y0.astype(np.float64)
        for _ in range(t_prog):
            want = a.astype(np.float64) @ want + y0
        row = dict(case=label, kb=kb, blocks=blocks, arena_instance=inst,
                   smem_a_block=pad)
        variants = [("fma", 0, pad), ("tc_3xtf32", 1, pad)]
        if kb == 16:
            variants += [("tc_split", 2, pad),
                         ("tc_split_one_block_an_sm", 2, smem_optin(dev))]
        for name, tc, smem in variants:
            def run(t, tc=tc, smem=smem):
                st = torch.cuda.current_stream().cuda_stream
                err = lib.probe_run(tc, kb, ops_d.data_ptr(),
                                    y0_d.data_ptr(), out.data_ptr(), blocks,
                                    t, smem, st)
                if err:
                    raise RuntimeError(f"{name} launch failed: {err}")
            run(t_prog)
            torch.cuda.synchronize()
            err = float(np.abs(out.cpu().numpy() - want).max())
            scale = float(np.abs(want).max())
            good = err <= REL_TOL * scale
            ok &= good
            ms23 = _time_ms(lambda: run(t_prog))
            ms230 = _time_ms(lambda: run(10 * t_prog))
            tile = (ms230 - ms23) / (9 * t_prog)
            row[name] = dict(ms_T23=ms23, ms_T230=ms230, tile_ms=tile,
                             max_abs_err=err, ok=good, smem_a_block=smem)
            print(f"{label} KB={kb} {blocks} blocks {name}: T=23 "
                  f"{ms23:.4f} ms, T=230 {ms230:.4f} ms, a tile "
                  f"{tile:.5f} ms; max abs err {err:.3e} "
                  f"({'ok' if good else 'FAILS'} at {REL_TOL} of {scale:.3f})")
        results.append(row)
    print(json.dumps({"card": smi, "arena_product_probe": results}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
