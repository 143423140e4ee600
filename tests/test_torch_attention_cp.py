"""The port's chunked attention route on a share of the queries - the
context-parallel prefill's core, where each rank attends its share of
the queries, with their positions, to the whole keys - against the
reference's `repro.models.attention._chunked_attend` over all the
queries, on a CPU host.

The same seeded numpy q, k, v and positions go to both; the port takes
the queries [8, 24) of 32 with their positions (`q_positions`) as the
sharded route calls it (`one_copy`), in chunks of 4 and 8, causal and
under a sliding window, outside autograd (its in-place softmax:
`attention._weights_in_place`) and while autograd records (the
out-of-place route that training differentiates), and its rows are held
to the reference's.  Tolerances (`TESTING.md`): float32
rtol 1e-5 / atol 1e-6; bfloat16 3e-2, the attention kernel's in-model
bfloat16 tolerance (`test_torch_kernels.py::test_flash_dtypes_match_jax`).

A fake trace (`launch/hlo_analysis.analyze`) counts the float32 copies
of a chunk's scores live at the route's peak: one outside autograd, at
least two (the cast and the softmax) while autograd records.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as j_get_config
from repro.models import attention as jattn
from repro_torch.launch import hlo_analysis
from repro_torch.models import attention as tattn
from tests.conftest import reduce_cfg

B, S, H, KV, HD = 2, 32, 4, 2, 16
FIRST, N = 8, 16                # the share of the queries: [8, 24)
TOL = {"float32": (1e-5, 1e-6), "bfloat16": (3e-2, 3e-2)}


def _inputs():
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((B, S, H, HD), (B, S, KV, HD), (B, S, KV, HD)))
    # each row's positions start elsewhere, as a ragged batch's would
    pos = (np.arange(S)[None] + np.array([[0], [5]])).astype(np.int32)
    jcfg = dataclasses.replace(reduce_cfg(j_get_config("glm4-9b")),
                               n_heads=H, kv_heads=KV, head_dim=HD)
    return q, k, v, pos, jcfg


def _port(q, k, v, pos, dtype, window, chunk, grad):
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    tk, tv = (torch.repeat_interleave(t, H // KV, dim=2) for t in (tk, tv))
    tpos = torch.from_numpy(pos).long()
    share = tq[:, FIRST:FIRST + N]
    if grad:
        share.requires_grad_(True)
    with torch.set_grad_enabled(grad):
        out = tattn._chunked_attend(share, tk, tv, tpos, window, chunk,
                                    tpos[:, FIRST:FIRST + N], one_copy=True)
    return out.detach().float().reshape(B, N, H * HD).numpy()


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("chunk", [4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_query_share_matches_the_reference(dtype, chunk, window, grad):
    """The port's route on queries [8, 24) with their positions equals
    the reference's `_chunked_attend` on all 32 at those rows."""
    q, k, v, pos, jcfg = _inputs()
    want = jattn._chunked_attend(
        *(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)),
        jnp.asarray(pos), jcfg, window, chunk)
    want = np.asarray(want, np.float32)[:, FIRST:FIRST + N]
    got = _port(q, k, v, pos, getattr(torch, dtype), window, chunk, grad)
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("grad", [False, True])
def test_one_float32_copy_of_a_chunks_scores(grad):
    """On fake bfloat16 tensors (1 row, 4 heads, 8 of 64 queries a chunk,
    256 keys): the float32 storages of a chunk's scores (1, 4, 8, 256)
    live at the route's peak are one outside autograd - the mask and the
    softmax write into the cast, and no chunk's scores outlive it - and
    at least two while autograd records (the cast and the softmax's
    output, as the reference's ops; autograd keeps each chunk's)."""
    with FakeTensorMode():
        q = torch.empty((1, 64, 4, 16), dtype=torch.bfloat16)
        k, v = (torch.empty((1, 256, 4, 16), dtype=torch.bfloat16)
                for _ in range(2))
        pos = torch.arange(256)[None]
        if grad:
            q.requires_grad_(True)
        with torch.set_grad_enabled(grad):
            r = hlo_analysis.analyze(tattn._chunked_attend, q, k, v, pos,
                                     None, 8, pos[:, 192:], True)
    scores = [e for e in r["peak_live"]
              if e["shape"] == [1, 4, 8, 256] and e["dtype"] == "float32"]
    assert (len(scores) >= 2) if grad else (len(scores) == 1), \
        r["peak_live"]
