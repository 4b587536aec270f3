"""PyTorch port vs JAX package: the cross-block prefix (kernel K2).

The port's plain block prefix (smoothsde_tpu_torch/ops/ctcrw_fused.py
block_prefix_plain, the CPU stand-in for csrc/block_prefix.cu) against
the JAX `_block_prefix_pallas` run in Pallas interpret mode, on the
same per-block totals: forward with `_combine2` (14-comp CTCRW
filtering elements) and `_comb1` (5-comp scalar-state ones), reverse
with `_combine2_rev` (9-comp smoothing elements) and `_comb1_rev`
(3-comp), NB = 256 blocks per dim, d = 2, atol 1e-12.

The totals are real ones: the port's plain K1a/K3a (D1a/D3a for the
scalar-state elements) on a simulated two-track record, so the elements
are as conditioned as in a fit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothsde_tpu.ops import ctcrw_fused as jcf
from smoothsde_tpu.ops import diag_fused as jdf
from smoothsde_tpu.ops import kalman_smooth as jks
from smoothsde_tpu.ops import kalman_soa as jsoa
from smoothsde_tpu_torch.ops import ctcrw_fused as tcf
from smoothsde_tpu_torch.ops import diag_fused as tdf
from smoothsde_tpu_torch.ops.kalman_soa import prepare_ctcrw_data

D, NB = 2, 256
N = NB * tcf.STEPS_PER_LANE  # plan(D, N) gives exactly NB blocks


@pytest.fixture(scope="module")
def totals():
    rng = np.random.default_rng(11)
    times = np.cumsum(rng.uniform(0.2, 1.0, size=N))
    ids = (np.arange(N) >= N // 3).astype(int)
    obs = np.cumsum(rng.normal(size=(N, D)) * 0.2, axis=0)
    obs[rng.integers(0, N, size=40)] = np.nan
    p = tcf.plan(D, N)
    assert p.NB == NB
    data = prepare_ctcrw_data(obs, times, ids, dtype=torch.float64,
                              device="cpu")
    par = torch.tensor(np.column_stack([
        0.05 * rng.normal(size=(N, D)),
        np.log(2.0) + 0.1 * rng.normal(size=N),
        np.log(0.7) + 0.1 * rng.normal(size=N),
    ]))
    stack, bd = tcf.par_stack_from_data(par, data.yd, data.dtv, data.resetf,
                                        data.validf, p)
    h = torch.tensor([0.01], dtype=torch.float64)
    ftot = tcf.filter_totals_plain(stack, bd, h, 1.0, 10.0)
    prefix = tcf.block_prefix_plain(ftot, D, "filter", False)
    moments, _ = tcf.filter_scan_plain(stack, bd, prefix, h, 1.0, 10.0)
    stot = tcf.smooth_totals_plain(stack, moments)

    sysd = tdf.diag_system("OU_SSM", par, obs, times, ids, 0.1)
    rows = (sysd.t, sysd.q, sysd.c, sysd.yd, sysd.resetf, sysd.updatef, p)
    fwd = tdf.forward_stack(*rows)
    dtot = tdf.diag_filter_totals_plain(fwd, h, tdf.P0)
    dpre = tcf.block_prefix_plain(dtot, D, "diag_filter", False)
    dmom, _ = tdf.diag_filter_scan_plain(fwd, dpre, h, tdf.P0)
    dstot = tdf.diag_smooth_totals_plain(tdf.backward_stack(*rows), dmom)
    return {"filter": ftot, "smooth": stot, "diag_filter": dtot,
            "diag_smooth": dstot}


def _jax_prefix(tot, kind, reverse):
    args = {
        "filter": (jcf._ID_VALS, jcf._unpack_elem_full, jcf._pack_elem,
                   jsoa._combine2),
        "smooth": (jcf._ID_SM, jcf._unpack_sm, jcf._pack_sm,
                   jks._combine2_rev),
        # as the JAX package's _diag_fwd / _diag_bwd call it
        "diag_filter": (list(jdf._ID1), tuple, list, jdf._comb1),
        "diag_smooth": (list(jdf._ID1_SM), tuple, list, jdf._comb1_rev),
    }[kind]
    MID = D * NB // 128
    # lane = dd * NB + b, row-major over the (MID, 128) tile
    tiles = [jnp.asarray(c.numpy().reshape(MID, 128)) for c in tot]
    out = jcf._block_prefix_pallas(tiles, *args, NB, MID, jnp.float64,
                                   reverse=reverse, interpret=True)
    return np.stack([np.asarray(o).reshape(-1) for o in out])


@pytest.mark.parametrize("kind,reverse", [("filter", False),
                                          ("smooth", True),
                                          ("diag_filter", False),
                                          ("diag_smooth", True)])
def test_block_prefix_matches_jax_pallas(totals, kind, reverse):
    tot = totals[kind]
    got = tcf.block_prefix_plain(tot, D, kind, reverse).numpy()
    ref = _jax_prefix(tot, kind, reverse)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind,reverse", [("filter", False),
                                          ("smooth", True),
                                          ("diag_filter", False),
                                          ("diag_smooth", True)])
def test_block_prefix_matches_sequential_composition(totals, kind, reverse):
    """Exclusive prefix == the left-to-right (right-to-left when
    reverse) sequential composition, per dim, identity at the edge."""
    k = tcf.ELEMS[kind]
    tot = totals[kind]
    got = tcf.block_prefix_plain(tot, D, kind, reverse)
    C = tot.shape[0]
    x = tot.reshape(C, D, NB)
    order = range(NB - 1, -1, -1) if reverse else range(NB)
    carry = k.unpack([torch.full((D,), v, dtype=tot.dtype)
                      for v in k.id_vals])
    ref = torch.empty_like(x)
    for b in order:
        ref[:, :, b] = torch.stack(k.pack(carry))
        carry = k.combine(carry, k.unpack(x[:, :, b].unbind(0)))
    np.testing.assert_allclose(got.numpy(), ref.reshape(C, -1).numpy(),
                               rtol=0, atol=1e-12)
