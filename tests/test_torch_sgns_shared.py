"""The port's fused shared-negative SGNS gradients (kernel K1) against
smore_tpu's Pallas kernel (interpret mode on the CPU). The CUDA kernel is
held to the same twin on the card by tests/test_torch_gpu.py.

On the CPU the port's wrapper runs its twin. Tolerance rtol 1e-5, atol
1e-6 (the Pallas suite's, tests/test_pallas_sgns.py): both sides are f32
and differ only in the order of the dot-product and matmul sums; d_neg is
summed over 1024-row tiles by the TPU kernel and in one product here."""

import numpy as np
import pytest
import torch

from smore_tpu.ops.pallas_sgns import sgns_shared_grads_pallas
from smore_tpu_torch.ops.sgns import sgns_shared_grads, sgns_shared_grads_ref

# one intra-op thread: test workers share the cores, and a thread pool
# in each of them oversubscribes the CPU on these tiny shapes
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _inputs(seed, B, Ks, D):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * 0.3).astype(np.float32)
            for s in ((B, D), (B, D), (Ks, D))]


# the CUDA kernel's edges: B ragged against its 64-row tile, Ks not a
# multiple of 8, D = 128 (32-row tiles) and D not a multiple of 8
@pytest.mark.parametrize("B,Ks,D", [(2048, 128, 64), (1024, 64, 32),
                                    (200, 40, 64), (1000, 37, 64),
                                    (2048, 128, 128), (320, 13, 36)])
def test_twin_matches_pallas_kernel(B, Ks, D):
    v, cp, cn = _inputs(B + Ks + D, B, Ks, D)
    alpha = np.float32(0.025)
    want = sgns_shared_grads_pallas(v, cp, cn, alpha, k_equiv=5,
                                    interpret=True)
    before = sgns_shared_grads.launches
    got = sgns_shared_grads(torch.from_numpy(v), torch.from_numpy(cp),
                            torch.from_numpy(cn), torch.tensor(alpha),
                            k_equiv=5)
    assert sgns_shared_grads.launches == before  # CPU: twin, no kernel
    for name, g, w in zip(("d_src", "d_pos", "d_neg"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    assert float(got[2].abs().max()) > 0


def test_alpha_as_number_or_tensor():
    v, cp, cn = (torch.from_numpy(a) for a in _inputs(3, 64, 16, 8))
    a = sgns_shared_grads(v, cp, cn, 0.02, k_equiv=3)
    b = sgns_shared_grads_ref(v, cp, cn, torch.tensor(0.02), k_equiv=3)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _cpu_args():
    return [torch.from_numpy(a) for a in _inputs(0, 128, 16, 8)] + [
        torch.tensor(0.025)]


@pytest.mark.parametrize("bad", ["cp_shape", "cn_width", "v_dtype",
                                 "batch_tile", "alpha_shape"])
def test_wrapper_rejects_bad_inputs(bad):
    v, cp, cn, alpha = _cpu_args()
    if bad == "cp_shape":
        cp = cp[:64]
    elif bad == "cn_width":
        cn = cn[:, :4]
    elif bad == "v_dtype":
        v = v.double()
    elif bad == "batch_tile":
        v = torch.zeros(1100, 8)
        cp = torch.zeros(1100, 8)
    else:
        alpha = torch.ones(2)
    with pytest.raises(ValueError):
        sgns_shared_grads(v, cp, cn, alpha)


def test_wrapper_has_no_fallback_off_cpu():
    """A device that is neither the CPU nor a CUDA card gets an error,
    never the twin."""
    args = [a.to("meta") for a in _cpu_args()]
    with pytest.raises(ValueError, match="no kernel"):
        sgns_shared_grads(*args)
