"""The port's banded multiblock SGNS superstep against smore_tpu's Pallas
kernel (interpret mode on the CPU). The CUDA kernel is held to the same
twin on the card by tests/test_torch_gpu.py.

On the CPU the port's wrapper runs its twin; smore_tpu's kernel runs on
2-row-folded copies of the same tables. Tolerance rtol 2e-5, atol 1e-6
(the Pallas suite's): both sides are f32 and differ only in the order of
the dot-product and matmul sums."""

import ctypes
import glob
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smore_tpu.ops.pallas_sgns_banded import (
    fold_table,
    sgns_banded_multiblock as jax_multiblock,
    unfold_table,
)
from smore_tpu_torch.ops import scatter as scatter_ops
from smore_tpu_torch.ops import sgns as sgns_ops
from smore_tpu_torch.ops import sgns_banded as sgns_banded_ops
from smore_tpu_torch.ops.sgns_banded import sgns_banded_multiblock
from torch_superstep_inputs import ALL_COLLIDE, multiblock_inputs

# one intra-op thread: test workers share the cores, and a thread pool
# in each of them oversubscribes the CPU on these tiny shapes
torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 1e-6


_inputs = multiblock_inputs


CASES = {
    # step 2 revisits step 0's band pair; step 3 has sb == db
    "s4_b128_revisit": dict(seed=0, S=4, B=128, band=64, n_bands=4, Ks=16,
                            D=64, sb=[1, 2, 1, 2], db=[2, 1, 2, 2]),
    # two tiles of 1024: the second tile gathers the first tile's writes
    "s2_b2048_two_tiles": dict(seed=1, S=2, B=2048, band=64, n_bands=3,
                               Ks=128, D=64, sb=[0, 2], db=[1, 2]),
    # 16 distinct rows per side: duplicates within and across tiles
    "s2_b2048_duplicates": dict(seed=2, S=2, B=2048, band=64, n_bands=3,
                                Ks=32, D=64, sb=[1, 1], db=[1, 0],
                                idx_hi=16),
    # every source and positive row of the superstep is one vertex (the
    # card test holds the CUDA kernel to these inputs too)
    "s2_b2048_all_collide": ALL_COLLIDE,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_matches_pallas_kernel(case):
    c = dict(CASES[case])
    band = c["band"]
    x = _inputs(**c)
    jv, jc, jd, jl = jax_multiblock(
        fold_table(jnp.asarray(x["wv"])), fold_table(jnp.asarray(x["wc"])),
        jnp.asarray(x["sb"]), jnp.asarray(x["db"]),
        jnp.asarray(x["src_l"]), jnp.asarray(x["pos_l"]),
        jnp.asarray(x["cn"]), jnp.asarray(x["alpha"]),
        band_size=band, interpret=True,
    )
    t = {k: torch.from_numpy(v.copy()) for k, v in x.items()}
    before = sgns_banded_multiblock.launches
    tv, tc, td, tl = sgns_banded_multiblock(
        t["wv"], t["wc"], t["sb"], t["db"], t["src_l"], t["pos_l"],
        t["cn"], t["alpha"], band_size=band, k_equiv=5,
    )
    assert sgns_banded_multiblock.launches == before  # CPU: twin, no kernel
    assert tv is t["wv"] and tc is t["wc"]  # updated in place
    np.testing.assert_allclose(tv.numpy(), np.asarray(unfold_table(jv)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(unfold_table(jc)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL, atol=ATOL)
    # the update really happened
    assert not np.allclose(tv.numpy(), x["wv"])


def _cpu_args():
    x = _inputs(**CASES["s4_b128_revisit"])
    return [torch.from_numpy(x[k]) for k in
            ("wv", "wc", "sb", "db", "src_l", "pos_l", "cn", "alpha")]


@pytest.mark.parametrize("bad", ["cn_rank", "wv_dtype", "alpha_len",
                                 "pos_shape", "batch_tile"])
def test_wrapper_rejects_bad_inputs(bad):
    wv, wc, sb, db, src, pos, cn, alpha = _cpu_args()
    if bad == "cn_rank":
        cn = cn[0]
    elif bad == "wv_dtype":
        wv = wv.double()
    elif bad == "alpha_len":
        alpha = alpha[:2]
    elif bad == "pos_shape":
        pos = pos[:, :64]
    else:
        src, pos = src[:, :100], pos[:, :100]
    with pytest.raises(ValueError):
        sgns_banded_multiblock(wv, wc, sb, db, src, pos, cn, alpha,
                               band_size=64)


def test_wrapper_has_no_fallback_off_cpu():
    """A device that is neither the CPU nor a CUDA card gets an error,
    never the twin."""
    args = [a.to("meta") for a in _cpu_args()]
    with pytest.raises(ValueError, match="no kernel"):
        sgns_banded_multiblock(*args, band_size=64)


# Each CUDA launcher's extern "C" signature against the ctypes argtypes its
# wrapper passes: a mismatch in count or kind corrupts the arguments on the
# card and shows nothing on the CPU.
_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "smore_tpu_torch", "csrc")
_LAUNCHERS = sorted(os.path.basename(f)[:-3]
                    for f in glob.glob(os.path.join(_CSRC, "*.cu")))


def _c_kinds(name):
    """'p', 'i' or 'f' for each parameter of ``int <name>_launch(...)``."""
    with open(os.path.join(_CSRC, f"{name}.cu")) as f:
        src = f.read()
    extern = src[src.index('extern "C"'):]
    m = re.search(rf"\bint\s+{name}_launch\s*\(([^)]*)\)", extern)
    assert m, f"no extern \"C\" {name}_launch in csrc/{name}.cu"
    kinds = []
    for param in m.group(1).split(","):
        param = " ".join(param.split())
        kinds.append("p" if "*" in param else
                     "f" if re.match(r"(const )?float\b", param) else
                     "i" if re.match(r"(const )?int\b", param) else param)
    return kinds


def _ctypes_kinds(argtypes):
    return [{ctypes.c_void_p: "p", ctypes.c_int: "i",
             ctypes.c_float: "f"}[t] for t in argtypes]


@pytest.mark.parametrize("name", _LAUNCHERS)
def test_launch_signature_matches_ctypes(name):
    argtypes = {**sgns_banded_ops.LAUNCH_ARGTYPES, **sgns_ops.LAUNCH_ARGTYPES,
                **scatter_ops.LAUNCH_ARGTYPES}
    assert name in argtypes, f"no wrapper binds csrc/{name}.cu"
    assert _c_kinds(name) == _ctypes_kinds(argtypes[name])
