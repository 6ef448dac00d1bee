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
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smore_tpu.ops.pallas_sgns_banded import (
    fold_table,
    sgns_banded_multiblock as jax_multiblock,
    unfold_table,
)
from smore_tpu_torch.ops import launches
from smore_tpu_torch.ops.sgns_banded import K4, sgns_banded_multiblock
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
    before = K4.launches
    tv, tc, td, tl = sgns_banded_multiblock(
        t["wv"], t["wc"], t["sb"], t["db"], t["src_l"], t["pos_l"],
        t["cn"], t["alpha"], band_size=band, k_equiv=5,
    )
    assert K4.launches == before  # CPU: twin, no kernel
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
# Kernel passes: a mismatch in count or kind corrupts the arguments on the
# card and shows nothing on the CPU.
_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "smore_tpu_torch", "csrc")
_KERNELS = launches.declared()


def _extern(name):
    with open(os.path.join(_CSRC, f"{name}.cu")) as f:
        src = f.read()
    return src[src.index('extern "C"'):]


def _c_kinds(name, symbol):
    """'p', 'i' or 'f' for each parameter of ``int <symbol>(...)``."""
    m = re.search(rf"\bint\s+{symbol}\s*\(([^)]*)\)", _extern(name))
    assert m, f"no extern \"C\" {symbol} in csrc/{name}.cu"
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


@pytest.mark.parametrize("name", sorted(_KERNELS))
def test_launch_signature_matches_ctypes(name):
    k = _KERNELS[name]
    assert _c_kinds(name, k.symbol) == _ctypes_kinds(k.argtypes)


@pytest.mark.parametrize(
    "name", sorted(n for n, k in _KERNELS.items() if k.counted))
def test_each_counted_kernel_exports_its_graph_node_count(name):
    """Every kernel that ``ops/launches`` credits on replays has its own
    library, ``csrc/<name>.cu``, whose extern "C" block exports
    ``<name>_graph_launches`` and ``<name>_error_string`` through the
    macro of ``csrc/graph_nodes.cuh``, directly or through the superstep
    libraries' macro, and writes neither by hand."""
    extern = _extern(name)
    assert re.search(rf"\b(KERNEL|SUPERSTEP)_LIBRARY_EXPORTS\(\s*{name}\s*,",
                     extern)
    assert not re.search(r"_(graph_launches|error_string)\s*\(", extern)


def test_every_kernel_source_is_bound_by_exactly_one_kernel():
    """Each ``csrc/*.cu`` is one declared ``Kernel``'s library, and each
    declared ``Kernel`` has its file: the registry names each library once,
    by its file's name."""
    sources = sorted(os.path.basename(f)[:-3]
                     for f in glob.glob(os.path.join(_CSRC, "*.cu")))
    assert sources == sorted(_KERNELS)
    assert all(k.name == n for n, k in _KERNELS.items())
    with pytest.raises(ValueError, match="declared twice"):
        launches.Kernel(sources[0], [])


class _FakeLib:
    """A library whose launcher returns ``rc`` and whose error string
    names it."""

    def __init__(self, rc):
        self.rc = rc

    def fake_launch(self, *args):
        return self.rc

    def fake_error_string(self, rc):
        return f"fake error {rc}".encode()


@pytest.mark.parametrize("rc", [0, 700])
def test_a_failed_launch_raises_with_its_library_string_and_counts_nothing(
        monkeypatch, rc):
    monkeypatch.setattr(launches, "_kernels", {})
    k = launches.Kernel("fake", [ctypes.c_int, ctypes.c_void_p])
    lib = _FakeLib(rc)
    k._lib, k._launch = lib, lib.fake_launch
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    dev = torch.device("cuda", 0)
    if rc:
        with pytest.raises(RuntimeError,
                           match=r"fake launch failed: CUDA error 700 "
                                 r"\(fake error 700\)"):
            k.launch(dev)
        assert k.launches == 0
    else:
        k.launch(dev)
        assert k.launches == 1


def test_a_kernel_declared_after_read_is_seen_by_moved_and_recorded(
        monkeypatch):
    """A launcher module first imported after ``read()`` declares its
    kernel then: ``moved`` counts it from 0, ``recorded`` takes its capture
    launches back and credits a replay its graph's."""
    monkeypatch.setattr(launches, "_kernels", dict(launches._kernels))
    before = launches.read()
    late = launches.Kernel("late", [])
    late.launches += 3
    assert launches.moved(before) == {"late": 3}
    replay = launches.recorded(before, {"late": 3})
    assert late.launches == 0 and launches.moved(before) == {}
    launches.credit(replay)
    assert launches.moved(before) == {"late": 3}
