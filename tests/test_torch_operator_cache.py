"""The operator disk cache (``fem.assemble_mass_stiffness*`` with
``cache_key``, the JAX package's ``fem.py:869-894, 1080-1165``), each test
in a cache directory of its own (``XDG_CACHE_HOME``):

- a hit returns the stencil pair of the Niederer slab and the ELL pair of
  the LV (its COO tail included) and of a P2 space bit for bit equal to a
  fresh assembly, and is read from the slot, not assembled;
- the key only opts in: the same key with another conductivity, dtype or
  mesh misses, and ``max_offsets`` keys a stencil slot too;
- the solvers pass their keys through: ``FusedMonodomainSolver`` and
  ``ECGRecovery`` (``operator_cache_key``) and ``BidomainSolver``
  (``cache_key`` with ``|i`` and ``|e``, ``bidomain.py:208-217`` there),
  each run on a warm slot equal to its run on a cold one.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fenicsx_beat_tpu_torch import cache, fem
from fenicsx_beat_tpu_torch.benchmarks import bidomain_scale as tbs
from fenicsx_beat_tpu_torch.benchmarks import niederer as tnied
from fenicsx_beat_tpu_torch.conductivities import as_cell_tensors
from fenicsx_beat_tpu_torch.ecg import ECGRecovery
from fenicsx_beat_tpu_torch.geometry import get_lv_ellipsoid_geometry
from fenicsx_beat_tpu_torch.ops.sparse import ELLMatrix, StencilMatrix


@pytest.fixture(autouse=True)
def cache_home(tmp_path, monkeypatch):
    """A cache directory of the test's own, and one torch thread."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield tmp_path / "cache"
    torch.set_num_threads(n)


@pytest.fixture
def loads(monkeypatch):
    """The slots read back from the cache (a hit appends its path)."""
    hits = []
    load = cache.load_arrays

    def spy(path):
        out = load(path)
        if out is not None:
            hits.append(path)
        return out

    monkeypatch.setattr(cache, "load_arrays", spy)
    return hits


def slots(home) -> list:
    d = home / "fenicsx_beat_tpu_torch" / "operators"
    return sorted(p.name for p in d.glob("*.npz")) if d.is_dir() else []


def assert_pairs_equal(a, b):
    assert type(a[0]) is type(b[0])
    for x, y in zip(a, b):
        if isinstance(x, StencilMatrix):
            assert x.offsets == y.offsets and x.vals.dtype == y.vals.dtype
            assert torch.equal(x.vals, y.vals)
        else:
            for name in ("cols", "vals", "tail_rows", "tail_cols", "tail_vals"):
                u, w = getattr(x, name), getattr(y, name)
                assert (u is None) == (w is None), name
                if u is not None:
                    assert u.dtype == w.dtype and np.array_equal(u, w), name


def niederer(dx=1.0):
    mesh, M, _, _ = tnied.niederer_setup(dx)
    return fem.functionspace(mesh, ("P", 1)), as_cell_tensors(M, mesh)


def lv_space(degree=1):
    geo = get_lv_ellipsoid_geometry(psize_ref=0.8)
    return fem.functionspace(geo.mesh, ("P", degree)), as_cell_tensors(1.0, geo.mesh)


@pytest.mark.parametrize("case", ["stencil", "ell", "ell P2"])
def test_hit_equals_a_fresh_assembly_bit_for_bit(case, cache_home, loads):
    if case == "stencil":
        V, M = niederer()
    else:
        V, M = lv_space(2 if case == "ell P2" else 1)
    fresh = fem.assemble_mass_stiffness_auto(V, M)
    cold = fem.assemble_mass_stiffness_auto(V, M, cache_key="k")
    assert not loads and len(slots(cache_home)) == 1
    warm = fem.assemble_mass_stiffness_auto(V, M, cache_key="k")
    assert len(loads) == 1 and len(slots(cache_home)) == 1
    expected = StencilMatrix if case == "stencil" else ELLMatrix
    assert isinstance(warm[0], expected)
    if case == "ell":
        assert warm[0].has_tail  # the LV's apex rows spill into the COO tail
    assert_pairs_equal(cold, fresh)
    assert_pairs_equal(warm, fresh)


def test_the_key_only_opts_in(cache_home, loads):
    """Another conductivity, dtype or mesh under the same key misses; a
    stencil slot is keyed by ``max_offsets`` too."""
    V, M = niederer()
    fem.assemble_mass_stiffness_auto(V, M, cache_key="k")
    fem.assemble_mass_stiffness_auto(V, 2.0 * M, cache_key="k")
    f32 = fem.assemble_mass_stiffness_auto(V, M, dtype=np.float32, cache_key="k")
    assert f32[0].vals.dtype == torch.float32
    V2, M2 = niederer(0.5)
    fem.assemble_mass_stiffness_auto(V2, M2, cache_key="k")
    assert fem.assemble_mass_stiffness_stencil(V, M, max_offsets=32, cache_key="k") is not None
    assert not loads and len(slots(cache_home)) == 5
    assert_pairs_equal(fem.assemble_mass_stiffness_auto(V, M, dtype=np.float32, cache_key="k"), f32)
    assert len(loads) == 1


def test_fused_solver_and_ecg_take_operator_cache_key(cache_home, loads):
    base = tnied._build_solver(dx=1.0, theta=0.5, device="cpu")
    cold = dataclasses.replace(base, operator_cache_key="niederer")
    warm = dataclasses.replace(base, operator_cache_key="niederer")
    assert len(loads) == 1
    for s in (base, warm):
        s.solve((0.0, 1.0), dt=0.05)
    np.testing.assert_array_equal(warm.states.numpy(), base.states.numpy())
    assert cold.operator_cache_key == "niederer"
    v = fem.Function(base.V)
    v.x.array[:] = base.v.numpy()
    ecg = ECGRecovery(v=v, M=base.M, device="cpu", operator_cache_key="ecg")
    again = ECGRecovery(v=v, M=base.M, device="cpu", operator_cache_key="ecg")
    assert len(loads) == 2
    assert torch.equal(ecg.solve_device()[0], again.solve_device()[0])


def test_bidomain_keys_both_pairs(cache_home, loads):
    cold = tbs.slab_solver(1.0, device="cpu", cache_key="slab")
    assert len(slots(cache_home)) == 2  # "slab|i" and "slab|e"
    warm = tbs.slab_solver(1.0, device="cpu", cache_key="slab")
    assert len(loads) == 2
    for s in (cold, warm):
        s.solve((0.0, 0.5), dt=0.05)
    np.testing.assert_array_equal(warm.states.numpy(), cold.states.numpy())
    np.testing.assert_array_equal(warm.u_e.numpy(), cold.u_e.numpy())


def test_a_torn_slot_is_a_miss(cache_home):
    V, M = niederer()
    fresh = fem.assemble_mass_stiffness_auto(V, M, cache_key="k")
    d = cache_home / "fenicsx_beat_tpu_torch" / "operators"
    (slot,) = d.glob("*.npz")
    slot.write_bytes(b"not an npz")
    assert_pairs_equal(fem.assemble_mass_stiffness_auto(V, M, cache_key="k"), fresh)
