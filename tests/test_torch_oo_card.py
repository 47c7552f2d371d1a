"""The object-oriented path's use of the ionic kernels (B1), without JAX.

On the CPU: the ODE adapters on a ported model's ``fun`` run its twin and
count no launch, and the splitting solver counts the voltage's crossings
between device and host (4 a Godunov step, 5 a Strang step, 1 at
construction).  On the card (``-m cuda``): a registered model's step
launches its B1 kernel once per marker per step (``DolfinODESolver``
once, ``DolfinMultiODESolver`` once per marker), and B1 with the voltage
row itself as its input gives the same bits as with a copy of that row,
for the four hand-written models in both B1 forms (the staged ToR-ORd and
Land kernels prefetch states with ``cp.async``).  Imports neither JAX nor
the JAX package, so the card's machine runs it as it is::

    python -m pytest --noconftest tests/test_torch_oo_card.py -m cuda
"""

import numpy as np
import pytest
import torch

from fenicsx_beat_tpu_torch import fem
from fenicsx_beat_tpu_torch import mesh as tmesh
from fenicsx_beat_tpu_torch.models import fitzhughnagumo as fhn
from fenicsx_beat_tpu_torch.models import tentusscher_panfilov_2006 as tp06
from fenicsx_beat_tpu_torch.models import torord_dyncl as torord
from fenicsx_beat_tpu_torch.models import torord_dyncl_land as land
from fenicsx_beat_tpu_torch.monodomain_model import MonodomainModel
from fenicsx_beat_tpu_torch.monodomain_solver import MonodomainSplittingSolver
from fenicsx_beat_tpu_torch.odesolver import DolfinMultiODESolver, DolfinODESolver
from fenicsx_beat_tpu_torch.ops import cuda_ode

MODELS = {"tp06": tp06, "torord_dyncl": torord, "torord_dyncl_land": land, "fhn": fhn}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run the port on one CPU thread (small tensors; the parallel test run
    shares the cores between its workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def tp06_params():
    return tp06.init_parameter_values(stim_amplitude=0.0)


def multi_solver(device, n=6):
    """Three TP06 layers on the unit square, one parameter set each."""
    mesh = tmesh.create_unit_square(None, n, n)
    V = fem.functionspace(mesh, ("P", 1))
    markers = fem.Function(V)
    markers.x.array[:] = np.floor(3 * V.tabulate_dof_coordinates()[:, 0] - 1e-9).clip(0, 2)
    init = tp06.init_state_values()
    return DolfinMultiODESolver(
        v_ode=fem.Function(V), v_pde=fem.Function(V), markers=markers,
        init_states={m: init for m in range(3)},
        parameters={m: tp06.init_parameter_values(stim_amplitude=0.0, celltype=float(m)) for m in range(3)},
        fun={m: tp06.generalized_rush_larsen for m in range(3)},
        num_states={m: len(init) for m in range(3)}, v_index={m: 0 for m in range(3)}, device=device,
    )


def test_cpu_adapters_run_the_twin_and_count_no_launch():
    ode = multi_solver("cpu")
    before = cuda_ode.tp06_grl_step_v.launches
    for k in range(3):
        ode.step(k * 0.05, 0.05)
    assert cuda_ode.tp06_grl_step_v.launches == before
    assert all(ode.values(m).dtype == torch.float64 and ode.values(m).device.type == "cpu" for m in range(3))


@pytest.mark.parametrize("theta, per_step", [(1.0, 4), (0.5, 5)])
def test_splitting_solver_counts_voltage_crossings(theta, per_step):
    mesh = tmesh.create_unit_square(None, 4, 4)
    pde = MonodomainModel(time=fem.Constant(0.0), mesh=mesh, M=0.001, device="cpu")
    init = tp06.init_state_values()
    ode = DolfinODESolver(v_ode=fem.Function(pde.V), v_pde=pde.state, init_states=init, parameters=tp06_params(),
                          fun=tp06.generalized_rush_larsen, num_states=len(init), device="cpu")
    solver = MonodomainSplittingSolver(pde=pde, ode=ode, theta=theta)
    assert solver.host_transfers == 1  # the seeding to_dolfin
    for k in range(3):
        solver.step((k * 0.05, (k + 1) * 0.05))
    assert solver.host_transfers == 1 + 3 * per_step
    assert pde.host_transfers == 2 * 3


@pytest.mark.cuda
def test_registered_model_launches_per_marker_per_step(cuda_device):
    ode = multi_solver(cuda_device)
    before = cuda_ode.tp06_grl_step_v.launches
    for k in range(4):
        ode.step(k * 0.05, 0.05)
    torch.cuda.synchronize()
    assert cuda_ode.tp06_grl_step_v.launches - before == 3 * 4
    mesh = tmesh.create_unit_square(None, 5, 5)
    V = fem.functionspace(mesh, ("P", 1))
    init = tp06.init_state_values()
    single = DolfinODESolver(v_ode=fem.Function(V), v_pde=fem.Function(V), init_states=init, parameters=tp06_params(),
                             fun=tp06.generalized_rush_larsen, num_states=len(init), device=cuda_device)
    before = cuda_ode.tp06_grl_step_v.launches
    for k in range(4):
        single.step(k * 0.05, 0.05)
    assert cuda_ode.tp06_grl_step_v.launches - before == 4
    assert single.values.dtype == torch.float32 and bool(torch.isfinite(single.values).all())
    # on the twins: the same function, no launch
    twin = DolfinODESolver(v_ode=fem.Function(V), v_pde=fem.Function(V), init_states=init, parameters=tp06_params(),
                           fun=tp06.generalized_rush_larsen, num_states=len(init), device=cuda_device,
                           use_kernels=False)
    before = cuda_ode.tp06_grl_step_v.launches
    twin.step(0.0, 0.05)
    assert cuda_ode.tp06_grl_step_v.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("form", ["vector", "field"])
def test_b1_with_its_own_voltage_row_gives_the_copy_bits(cuda_device, name, form):
    """B1 reads V from ``v`` and writes row V; passing that row itself (as
    the OO adapters do) must give the bits of passing a copy, over several
    tiles of the staged kernels and from states spread over the action
    potential (V from -90 to 40 mV)."""
    model = MODELS[name]
    spec = cuda_ode.IONIC_MODELS[model.generalized_rush_larsen]
    n = 100_003
    rng = np.random.default_rng(7)
    init = np.asarray(model.init_state_values(), dtype=np.float64)
    states = np.tile(init[:, None], (1, n)) * (1.0 + 0.01 * rng.standard_normal((init.size, n)))
    states[spec.v_index] = rng.uniform(-90.0, 40.0, n)
    params = np.asarray(model.init_parameter_values(), dtype=np.float64)
    a = torch.tensor(states, dtype=torch.float32, device=cuda_device)
    b = a.clone()
    vi = spec.v_index
    if form == "vector":
        step, p = spec.step, params
    else:
        step, p = spec.node_step, torch.tensor(np.tile(params[:, None], (1, n)), dtype=torch.float32,
                                                 device=cuda_device)
    for k in range(3):
        step(a, a[vi], 0.05 * k, 0.05, p)
        step(b, b[vi].clone(), 0.05 * k, 0.05, p)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert bool(torch.isfinite(a).all())
