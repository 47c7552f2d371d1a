"""Kernel-vs-twin regression checks.

:func:`kernel_check` is the port of
``fenicsx_beat_tpu/benchmarks/kernel_check.py``: the same dx=0.5 Niederer
simulation runs twice on one device, once through the four CUDA kernels
and once through their plain PyTorch twins, and the max voltage deviation
is recorded.  float32 accumulation-order noise is of order 1e-4..1e-3 over
40 steps; anything above 1e-2 is a real fault.  :func:`lv_kernel_check`
does the same on the LV of ``benchmarks/lv.py`` (B7 and B8), both solvers
on one layer labelling.

The voltage alone does not see the ionic step's slow concentrations (K_i,
Na_i, Ca_SR), whose effect on V over 40 steps is below that noise.
:func:`ionic_step_errors` and :func:`ionic_beat_errors` hold every state
row of an ionic step (TP06, ToR-ORd or FitzHugh-Nagumo, any form: B1, its
per-node form, B7) against its twin: one step by increment, and one paced beat by
excursion.  At physiological values one step moves TP06's K_i by less
than a float32 ulp of 137 mM, so the one-step check also runs on
:func:`step_check_states`, where the same formulas move each model's
slow rows by thousands of ulps.  On the card the beat check replays its
twin step as a CUDA graph: the twins are a thousand small kernels a step,
bound by the host's launches.

:func:`ionic_form_checks` runs the three forms of one model so, by step
and by beat: :func:`fhn_checks` for FitzHugh-Nagumo, and the same for any
model that ``odefile.load_ode`` generated.

Usage, on a machine with a CUDA card::

    python -m fenicsx_beat_tpu_torch.benchmarks.kernel_check
"""

from __future__ import annotations

import json
import sys
from typing import Callable

import torch

from ..ops.cuda_ode import IONIC_MODELS

THRESHOLD = 1e-2
# One ionic step, per state row: the kernel-vs-twin difference beyond one
# float32 ulp of the value, over the row's largest increment.  Kernel vs
# twin on an H100 reads at most 2.5e-3 (row Xs).  Mutated kernels read:
# K_i never updated 0.93, the NaCa term of dNa_i doubled 0.54, K_i's or
# Na_i's rate 5% low 0.05 with that row scaled (0 at physiological
# values).  A term small against its row's largest increment (i_NaK in
# dK_i, 6e-4 of it) is left to the beat check.
IONIC_STEP_TOL = 2e-2
# Each model's rows whose one-step increment float32 resolves only coarsely
# on the check's states, and the factor that brings that to 2.4e-3 or
# less.  The ratio of a float32 ulp of the value to the row's largest
# one-step increment, dt = 0.025, V uniform on [-90, 40] mV: TP06 K_i 0.3,
# Na_i 0.17, Ca_SR 0.05; ToR-ORd cansr 6.6e-3, CaMKt 5.2e-3, fs 4.7e-3,
# every other ToR-ORd row 2e-3 or less (ki 8.4e-4, nai 7.9e-4).  FHN's two
# rows move by far more than an ulp in one step (s by b (v - v_rest) dt).
SLOW_ROWS = {
    "tp06": ("Ca_SR", "Na_i", "K_i"),
    "torord_dyncl": ("cansr", "CaMKt", "fs"),
    "fhn": (),
}
SLOW_ROW_SCALE = 1e-2
# One paced beat, per state row: max |kernel - twin| over the run, over
# the row's largest excursion from the start in the twin.  Kernel vs twin
# over 16,384 cells on an H100 reads at most 4.6e-2 (rows K_i and j: the
# upstroke moves by a fraction of a step); a frozen Na_i or Ca_SR reads
# 1.0, the NaK term of dK_i halved 0.38, the NaCa term of dNa_i doubled
# 0.74.
IONIC_BEAT_TOL = 1e-1
# The beat: the model's own pacing (stimulus at 10-11 ms), 400 ms at the
# main path's step.
BEAT_DT = 0.05
BEAT_STEPS = 8000

# Start (ms) of the LV kernel check's window: after the stimulated
# layer's upstroke (1.1-1.9 ms at psize 0.3), see lv_kernel_check
LV_CHECK_START = 5.0
# celltypes every ionic check runs, in both models: endo, epi, mid
CELLTYPES = (0.0, 1.0, 2.0)
_MODULES = {m.name: m.module for m in IONIC_MODELS.values()}

IonicStep = Callable[[torch.Tensor, torch.Tensor, float, float, object], torch.Tensor]


def _ulp32(x: torch.Tensor) -> torch.Tensor:
    """Spacing of float32 numbers at ``|x|``, in ``x``'s dtype."""
    a = x.abs().float()
    return (torch.nextafter(a, torch.full_like(a, float("inf"))) - a).to(x.dtype)


def step_check_states(states: torch.Tensor, model: str = "tp06") -> list[tuple[str, torch.Tensor]]:
    """The states the one-step check runs from: ``states`` itself, then one
    copy for each of ``model``'s :data:`SLOW_ROWS` with that row alone
    scaled by :data:`SLOW_ROW_SCALE`.  Those values are far from
    physiological, but kernel and twin evaluate the same formulas on them,
    and one step's increment of the scaled row is then large against a
    float32 ulp of its value.  One row at a time, because a small Na_i also
    silences i_NaK, which K_i's and V's rates carry."""
    sets = [("physiological", states)]
    for name in SLOW_ROWS[model]:
        out = states.clone()
        out[_MODULES[model].state_index(name)] *= SLOW_ROW_SCALE
        sets.append((f"{name} scaled", out))
    return sets


def ionic_step_errors(
    step: IonicStep, twin: IonicStep, states: torch.Tensor, v: torch.Tensor, t: float, dt: float, parameters,
    v_index: int = 0,
) -> tuple[float, torch.Tensor]:
    """One ionic step from the same ``states`` and ``v`` through ``step``
    and ``twin``.  Returns the max absolute difference and, per state row,
    ``max(|k - w| - ulp(max(|k|, |w|)), 0) / max|w - s|`` over the nodes,
    where ``s`` is the input with row V replaced by ``v``.  Where float32
    cannot resolve a step's change of a value, kernel and twin may round
    to neighbouring numbers; anything beyond that one ulp is held against
    the step's own increment, so a row left unchanged or moved by a wrong
    rate shows at O(1) however small its value's change."""
    return ionic_step_errors_by_group(step, twin, states, v, t, dt, parameters, {"all": None}, v_index)["all"]


def ionic_step_errors_by_group(
    step: IonicStep, twin: IonicStep, states: torch.Tensor, v: torch.Tensor, t: float, dt: float,
    parameters, groups: dict, v_index: int = 0,
) -> dict:
    """:func:`ionic_step_errors` from one step, with the max and the per-row
    error taken over each group of nodes (``name -> node index tensor``,
    None for all nodes); returns ``name -> (max abs, per-row error)``.
    ``v_index`` is the row the step injects ``v`` into."""
    s_in = states.clone()
    s_in[v_index] = v
    k, w = states.clone(), states.clone()
    step(k, v, t, dt, parameters)
    twin(w, v, t, dt, parameters)
    k, w, s_in = k.double(), w.double(), s_in.double()
    out = {}
    for name, nodes in groups.items():
        kg, wg, sg = (a if nodes is None else a[:, nodes] for a in (k, w, s_in))
        diff = (kg - wg).abs()
        excess = (diff - _ulp32(torch.maximum(kg.abs(), wg.abs()))).clamp_min(0.0)
        scale = (wg - sg).abs().amax(dim=1).clamp_min(1e-300)
        out[name] = (float(diff.max()), excess.amax(dim=1) / scale)
    return out


def ionic_beat_errors(
    step: IonicStep, twin: IonicStep, states: torch.Tensor, parameters,
    dt: float = BEAT_DT, n_steps: int = BEAT_STEPS, t0: float = 0.0, v_index: int = 0,
) -> tuple[float, torch.Tensor]:
    """Run ``step`` and ``twin`` side by side from ``states`` for
    ``n_steps``, each cell driven by its own voltage row (no PDE) and the
    model's pacing stimulus in ``parameters``.  Returns the max absolute
    difference and, per state row, max over steps and nodes of
    ``|k - w|`` over the row's largest excursion ``max |w - s0|``.  On the
    card the twin's step is a CUDA graph (:func:`_twin_stepper`)."""
    return ionic_beat_errors_by_group(
        step, twin, states, parameters, {"all": None}, dt=dt, n_steps=n_steps, t0=t0, v_index=v_index
    )["all"]


def ionic_beat_errors_by_group(
    step: IonicStep, twin: IonicStep, states: torch.Tensor, parameters, groups: dict,
    dt: float = BEAT_DT, n_steps: int = BEAT_STEPS, t0: float = 0.0, v_index: int = 0,
) -> dict:
    """:func:`ionic_beat_errors` from one run, the max and the per-row error
    taken over each group of nodes (``name -> node index tensor``, None for
    all nodes); returns ``name -> (max abs, per-row error)``."""
    k, w = states.clone(), states.clone()
    acc = {name: (torch.zeros(states.shape[0], dtype=states.dtype, device=states.device),
                  torch.zeros(states.shape[0], dtype=states.dtype, device=states.device))
           for name in groups}
    twin_step = _twin_stepper(twin, w, dt, parameters, v_index)
    t = float(t0)
    for _ in range(n_steps):
        step(k, k[v_index], t, dt, parameters)
        twin_step(t)
        d, e = (k - w).abs(), (w - states).abs()
        for name, nodes in groups.items():
            err, exc = acc[name]
            torch.maximum(err, (d if nodes is None else d[:, nodes]).amax(dim=1), out=err)
            torch.maximum(exc, (e if nodes is None else e[:, nodes]).amax(dim=1), out=exc)
        t += dt
    return {
        name: (float(err.max()), err.double() / exc.double().clamp_min(1e-300))
        for name, (err, exc) in acc.items()
    }


def _twin_stepper(twin: IonicStep, w: torch.Tensor, dt: float, parameters,
                  v_index: int = 0) -> Callable[[float], None]:
    """``step(t)``: one step of ``twin`` on ``w`` in place, V from its own
    row.  On the CPU a plain call.  On the card the step is captured once
    as a CUDA graph and replayed, ``t`` a float32 scalar on the device that
    each call sets: the graph runs the twin's kernels without the host's
    launch cost, and the stimulus window is then evaluated in float32, as
    the kernels evaluate it.  ``parameters`` must not need the host (a
    vector as numpy, a field or table on the card)."""
    if w.device.type != "cuda":
        return lambda t: twin(w, w[v_index], t, dt, parameters)
    t_dev = torch.zeros((), dtype=w.dtype, device=w.device)
    start = w.clone()
    side = torch.cuda.Stream(w.device)
    side.wait_stream(torch.cuda.current_stream(w.device))
    with torch.cuda.stream(side):  # warm-up: first-call allocations outside the capture
        twin(w, w[v_index], t_dev, dt, parameters)
    torch.cuda.current_stream(w.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        twin(w, w[v_index], t_dev, dt, parameters)
    w.copy_(start)  # the warm-up stepped w

    def step(t: float) -> None:
        t_dev.fill_(t)
        graph.replay()

    return step


def ionic_form_checks(ionic, states, v, table, rest, rng, device="cuda", beat_steps: int = BEAT_STEPS) -> dict:
    """The three kernel forms of ``ionic`` (an :class:`~..ops.cuda_ode.IonicModel`)
    against their twins on ``n`` nodes: B1 (parameter set ``table[0]``),
    B1's per-node form (a field mixing the sets of ``table``) and B7 (the
    same sets as layers, 2% of the nodes in none, on ``make_multi_ode``'s
    storage layout: the voltage in row 0, row 0 in the voltage's row).

    ``states`` [S, n] and ``v`` [n] are the one-step check's states and
    injected voltage in the model's row order; ``rest(rng)`` gives the
    [S, n] states one beat starts from.  Each form runs
    :func:`ionic_step_errors_by_group` at t = 0.5 and 2.0 (the stimulus
    window of FHN and of the coverage source on at one, off at the other)
    and dt = 0.025 and 0.05, and :func:`ionic_beat_errors_by_group` over ``beat_steps``
    steps of every cell.  Returns ``{"forms": {name: {"rows": state names
    in the form's row order, "step": {(t, dt, group): (max abs, per-row
    error)}, "beat": {group: (max abs, per-row error)}}}, "uniform_bits":
    B1's per-node form on a uniform field gives B1's bits, "inputs": the
    tensors, for timing}``."""
    import numpy as np

    dev = torch.device(device)
    n, vi = v.shape[0], ionic.v_index

    def on(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(torch.float32).contiguous()

    perm = np.arange(states.shape[0])
    perm[[0, vi]] = [vi, 0]  # the model's rows <-> make_multi_ode's storage (an involution)
    S0, S0_storage, v_k = on(states), on(states[perm]), on(v)
    table_k = on(table)
    sets = rng.integers(0, len(table), n)
    field = on(table[sets].T)
    index = torch.as_tensor(np.where(rng.random(n) < 0.02, -1, sets).astype(np.int32), device=dev)
    set_groups = {f"set {i}": torch.as_tensor(np.nonzero(sets == i)[0], device=dev) for i in range(len(table))}
    layers = {f"set {i}": torch.nonzero(index == i).flatten() for i in range(len(table))}

    def b7(S, v_, t, dt, p):
        return ionic.multi_step(S, v_, index, t, dt, table_k)

    def b7_twin(S, v_, t, dt, p):
        return ionic.multi_step_twin(S, v_, index, t, dt, table)

    names = list(ionic.module._STATE_NAMES)
    forms = {  # step, twin, parameters, groups, states, voltage row
        ionic.step.__name__: (ionic.step, ionic.step_twin, table[0], {"all": None}, S0, vi),
        ionic.node_step.__name__: (ionic.node_step, ionic.step_twin, field, set_groups, S0, vi),
        ionic.multi_step.__name__: (b7, b7_twin, None, {**layers, "no layer": torch.nonzero(index < 0).flatten()},
                                    S0_storage, 0),
    }
    out = {}
    for name, (step, twin, p, groups, S, row_v) in forms.items():
        storage = S is S0_storage
        res = {"rows": [names[k] for k in perm] if storage else names, "step": {}}
        for t in (0.5, 2.0):
            for dt in (0.025, 0.05):
                for g, e in ionic_step_errors_by_group(step, twin, S, v_k, t, dt, p, groups, row_v).items():
                    res["step"][(t, dt, g)] = e
        r = rest(rng)
        beat_groups = {g: x for g, x in groups.items() if g != "no layer"}
        res["beat"] = ionic_beat_errors_by_group(step, twin, on(r[perm] if storage else r), p, beat_groups,
                                                 n_steps=beat_steps, v_index=row_v)
        out[name] = res
    uniform = on(np.tile(table[1][:, None], (1, n)))
    a, b = S0.clone(), S0.clone()
    ionic.step(a, v_k, 0.5, 0.05, table[1])
    ionic.node_step(b, v_k, 0.5, 0.05, uniform)
    inputs = dict(S0=S0, S0_storage=S0_storage, v=v_k, table=table, field=field, b7=b7, b7_twin=b7_twin)
    return {"forms": out, "uniform_bits": bool(torch.equal(a, b)), "inputs": inputs}


def fhn_checks(n: int = 442_401, device="cuda", beat_steps: int = BEAT_STEPS) -> dict:
    """FitzHugh-Nagumo's three kernel forms through :func:`ionic_form_checks`:
    random states (s in [0, 60], v in [-90, 40] mV) at t = 0.5 (the
    stimulus on) and 2.0 (off); three parameter sets; one paced beat of
    every cell from rest (the model's own 0-1 ms stimulus)."""
    import numpy as np

    from ..models import fitzhughnagumo as fhn
    from ..ops import cuda_ode

    rng = np.random.default_rng(5)
    states = np.stack([rng.uniform(0.0, 60.0, n), rng.uniform(-90.0, 40.0, n)])
    v = rng.uniform(-90.0, 40.0, n)
    table = np.stack([fhn.init_parameter_values(), fhn.init_parameter_values(b=0.02),
                      fhn.init_parameter_values(a=0.1, c_3=1.5)])

    def rest(r):
        return np.stack([np.zeros(n), -85.0 + 0.5 * r.standard_normal(n)])

    return ionic_form_checks(cuda_ode.ionic_model(fhn.forward_euler), states, v, table, rest, rng,
                             device=device, beat_steps=beat_steps)


def kernel_check(dx: float = 0.5, dt: float = 0.05, n_steps: int = 40, device="cuda") -> dict:
    from .niederer import _build_solver

    v = {}
    for use_kernels in (True, False):
        solver = _build_solver(dx=dx, device=device, use_kernels=use_kernels)
        solver.solve((0.0, n_steps * dt), dt=dt)
        v[use_kernels] = solver.v.double().cpu()
    dev = torch.device(device)
    return {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "dx": dx,
        "dt": dt,
        "n_steps": n_steps,
        "max_abs_dev": float((v[True] - v[False]).abs().max()),
        "threshold": THRESHOLD,
    }


def _spmv_other_order(A, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` through torch's sparse CSR product: the CSR twin's
    arithmetic in another summation order (a reference for rounding)."""
    return torch.mv(torch.sparse_csr_tensor(A.indptr, A.cols, A.vals.to(x.dtype), A.shape), x)


def lv_kernel_check(psize: float = 0.3, dt: float = 0.05, n_steps: int = 40, device="cuda",
                    t_start: float = LV_CHECK_START) -> dict:
    """The LV of ``benchmarks/lv.py`` for ``n_steps`` through the kernels
    and through the twins on one device, both on one layer labelling and
    both from the state the twins reach at ``t_start``; max voltage
    deviation against the same threshold.

    The window starts after the stimulated layer's upstroke, which falls on
    step 40 from t = 0 and amplifies float32 rounding there.  The deviation
    from t = 0 is reported as ``max_abs_dev_from_0``, and beside it
    ``max_abs_dev_from_0_twin_orders``: the same from-zero run on the twins
    twice, the second with the SpMV summed in another order (torch's CSR
    product) -- what rounding alone puts between two correct runs."""
    from .. import fem
    from ..geometry import get_lv_ellipsoid_geometry
    from .lv import build_lv_solver, lv_layers

    geo = get_lv_ellipsoid_geometry(psize_ref=psize)
    layers = lv_layers(geo, fem.functionspace(geo.mesh, ("P", 1)), precond="jacobi", device=device)

    def build(use_kernels):
        return build_lv_solver(psize=psize, device=device, layers=layers, use_kernels=use_kernels)

    solvers = {k: build(k) for k in (True, False)}
    other = build(False)
    other._csr_spmv = _spmv_other_order
    v0 = {}
    for k, solver in [*solvers.items(), ("other", other)]:
        solver.solve((0.0, n_steps * dt), dt=dt)
        v0[k] = solver.v.double().cpu()
    # the checked window: both from the twins' state at t_start
    ref = build(False)
    ref.solve((0.0, t_start), dt=dt)
    v = {}
    for k, solver in solvers.items():
        solver.states = ref.states.clone()
        solver.activation_time = ref.activation_time.clone()
        solver.solve((t_start, t_start + n_steps * dt), dt=dt)
        v[k] = solver.v.double().cpu()
    dev = torch.device(device)
    return {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "psize": psize,
        "n_nodes": int(v[True].shape[0]),
        "dt": dt,
        "n_steps": n_steps,
        "t_start": t_start,
        "max_abs_dev": float((v[True] - v[False]).abs().max()),
        "max_abs_dev_from_0": float((v0[True] - v0[False]).abs().max()),
        "max_abs_dev_from_0_twin_orders": float((v0["other"] - v0[False]).abs().max()),
        "threshold": THRESHOLD,
    }


def main() -> int:
    out = kernel_check()
    print(json.dumps(out))
    out_lv = lv_kernel_check()
    print(json.dumps(out_lv))
    ok = out["max_abs_dev"] < out["threshold"] and out_lv["max_abs_dev"] < out_lv["threshold"]
    fhn = fhn_checks()
    for name, res in fhn["forms"].items():
        step = max(float(e.max()) for _, e in res["step"].values())
        beat = max(float(e.max()) for _, e in res["beat"].values())
        print(json.dumps({"kernel": name, "step_err": step, "beat_err": beat}))
        ok = ok and step <= IONIC_STEP_TOL and beat <= IONIC_BEAT_TOL
    return 0 if ok and fhn["uniform_bits"] else 1


if __name__ == "__main__":
    sys.exit(main())
