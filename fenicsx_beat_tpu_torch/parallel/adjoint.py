"""Sharded differentiable monodomain simulation.

Port of ``fenicsx_beat_tpu/parallel/adjoint.py``:
``build_sharded_diff_simulator`` is the multi-rank counterpart of
:func:`~..adjoint.build_diff_simulator`.  The JAX package differentiates
straight through one ``shard_map``; the port runs the same step on every
rank under ``torch.autograd``, and each cross-rank transfer of the forward
pass is an autograd Function of :mod:`.comm` whose backward is its
transpose:

- the halo exchange (:func:`~.comm.halo_extend_ad`): backward, the reverse
  exchange (JAX's ``ppermute`` transpose, ``parallel/adjoint.py:188-194``
  there);
- the probe readout, a local product summed over ranks
  (:func:`~.comm.all_reduce_sum_ad`): every rank computes the same loss
  from it, so its backward passes the cotangent through;
- the replicated parameters (``g``, ``ionic``, ``stim_amplitude``) enter
  through :func:`~.comm.replicated_ad`, whose backward all-reduces their
  partial cotangents once per call, after the step loop's backward.

The CG's implicit adjoint (:func:`~..adjoint.cg_implicit`) re-runs the same
rank-local solver with its dot and max-norm all-reduced, so every rank
takes the same iterations.  Every rank calls ``simulate`` and its backward
together.

Scope, as in JAX: banded stencil operators (structured slabs) and
separable ``TimeWindow`` stimuli; other meshes raise
``NotImplementedError`` (differentiate them with
:func:`~..adjoint.build_diff_simulator` on one device).  The local product
is the stencil's shifted multiply-adds in torch, as the single-device
simulator computes structured meshes (no kernel: the JAX package computes
it outside any Pallas kernel too).  Padded rows keep JAX's identity mass
row (their residual is zero from the warm start on), but unlike JAX's the
CG's dots and max-norm leave them out: JAX's take in their right-hand
side, the resting voltage, which then sets the solve's tolerance
(-85 mV against real entries of ~0.1 mV mm^3 on the dx=0.1 slab).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import fem
from ..adjoint import CGCounts, _checkpointed_scan, _np_type, _param, _times, cg_implicit
from ..config import default_dtype
from ..stimulation import TimeWindow
from .comm import Communicator, all_reduce_sum_ad, halo_extend_ad, replicated_ad
from .distributed import DeviceMesh
from .partition import pad_global, partition_stencil

__all__ = ["build_sharded_diff_simulator"]


def build_sharded_diff_simulator(
    mesh,
    device_mesh: DeviceMesh,
    *,
    ode_fun: Callable,
    init_states: np.ndarray,
    v_index: int,
    I_s=None,
    probe_points,
    dt: float,
    n_steps: int,
    theta: float = 1.0,
    pde_theta: float = 1.0,
    C_m: float = 1.0,
    chi: float = 1.0,
    stiffness_components=None,
    quadrature_degree: int = 4,
    cg_rtol: float = 1e-10,
    cg_atol: float = 1e-12,
    cg_maxiter: int = 1000,
    dtype=None,
    checkpoint_segments: int | None = None,
):
    """Build ``simulate(params, states0_in=..., t0=..., return_final=...)``
    -> probe voltages ``[n_steps, n_probes]`` (the same on every rank),
    sharded over ``device_mesh``'s ranks, each on its device.

    The contract of :func:`~..adjoint.build_diff_simulator`, so
    :func:`~..adjoint.host_segmented_value_and_grad` drives it unchanged,
    with ONE difference: states are the rank's ``[S, n_local]`` block of
    the padded partition (``simulate.states0`` is built from
    ``init_states``; ``simulate.part`` is the partition).  Parameter
    gradients are the whole mesh's on every rank."""
    comm = Communicator(device_mesh)
    rank, nd, dev = device_mesh.rank, device_mesh.world_size, device_mesh.device
    dtype = dtype or default_dtype(dev)
    npt = _np_type(dtype)
    V = fem.functionspace(mesh, ("P", 1))
    n = V.ndofs

    specs = stiffness_components if stiffness_components is not None else [1.0]
    mass_st, kparts = None, []
    for spec in specs:
        st = fem.assemble_mass_stiffness_stencil(V, spec)
        if st is None:
            raise NotImplementedError(
                "build_sharded_diff_simulator requires a banded stencil operator (structured mesh); "
                "differentiate unstructured meshes with adjoint.build_diff_simulator on one device"
            )
        m_i, k_i = st
        if mass_st is None:
            mass_st = m_i
        elif k_i.offsets != mass_st.offsets:
            raise ValueError("stiffness components must share the mass pattern")
        kparts.append(k_i)

    part, vm3 = partition_stencil(mass_st, nd, diag_pad=1.0)
    kv4 = np.stack([partition_stencil(k, nd, diag_pad=0.0)[1] for k in kparts], axis=1)
    offsets = tuple(int(d) for d in mass_st.offsets)
    k0 = offsets.index(0)
    H, nl = part.halo, part.n_local
    lo = rank * nl

    def on_dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev).to(dtype).contiguous()

    vm = on_dev(vm3[rank])  # [nl, K]
    kv = on_dev(kv4[rank])  # [n_specs, nl, K]

    # separable TimeWindow stimuli, the rank's block of each unit load
    stimuli = [] if I_s is None else ([I_s] if hasattr(I_s, "expr") else list(I_s))
    loads, win = [], []
    for s in stimuli:
        if not isinstance(s.expr, TimeWindow):
            raise NotImplementedError("the sharded diff simulator takes TimeWindow stimuli; other expressions "
                                      "differentiate on the single-device path")
        ents = s.dz.entities()
        if s.dz.integral_type() == "cell":
            quad = fem.cell_quadrature(V, ents, degree=quadrature_degree, dtype=np.float64)
        else:
            quad = fem.facet_quadrature(V, ents, degree=quadrature_degree, dtype=np.float64)
        loads.append(np.asarray(quad.assemble_load_host()))
        win.append((float(s.expr.start), float(s.expr.duration)))
    n_slots = max(len(stimuli), 1)
    default_amps = [float(s.expr.amplitude) for s in stimuli] or [0.0]
    stim_g = np.stack(loads) if loads else np.zeros((1, n))
    stim_loc = on_dev(pad_global(stim_g, part)[:, lo : lo + nl])  # [n_slots, nl]
    win_arr = np.asarray(win or [(0.0, 0.0)], dtype=npt)
    win_start, win_end = win_arr[:, 0], win_arr[:, 0] + win_arr[:, 1]

    # probe weights, the rank's columns of the dense [n_probes, n] table
    probe_dofs, probe_w = fem.point_evaluation_tables(V, np.asarray(probe_points))
    n_probes = probe_dofs.shape[0]
    Wp = np.zeros((n_probes, n))
    np.add.at(Wp, (np.arange(n_probes)[:, None], probe_dofs), probe_w)
    Wp_loc = on_dev(pad_global(Wp, part)[:, lo : lo + nl])

    init = np.asarray(init_states, dtype=np.float64)
    states_g = np.tile(init[:, None], (1, n)) if init.ndim == 1 else init
    states_pad = np.concatenate([states_g, np.tile(states_g[:, :1], (1, part.n_pad - n))], axis=1)
    states0 = on_dev(states_pad[:, lo : lo + nl])

    th, dt_f = float(pde_theta), float(dt)
    strang = abs(theta - 0.5) < 1e-12
    counts = CGCounts()

    def spmv(vals, x):
        x_ext = halo_extend_ad(x.contiguous(), comm, H)
        y = vals[:, k0] * x
        for k, d in enumerate(offsets):
            if d:
                y = y + vals[:, k] * x_ext[H + d : H + d + nl]
        return y

    # the CG's dots and max-norm over real rows only (JAX's include the padded
    # rows, whose right-hand side is their resting voltage: it sets the
    # tolerance there, Queue C)
    real = (torch.arange(nl, device=dev) < part.real_rows(rank)).to(dtype)

    def pdot(a, b):
        return comm.all_reduce_sum(torch.dot((a * real).reshape(-1), b.reshape(-1)).reshape(1))[0]

    def pmax_abs(r):
        return comm.all_reduce_max((r.abs() * real).max().reshape(1))[0]

    def simulate(params: dict, *, states0_in=None, t0=0.0, return_final: bool = False):
        g = replicated_ad(_param(params.get("g", 1.0), dev, dtype), comm)
        ionic = params.get("ionic", None)
        io = None if ionic is None else replicated_ad(_param(ionic, dev, dtype), comm)
        amps = torch.broadcast_to(_param(params.get("stim_amplitude", default_amps), dev, dtype), (n_slots,))
        amps = replicated_ad(amps.contiguous(), comm)
        kvg = torch.tensordot(g, kv, dims=1)
        A_vals = chi * C_m * vm + th * dt_f * kvg
        diagA = A_vals[:, k0]

        def b_stim(t: float):
            tt = npt(t)
            on = torch.as_tensor(((tt >= win_start) & (tt <= win_end)).astype(np.float64), device=dev).to(dtype)
            return chi * ((amps * on) @ stim_loc)

        def pde_step(v, t):
            rhs = chi * C_m * spmv(vm, v)
            if th != 1.0:
                rhs = rhs - (1.0 - th) * dt_f * spmv(kvg, v)
            rhs = rhs + dt_f * b_stim(float(npt(t) + npt(th * dt_f)))
            return cg_implicit(lambda u: spmv(A_vals, u), rhs, x0=v, precond_diag=diagA, rtol=cg_rtol,
                               atol_scaled=cg_atol, maxiter=cg_maxiter, dot=pdot, max_abs=pmax_abs, counts=counts)

        def set_v(states, v):
            return torch.cat([states[:v_index], v[None], states[v_index + 1 :]])

        def step(states, t):
            if strang:
                states = ode_fun(states, t, io, 0.5 * dt_f)
                states = set_v(states, pde_step(states[v_index], t))
                states = ode_fun(states, float(npt(t) + npt(0.5 * dt_f)), io, 0.5 * dt_f)
            else:
                states = ode_fun(states, t, io, dt_f)
                states = set_v(states, pde_step(states[v_index], t))
            return states, all_reduce_sum_ad(Wp_loc @ states[v_index], comm)

        init_s = states0 if states0_in is None else states0_in
        final, traces = _checkpointed_scan(step, init_s, _times(t0, n_steps, dt_f, npt), checkpoint_segments)
        if return_final:
            return traces, final
        return traces

    simulate.part = part
    simulate.states0 = states0
    simulate.n_probes = n_probes
    simulate.cg_counts = counts
    simulate.comm = comm
    return simulate
