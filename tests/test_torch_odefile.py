"""Runtime ``.ode`` ingestion on the port (:mod:`fenicsx_beat_tpu_torch.odefile`)
against the JAX package's (:mod:`fenicsx_beat_tpu.odefile`), in f64 on the
CPU (the port on its kernels' twins).

- The parser's errors: the same ``ValueError`` and message as JAX's.
- The generated torch module against JAX's generated jnp module, for the
  port's three shipped sources (``odes/``: the demo's inline
  FitzHugh-Nagumo, the toy gate of the JAX tests, and a coverage source
  that uses every construct of the subset): names, initial values and
  indices equal; ``rhs``, ``forward_euler`` and ``generalized_rush_larsen``
  on random states, with the stimulus window on and off, on a parameter
  vector and on a node-aligned field (JAX applied node by node), within
  rtol 1e-12.
- The generated B1 (V injected into the model's row), its per-node form
  and B7 (two marker sets in ``make_multi_ode``'s storage layout), through
  their wrappers, against the JAX Pallas kernels in interpret mode traced
  over the JAX module's steps: rtol 1e-12, both schemes.
- The CUDA node body, compiled by the host's ``g++`` (``__device__``
  defined away) and called on 1,024 float32 nodes, against the float32
  twin: equal within 4 float32 ulps of each row's largest value (the same
  operations in the same order; only the libm functions may differ).
- The demo's configuration, the Niederer slab at dx=0.5 with the inline
  FHN's GRL, Strang, a fixed 10 ms: every state at every node within atol
  1e-8 of JAX's (CG rtol 1e-8 on both sides).
- The propagating cross-check: the bidomain demo's configuration on the
  generated ``forward_euler`` against the hand-written FHN's (rows mapped,
  ``v, w`` to ``s, v``): every field within 1e-12 of its largest value.
- Registration: ``ionic_model`` finds both steps of a loaded model; a
  second load of the same text is a new module with its own kernel
  wrappers on the same library; unported models still raise; importing
  ``odefile`` and loading a model imports no JAX.
"""

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenicsx_beat_tpu import odefile as jode
from fenicsx_beat_tpu import odesolver as jodesolver
from fenicsx_beat_tpu.benchmarks import niederer as jnied
from fenicsx_beat_tpu.ops.pallas_ode import build_pallas_multi_ode_step, build_pallas_ode_step
from fenicsx_beat_tpu_torch import _build, odefile
from fenicsx_beat_tpu_torch.base_model import Status
from fenicsx_beat_tpu_torch.benchmarks import bidomain_scale as tbs
from fenicsx_beat_tpu_torch.benchmarks import custom_ode
from fenicsx_beat_tpu_torch.benchmarks import niederer as tnied
from fenicsx_beat_tpu_torch.models import fitzhughnagumo as tfhn
from fenicsx_beat_tpu_torch.models import tentusscher_panfilov_2006 as ttp
from fenicsx_beat_tpu_torch.odesolver import check_multi_models, make_multi_ode
from fenicsx_beat_tpu_torch.splitting import check_ionic_scope, ionic_layer
from fenicsx_beat_tpu_torch.ops import cuda_ode

RTOL = 1e-12
ROOT = Path(__file__).resolve().parent.parent
SOURCES = ("fhn_inline", "toy_gate", "coverage")
KERNEL_SOURCES = ("fhn_inline", "coverage")  # the toy has no voltage state
SCHEMES = ("generalized_rush_larsen", "forward_euler")
# each source's states for the checks: uniform ranges by state
RANGES = {
    "fhn_inline": {"v": (-90.0, 40.0), "w": (0.0, 60.0)},
    "toy_gate": {"x": (0.0, 1.0), "y": (-2.0, 2.0)},
    "coverage": {"h": (0.05, 0.95), "V": (-90.0, 30.0), "c": (0.5, 4.0), "n": (0.0, 1.0)},
}
TIMES = (0.5, 2.0, 4.0)  # the coverage source's stimulus is on over [1, 3)


def load(name):
    """The port's and JAX's modules from the port's copy of the source."""
    text = (odefile.ODES / f"{name}.ode").read_text()
    return odefile.load_ode(text, name=name), jode.load_ode(text, name=name)


def random_states(mod, name, n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(*RANGES[name][s], n) for s in mod._STATE_NAMES]), rng


def random_field(mod, n, rng):
    p = mod.init_parameter_values()
    return p[:, None] * (1.0 + 0.05 * rng.standard_normal((p.size, n)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "fn, text, match",
    [
        ("parse", "mystery(1)\n", "unknown declaration"),
        ("parse", 'states("S", a=1.0)\nb = 2.0\n', "no d<state>_dt"),
        ("generate", 'states("S", a=1.0)\nda_dt = sinh(a)\n', "unsupported function"),
        ("generate", 'states("S", a=1.0)\nu = w + 1\nw = u + 1\nda_dt = u\n', "circular"),
        ("parse", 'states("S", a=1.0)\nu = 1\nu = 2\nda_dt = u\n', "reassignment"),
    ],
)
def test_parser_errors_match_jax(fn, text, match):
    for mod in (jode, odefile):
        with pytest.raises(ValueError, match=match):
            parsed = mod.parse_ode(text, name="x")
            if fn == "generate":
                mod.generate_code(parsed)


@pytest.mark.parametrize("params", ["vector", "field"])
@pytest.mark.parametrize("name", SOURCES)
def test_generated_module_matches_jax(name, params):
    tm, jm = load(name)
    assert tm._STATE_NAMES == jm._STATE_NAMES and tm._PARAM_NAMES == jm._PARAM_NAMES
    np.testing.assert_array_equal(tm.init_state_values(), jm.init_state_values())
    np.testing.assert_array_equal(tm.init_parameter_values(), jm.init_parameter_values())
    assert all(tm.state_index(s) == jm.state_index(s) for s in jm._STATE_NAMES)
    assert all(tm.parameter_index(p) == jm.parameter_index(p) for p in jm._PARAM_NAMES)
    assert (tm.num_states, tm.num_parameters) == (jm.num_states, jm.num_parameters)
    with pytest.raises(KeyError):
        tm.init_state_values(nope=1.0)
    n = 64
    S, rng = random_states(tm, name, n, seed=1)
    P = tm.init_parameter_values() if params == "vector" else random_field(tm, n, rng)
    for t in TIMES:
        for fn, extra in (("rhs", ()), ("forward_euler", (0.05,)), ("generalized_rush_larsen", (0.05,))):
            out = getattr(tm, fn)(torch.tensor(S), t, P, *extra).numpy()
            if params == "vector":
                ref = np.asarray(getattr(jm, fn)(jnp.asarray(S), t, jnp.asarray(P), *extra))
            else:
                ref = np.stack([np.asarray(getattr(jm, fn)(jnp.asarray(S[:, i : i + 1]), t, jnp.asarray(P[:, i]),
                                                            *extra))[:, 0] for i in range(n)], axis=1)
            np.testing.assert_allclose(out, ref, rtol=RTOL, atol=1e-300, err_msg=f"{name} {fn} t={t}")


def _spec(mod, scheme):
    return cuda_ode.ionic_model(getattr(mod, scheme))


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("form", ["b1", "node"])
@pytest.mark.parametrize("name", KERNEL_SOURCES)
def test_b1_twins_match_pallas_kernel(name, form, scheme):
    """B1 and its per-node form, V injected into the model's own row,
    against the JAX ionic kernel in its v_index form traced over the JAX
    module's step, interpret mode, n = 1024, the coverage source's
    stimulus on (t = 2)."""
    tm, jm = load(name)
    spec = _spec(tm, scheme)
    vi = spec.v_index
    n = 1024
    S, rng = random_states(tm, name, n, seed=2)
    v = rng.uniform(*RANGES[name][tm._STATE_NAMES[vi]], n)
    states = torch.tensor(S)
    S_ = S.shape[0]
    if form == "node":
        field = random_field(tm, n, rng)
        step = build_pallas_ode_step(getattr(jm, scheme), num_states=S_, n_nodes=n, parameters=None,
                                     dtype=jnp.float64, v_index=vi, node_params=field.shape[0], interpret=True)
        ref = np.asarray(step(jnp.asarray(S), jnp.asarray(v), jnp.asarray(field), 2.0, 0.05))
        out = spec.node_step(states, torch.tensor(v), 2.0, 0.05, torch.tensor(field))
    else:
        p = tm.init_parameter_values()
        step = build_pallas_ode_step(getattr(jm, scheme), num_states=S_, n_nodes=n, parameters=p,
                                     dtype=jnp.float64, v_index=vi, interpret=True)
        ref = np.asarray(step(jnp.asarray(S), jnp.asarray(v), 2.0, 0.05))
        out = spec.step(states, torch.tensor(v), 2.0, 0.05, p)
    assert out is states  # in place
    np.testing.assert_allclose(states.numpy(), ref, rtol=RTOL, atol=1e-300)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("name", KERNEL_SOURCES)
def test_b7_twin_matches_pallas_kernel(name, scheme):
    """B7 over two parameter sets of one generated model in
    make_multi_ode's storage layout, against the JAX block-skip kernel
    with its row swaps, interpret mode; a marker value with no model keeps
    its states, V injected."""
    tm, jm = load(name)
    spec = _spec(tm, scheme)
    vi = spec.v_index
    n = 2500
    S, rng = random_states(tm, name, n, seed=4)
    markers = np.repeat(rng.integers(0, 2, n // 50 + 1), 50)[:n]
    markers[rng.choice(n, size=n // 50, replace=False)] = 7
    p0 = jm.init_parameter_values()
    params = {0: p0, 1: p0 * (1.0 + 0.1 * rng.standard_normal(p0.size))}
    fj, _, masks, common = jodesolver.make_multi_ode(markers, {m: getattr(jm, scheme) for m in params},
                                                     {m: jm.init_state_values() for m in params}, params,
                                                     {m: vi for m in params})
    assert common == 0 and fj.multi["trivial_swap"] == [vi == 0] * 2
    step = build_pallas_multi_ode_step(fj.multi, masks_np=masks, num_states=S.shape[0], n_nodes=n,
                                       dtype=jnp.float64, v_index=0, interpret=True)
    perm = np.arange(S.shape[0])
    perm[[0, vi]] = [vi, 0]
    s = S[perm]  # storage layout
    v = rng.uniform(*RANGES[name][tm._STATE_NAMES[vi]], n)
    ref = np.asarray(step(jnp.asarray(s), jnp.asarray(v), jnp.asarray(masks, dtype=jnp.float64), 2.0, 0.05))
    index = torch.as_tensor(cuda_ode.model_index_from_masks(masks))
    states = torch.tensor(s)
    spec.multi_step(states, torch.tensor(v), index, 2.0, 0.05, torch.tensor(np.stack([params[0], params[1]])))
    np.testing.assert_allclose(states.numpy(), ref, rtol=RTOL, atol=1e-300)
    none = index.numpy() < 0
    np.testing.assert_array_equal(states.numpy()[1:, none], s[1:, none])
    np.testing.assert_array_equal(states.numpy()[0, none], v[none])


_HARNESS = r"""
#define __device__
#define __forceinline__ inline
#include <cmath>
#include "ode_body.cuh"

struct Strided {
    const float* base;
    long long ld;
    float operator()(int k) const { return base[k * ld]; }
};

extern "C" void step(int scheme, float* states, const float* v, const float* params, long long n, float t,
                     float dt) {
    for (long long i = 0; i < n; ++i) {
        const Strided prm{params + i, n};
        if (scheme == fbt_ode::kGrl) {
            fbt_ode::node<fbt_ode::kGrl>(states + i, n, fbt_ode::kVRow, 0, v[i], t, dt, prm);
        } else {
            fbt_ode::node<fbt_ode::kFe>(states + i, n, fbt_ode::kVRow, 0, v[i], t, dt, prm);
        }
    }
}
"""


@pytest.fixture(scope="module")
def host_bodies(tmp_path_factory):
    """Each kernel source's node body built by the host's g++ into a
    ctypes library (the float32 arithmetic of the card's kernels, without
    contraction: -ffp-contract=off, as the card builds with -fmad=false)."""
    gpp = shutil.which("g++")
    if gpp is None:
        pytest.skip("needs the host's g++")
    out = {}
    for name in KERNEL_SOURCES:
        tm, _ = load(name)
        d = tmp_path_factory.mktemp(name)
        (d / "ode_body.cuh").write_text(tm.cuda_source)
        (d / "harness.cpp").write_text(_HARNESS)
        subprocess.run([gpp, "-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC", "-o",
                        str(d / "body.so"), str(d / "harness.cpp")], check=True, capture_output=True)
        out[name] = (tm, ctypes.CDLL(str(d / "body.so")))
    return out


def test_cuda_body_prints_float32_only():
    for name in KERNEL_SOURCES:
        src, _ = load(name)
        body = src.cuda_source
        assert "double" not in body
        for fn in ("exp(", "log(", "sqrt(", "pow(", "floor(", "fabs("):
            assert f" {fn}" not in body and f"({fn}" not in body and f"*{fn}" not in body, fn
        literals = re.findall(r"(?<![\w.])(\d+\.\d+e[+-]\d+)(F?)", body)
        assert literals and all(f == "F" for _, f in literals)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("name", KERNEL_SOURCES)
def test_cuda_body_matches_float32_twin_on_host(host_bodies, name, scheme):
    tm, lib = host_bodies[name]
    vi = cuda_ode.voltage_row(tm)
    n = 1024
    S, rng = random_states(tm, name, n, seed=6)
    v = rng.uniform(*RANGES[name][tm._STATE_NAMES[vi]], n)
    field = random_field(tm, n, rng)
    for t in TIMES:
        out = np.ascontiguousarray(S, dtype=np.float32)
        vf, pf = np.ascontiguousarray(v, dtype=np.float32), np.ascontiguousarray(field, dtype=np.float32)
        lib.step(ctypes.c_int(0 if scheme == SCHEMES[0] else 1), out.ctypes.data_as(ctypes.c_void_p),
                 vf.ctypes.data_as(ctypes.c_void_p), pf.ctypes.data_as(ctypes.c_void_p), ctypes.c_longlong(n),
                 ctypes.c_float(t), ctypes.c_float(0.05))
        s = torch.tensor(S, dtype=torch.float32)
        s[vi] = torch.tensor(vf)
        ref = getattr(tm, scheme)(s, t, torch.tensor(pf), 0.05).numpy()
        ulp = np.spacing(np.abs(ref).max(axis=1)).astype(np.float64)
        gap = np.abs(out.astype(np.float64) - ref).max(axis=1) / ulp
        assert (gap <= 4).all(), f"{name} {scheme} t={t}: per row {gap} ulps"


def test_demo_configuration_matches_jax():
    """demos/custom_ode.py's configuration: the Niederer slab at dx=0.5
    with the inline FHN's GRL, Strang, dt=0.05, for a fixed 10 ms (its
    probes never fire, so run_niederer_benchmark would run on to 10 T)."""
    tm, jm = load("fhn_inline")
    js = jnied._build_solver(dx=0.5, theta=0.5, model=jm, operator_cache_key=None, use_pallas_ode=False)
    assert js.solve((0.0, 10.0), dt=0.05).name == "OK"
    ts = tnied._build_solver(dx=0.5, theta=0.5, model=tm, device="cpu", dtype=torch.float64)
    assert ts.solve((0.0, 10.0), dt=0.05) == Status.OK
    assert ts._ionic is _spec(tm, SCHEMES[0]) and ts.v_index == 0
    np.testing.assert_allclose(ts.states.numpy(), np.asarray(js.states)[:, : ts._n], rtol=0, atol=1e-8)
    np.testing.assert_array_equal(ts.activation_times(), np.asarray(js.activation_times()))
    assert float(ts.v.max()) > -85.0  # the stimulus moved v


def test_generated_forward_euler_reproduces_bidomain_demo():
    """The bidomain demo's configuration (FHN, stimulus amplitude 0 in the
    model, an external TimeWindow, Strang) at nx=12 for 6 ms, on the
    generated forward_euler and on the hand-written FHN: the same
    formulas in another association order, with the rows mapped."""
    tm, _ = load("fhn_inline")
    hand = tbs.demo_solver(12, device="cpu")
    gen = tbs.demo_solver(12, device="cpu", ode_fun=tm.forward_euler, init_states=tm.init_state_values(),
                          parameters=tm.init_parameter_values(), v_index=tm.state_index("v"))
    for s in (hand, gen):
        assert s.solve((0.0, 6.0), dt=0.1, save_freq=20) == Status.OK
    assert float(hand.v.max()) > 0.0  # it propagates
    for a, b in ((gen.states[0], hand.states[1]), (gen.states[1], hand.states[0]), (gen.u_e, hand.u_e)):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-12 * scale


def test_registration_and_refusals():
    tm, _ = load("fhn_inline")
    grl, fe = _spec(tm, SCHEMES[0]), _spec(tm, SCHEMES[1])
    assert (grl.name, fe.name) == ("fhn_inline_grl", "fhn_inline_fe")
    assert grl.module is fe.module is tm and grl.v_index == 0 and grl.num_params == 6
    assert grl.step.__name__ == "fhn_inline_grl_step_v" and grl.step.launches == 0
    # a second load of the same text is the same module, with the same
    # kernels, and registers nothing new; another name is another model
    n_models = len(cuda_ode.IONIC_MODELS)
    for _ in range(3):
        again = odefile.load_ode((odefile.ODES / "fhn_inline.ode").read_text(), name="fhn_inline")
        assert again is tm and _spec(again, SCHEMES[0]) is grl
    assert len(cuda_ode.IONIC_MODELS) == n_models
    other = odefile.load_ode((odefile.ODES / "fhn_inline.ode").read_text(), name="fhn_copy")
    assert other is not tm and _spec(other, SCHEMES[0]).name == "fhn_copy_grl"
    assert len(cuda_ode.IONIC_MODELS) == n_models + 2
    assert _build.model_symbol(load("coverage")[0].cuda_source) != _build.model_symbol(tm.cuda_source)
    # a step with no kernels raises (the hand-written TP06's forward Euler
    # has its kernels); a GRL/FE pair of one generated model is two models
    # to B7: they compose, and the mixed layer's twin step equals
    # make_multi_ode's composed step
    with pytest.raises(NotImplementedError, match="A4"):
        cuda_ode.ionic_model(ttp.rhs)
    assert cuda_ode.ionic_model(ttp.forward_euler).name == "tp06_fe"
    pair = {0: tm.generalized_rush_larsen, 1: tm.forward_euler}
    assert [(spec is grl, m) for spec, m in check_multi_models(pair).groups] == [(True, (0,)), (False, (1,))]
    assert check_multi_models(pair).groups[1][0] is fe
    assert check_multi_models({0: tm.forward_euler, 3: tm.forward_euler}).groups == ((fe, (0, 3)),)
    n, vi = 64, cuda_ode.voltage_row(tm)
    markers = np.arange(n) % 3  # marker 2 has no model
    init = {m: tm.init_state_values() for m in pair}
    params = {m: tm.init_parameter_values() for m in pair}
    v_idx = {m: vi for m in pair}
    composed, union, masks, _ = make_multi_ode(markers, pair, init, params, v_idx)
    layer = ionic_layer(check_ionic_scope(pair, markers, init, params, v_idx), pair, markers, init, params, v_idx,
                        n, torch.device("cpu"), torch.float64, True)
    assert [g.model for g in layer.groups] == [grl, fe]
    rng = np.random.default_rng(11)
    S = torch.tensor(union * (1 + 0.05 * rng.standard_normal(union.shape)))
    v = torch.tensor(rng.uniform(-80.0, 20.0, n))
    ref = S.clone()
    ref[0] = v
    ref = composed(ref, 1.0, masks, 0.05)
    layer.step(S, v, 1.0, 0.05)
    torch.testing.assert_close(S, ref, rtol=1e-12, atol=0)
    # a model with no voltage state loads and steps, with no kernels
    toy, _ = load("toy_gate")
    assert toy.cuda_source is None
    with pytest.raises(NotImplementedError):
        cuda_ode.ionic_model(toy.generalized_rush_larsen)
    assert cuda_ode.ionic_model(tfhn.forward_euler).name == "fhn"


def test_load_ode_names_and_code_round_trip(tmp_path):
    """A path loads under its stem; module.code is importable as a file,
    as the reference's user pattern writes it (as the JAX tests check)."""
    tm = odefile.load_ode(odefile.ODES / "coverage.ode")
    assert tm.__name__ == "coverage" and tm.num_states == 4 and tm.num_parameters == 7
    f = tmp_path / "coverage_gen.py"
    f.write_text(tm.code)
    import importlib.util

    spec = importlib.util.spec_from_file_location("coverage_gen", f)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    S, _ = random_states(tm, "coverage", 8, seed=9)
    p = tm.init_parameter_values()
    assert torch.equal(mod.generalized_rush_larsen(torch.tensor(S), 2.0, p, 0.05),
                       tm.generalized_rush_larsen(torch.tensor(S), 2.0, p, 0.05))


def test_custom_ode_benchmark_runs_on_the_cpu(capsys):
    out = custom_ode.main(["--dx", "1.0", "-T", "1", "--device", "cpu"])
    assert out["model"] == "fhn_inline" and out["num_states"] == 2 and out["single_cell_finite"]
    # the inline FHN does not propagate: the stimulated corner fires, the
    # far probes never do, so the horizon runs on in 20 ms chunks to 10 T
    times = out["activation_times"]
    assert out["n_nodes"] == 672 and out["simulated_ms"] >= 10.0
    assert times["P1"] >= 0 and all(times[f"P{i}"] < 0 for i in range(2, 10))
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("{")


def test_port_imports_no_jax_with_a_model_loaded():
    code = (
        "import sys; from fenicsx_beat_tpu_torch import odefile; "
        "from fenicsx_beat_tpu_torch.benchmarks import custom_ode; "
        "m = odefile.load_ode(odefile.ODES / 'coverage.ode'); "
        "import torch; m.generalized_rush_larsen(torch.zeros(4, 3) + 1.0, 0.0, m.init_parameter_values(), 0.1); "
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'fenicsx_beat_tpu.'))"
        " or k == 'fenicsx_beat_tpu']; print(bad); sys.exit(1 if bad else 0)"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", SCHEMES)
def test_generated_kernels_match_twins_on_card(cuda_device, scheme):
    """Each generated form against its twin on the card, one step and a
    short beat at n = 100,000, through kernel_check.ionic_form_checks."""
    from fenicsx_beat_tpu_torch.benchmarks import kernel_check as kc

    for name in KERNEL_SOURCES:
        tm, _ = load(name)
        spec = _spec(tm, scheme)
        n = 100_000
        S, rng = random_states(tm, name, n, seed=11)
        v = rng.uniform(*RANGES[name][tm._STATE_NAMES[spec.v_index]], n)
        table = np.stack([tm.init_parameter_values(), random_field(tm, 1, rng)[:, 0], tm.init_parameter_values()])

        def rest(r):
            x, _ = random_states(tm, name, n, seed=int(r.integers(1 << 30)))
            return x

        out = kc.ionic_form_checks(spec, S, v, table, rest, rng, device=cuda_device, beat_steps=200)
        assert out["uniform_bits"]
        for form, res in out["forms"].items():
            for (t, dt, g), (a, e) in res["step"].items():
                assert (a == 0.0) if g == "no layer" else bool((e <= kc.IONIC_STEP_TOL).all()), (form, t, dt, g)
            assert all(bool((e <= kc.IONIC_BEAT_TOL).all()) for _, e in res["beat"].values()), form
