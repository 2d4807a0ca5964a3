"""The port's optimizers (``repro_torch.optim``) against the JAX package's
(``repro.optim``), on the CPU.

The same parameters and the same gradients, made from a seed with NumPy,
go into both packages' ``update`` for 10 steps; every parameter (and every
moment) must agree within 1e-6 of its largest value (``OPT_TOL``): the
update equations are the same term for term, so the two differ by float32
rounding only (``pow``, ``sqrt`` and ``cos`` may differ in the last place).
Moments kept in bf16 (``state_dtype``) must agree within one bf16 step
(2^-7 of the value's binade). Then the schedules at steps 0, the end of the
warmup, the middle and the end; ``fedprox_loss``'s value and gradient; and
the reference's own convergence checks (tests/test_core_units.py), run on
the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as R
from repro_torch import optim as O

OPT_TOL = 1e-6
SHAPES = {"a": (3,), "b": (4, 5), "c": (2, 3, 4)}
STEPS = 10

# name -> (reference optimizer, port optimizer)
CASES = {
    "sgd": (lambda: R.sgd(0.1), lambda: O.sgd(0.1)),
    "sgd_wd": (lambda: R.sgd(0.1, weight_decay=0.01),
               lambda: O.sgd(0.1, weight_decay=0.01)),
    "sgd_momentum": (lambda: R.sgd(0.05, momentum=0.9),
                     lambda: O.sgd(0.05, momentum=0.9)),
    "sgd_momentum_wd": (lambda: R.sgd(0.05, momentum=0.9, weight_decay=0.01),
                        lambda: O.sgd(0.05, momentum=0.9, weight_decay=0.01)),
    "sgd_momentum_bf16_state": (
        lambda: R.sgd(0.05, momentum=0.9, state_dtype=jnp.bfloat16),
        lambda: O.sgd(0.05, momentum=0.9, state_dtype=torch.bfloat16)),
    "sgd_cosine": (lambda: R.sgd(R.cosine_schedule(0.1, 10, warmup=3)),
                   lambda: O.sgd(O.cosine_schedule(0.1, 10, warmup=3))),
    "adam": (lambda: R.adam(0.01), lambda: O.adam(0.01)),
    "adam_wd": (lambda: R.adam(0.01, weight_decay=0.01),
                lambda: O.adam(0.01, weight_decay=0.01)),
    "adamw": (lambda: R.adamw(0.01), lambda: O.adamw(0.01)),
    "adamw_cosine": (
        lambda: R.adamw(R.cosine_schedule(0.01, 10, warmup=2)),
        lambda: O.adamw(O.cosine_schedule(0.01, 10, warmup=2))),
    "adamw_bf16_state": (
        lambda: R.adamw(0.01, state_dtype=jnp.bfloat16),
        lambda: O.adamw(0.01, state_dtype=torch.bfloat16)),
}


def _arrays(rng):
    return {n: rng.normal(size=s).astype(np.float32)
            for n, s in SHAPES.items()}


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _close(got, want, what):
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= OPT_TOL, f"{what}: {err:.3g} of the largest value"


def _one_bf16_step(got, want, what):
    got, want = _np(got), _np(want)
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= step), what


@pytest.mark.parametrize("case", sorted(CASES))
def test_update_matches_reference(case):
    ref_opt, port_opt = (f() for f in CASES[case])
    rng = np.random.default_rng(0)
    init = _arrays(rng)
    ref_p = {n: jnp.asarray(a) for n, a in init.items()}
    port_p = {n: torch.from_numpy(a.copy()) for n, a in init.items()}
    ref_s, port_s = ref_opt.init(ref_p), port_opt.init(port_p)
    assert port_s["step"].dtype == torch.int32
    for step in range(STEPS):
        grads = _arrays(rng)
        ref_p, ref_s = ref_opt.update(
            {n: jnp.asarray(g) for n, g in grads.items()}, ref_s, ref_p)
        port_p, port_s = port_opt.update(
            {n: torch.from_numpy(g) for n, g in grads.items()}, port_s,
            port_p)
        assert int(port_s["step"]) == int(ref_s["step"]) == step + 1
        for n in SHAPES:
            assert port_p[n].dtype == torch.float32
            _close(port_p[n], ref_p[n], f"{case} step {step} param {n}")
            for key in ("mu", "m", "v"):
                if key not in ref_s:
                    continue
                got, want = port_s[key][n], ref_s[key][n]
                assert str(got.dtype).split(".")[-1] == str(want.dtype)
                check = (_one_bf16_step if got.dtype == torch.bfloat16
                         else _close)
                check(got, want, f"{case} step {step} {key} {n}")


def test_sgd_on_bf16_params_matches_reference():
    """bf16 parameters: the step in float32, cast back (one bf16 step)."""
    rng = np.random.default_rng(1)
    init = _arrays(rng)
    ref_opt = R.sgd(0.1, momentum=0.9, weight_decay=0.01)
    port_opt = O.sgd(0.1, momentum=0.9, weight_decay=0.01)
    ref_p = {n: jnp.asarray(a, jnp.bfloat16) for n, a in init.items()}
    port_p = {n: torch.from_numpy(a).to(torch.bfloat16)
              for n, a in init.items()}
    ref_s, port_s = ref_opt.init(ref_p), port_opt.init(port_p)
    for _ in range(STEPS):
        grads = _arrays(rng)
        ref_p, ref_s = ref_opt.update(
            {n: jnp.asarray(g, jnp.bfloat16) for n, g in grads.items()},
            ref_s, ref_p)
        port_p, port_s = port_opt.update(
            {n: torch.from_numpy(g).to(torch.bfloat16)
             for n, g in grads.items()}, port_s, port_p)
        for n in SHAPES:
            assert port_p[n].dtype == torch.bfloat16
            _one_bf16_step(port_p[n], ref_p[n], n)


@pytest.mark.parametrize("sched", ["constant", "cosine", "cosine_nowarm"])
def test_schedules_match_reference(sched):
    make = {"constant": lambda M: M.constant_schedule(0.3),
            "cosine": lambda M: M.cosine_schedule(1.0, total_steps=100,
                                                  warmup=10),
            "cosine_nowarm": lambda M: M.cosine_schedule(
                0.5, total_steps=40, final_frac=0.2)}[sched]
    ref, port = make(R), make(O)
    for step in (0, 5, 10, 55, 100, 140):
        got = port(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        want = np.float32(ref(jnp.asarray(step, jnp.int32)))
        assert abs(float(got) - float(want)) <= OPT_TOL * max(abs(want),
                                                              1.0), step
        assert float(port(step)) == float(got)  # a Python int too


def test_fedprox_loss_value_and_gradient_match_reference():
    rng = np.random.default_rng(2)
    p0, g0, target = _arrays(rng), _arrays(rng), _arrays(rng)

    def ref_base(p, batch):
        return sum(jnp.sum((p[n] - batch[n]) ** 2) for n in sorted(p))

    def port_base(p, batch):
        return sum(torch.sum((p[n] - batch[n]) ** 2) for n in sorted(p))

    ref_loss = R.fedprox_loss(ref_base, mu=0.1)
    port_loss = O.fedprox_loss(port_base, mu=0.1)
    want, want_g = jax.value_and_grad(ref_loss)(
        {n: jnp.asarray(a) for n, a in p0.items()},
        {n: jnp.asarray(a) for n, a in target.items()},
        {n: jnp.asarray(a) for n, a in g0.items()})
    p = {n: torch.from_numpy(a).requires_grad_() for n, a in p0.items()}
    got = port_loss(p, {n: torch.from_numpy(a) for n, a in target.items()},
                    {n: torch.from_numpy(a) for n, a in g0.items()})
    got.backward()
    got = float(got.detach())
    assert abs(got - float(want)) <= OPT_TOL * abs(float(want))
    for n in SHAPES:
        _close(p[n].grad, want_g[n], f"grad {n}")


def test_state_lives_on_the_params_device():
    """The step counter is int32 on the parameters' device (meta here:
    nothing is allocated), the moments on it too."""
    params = {"w": torch.empty(3, device="meta")}
    for opt in (O.sgd(0.1, momentum=0.9), O.adamw(0.1)):
        state = opt.init(params)
        assert state["step"].device.type == "meta"
        assert state["step"].dtype == torch.int32
        for key in ("mu", "m", "v"):
            if key in state:
                assert state[key]["w"].device.type == "meta"


# -- the reference's own checks (tests/test_core_units.py), on the port ------


def _quadratic_min(opt, steps=200):
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    state = opt.init(params)

    def loss_fn(p):
        return torch.sum((p["w"] - target) ** 2)

    for _ in range(steps):
        w = params["w"].clone().requires_grad_()
        (grad,) = torch.autograd.grad(loss_fn({"w": w}), [w])
        with torch.no_grad():
            params, state = opt.update({"w": grad}, state, params)
    return float(loss_fn(params))


def test_sgd_converges_quadratic():
    assert _quadratic_min(O.sgd(0.1)) < 1e-6


def test_sgd_momentum_converges():
    assert _quadratic_min(O.sgd(0.05, momentum=0.9)) < 1e-6


def test_adamw_converges():
    assert _quadratic_min(O.adamw(0.1, weight_decay=0.0), steps=400) < 1e-4


def test_fedprox_penalty_pulls_to_global():
    def base(p, b):
        return torch.sum((p["w"] - 10.0) ** 2)

    global_params = {"w": torch.zeros(3)}
    prox = O.fedprox_loss(base, mu=1000.0)   # huge prox => stay at global
    params = {"w": torch.zeros(3)}
    opt = O.sgd(0.001)
    state = opt.init(params)
    for _ in range(100):
        w = params["w"].clone().requires_grad_()
        (grad,) = torch.autograd.grad(prox({"w": w}, None, global_params),
                                      [w])
        with torch.no_grad():
            params, state = opt.update({"w": grad}, state, params)
    # strong prox keeps params near 0 (global), far from 10
    assert float(params["w"].abs().max()) < 1.0


def test_bf16_state_dtype():
    opt = O.sgd(0.1, momentum=0.9, state_dtype=torch.bfloat16)
    state = opt.init({"w": torch.zeros(3, dtype=torch.float32)})
    assert state["mu"]["w"].dtype == torch.bfloat16


def test_cosine_schedule_endpoints():
    s = O.cosine_schedule(1.0, total_steps=100, warmup=10)
    assert float(s(0)) == 0.0
    assert float(s(10)) == pytest.approx(1.0, abs=0.02)
    assert float(s(100)) == pytest.approx(0.1, abs=0.02)
