"""The 2.0 optimizers and LR schedulers of the port against the
reference's, on the CPU.

Each optimizer trains the same small eager network (the reference's
weights loaded into the port's) for 5 steps on the same batches in both
packages: the losses and every parameter after each step within 1e-5.
The imperative path's pieces: the grad clip, weight decay, a parameter
with no gradient, ``state_dict`` keyed by parameter position (saved by
one package, restored into the other), the state pending before the
first step, and ``minimize`` under dygraph. Each LR scheduler's rate
sequence over 12 steps equals the reference's (1e-7), and a scheduler
drives both the dygraph optimizer's micro-program and a static program
run by the Executor.
"""

import numpy as np
import pytest

import paddle_tpu as rpt
import paddle_tpu_torch as tpt

R = np.random.RandomState(3)
X = [R.randn(6, 4).astype(np.float32) for _ in range(5)]
Y = [R.randn(6, 2).astype(np.float32) for _ in range(5)]


def guard(pkg):
    return pkg.dygraph.guard() if pkg is rpt else pkg.dygraph.guard("cpu")


def net(P):
    return P.nn.Sequential(P.nn.Linear(4, 8), P.nn.Tanh(),
                           P.nn.Linear(8, 2))


# name -> make(P, params) -> optimizer
OPTS = {
    "SGD": lambda P, ps: P.optimizer.SGD(0.1, parameters=ps),
    "SGD[weight_decay]": lambda P, ps: P.optimizer.SGD(
        0.1, parameters=ps, weight_decay=0.01),
    "Momentum": lambda P, ps: P.optimizer.Momentum(
        0.05, momentum=0.9, parameters=ps),
    "Momentum[nesterov]": lambda P, ps: P.optimizer.Momentum(
        0.05, momentum=0.9, use_nesterov=True, parameters=ps),
    "Adam": lambda P, ps: P.optimizer.Adam(0.01, parameters=ps),
    "AdamW": lambda P, ps: P.optimizer.AdamW(0.01, parameters=ps,
                                             weight_decay=0.05),
    "Adam[clip]": lambda P, ps: P.optimizer.Adam(
        0.01, parameters=ps, grad_clip=P.nn.ClipGradByGlobalNorm(0.5)),
    "Lamb": lambda P, ps: P.optimizer.Lamb(0.01, parameters=ps),
    "Adagrad": lambda P, ps: P.optimizer.Adagrad(
        0.1, parameters=ps, initial_accumulator_value=0.1),
    "Adamax": lambda P, ps: P.optimizer.Adamax(0.01, parameters=ps),
    "Adadelta": lambda P, ps: P.optimizer.Adadelta(1.0, parameters=ps),
    "RMSProp": lambda P, ps: P.optimizer.RMSProp(
        0.01, momentum=0.5, parameters=ps),
    "RMSProp[centered]": lambda P, ps: P.optimizer.RMSProp(
        0.01, centered=True, parameters=ps),
    "DecayedAdagrad": lambda P, ps: P.optimizer.DecayedAdagrad(
        0.1, parameters=ps),
    "Ftrl": lambda P, ps: P.optimizer.Ftrl(0.1, l1=0.01, l2=0.01,
                                           parameters=ps),
    "LarsMomentum": lambda P, ps: P.optimizer.LarsMomentumOptimizer(
        0.1, parameters=ps),
}


def train(pkg, make_opt, steps=5, state=None, use_minimize=False):
    with guard(pkg):
        model = net(pkg)
        if state is not None:
            model.set_state_dict(state)
        start = {k: v.numpy() for k, v in model.state_dict().items()}
        opt = make_opt(pkg, model.parameters())
        losses, after = [], []
        for i in range(steps):
            x = pkg.dygraph.VarBase(X[i])
            y = pkg.dygraph.VarBase(Y[i])
            loss = ((model(x) - y) ** 2.0).mean()
            loss.backward()
            if use_minimize:
                opt.minimize(loss)
                model.clear_gradients()
            else:
                opt.step()
                opt.clear_grad()
            losses.append(float(loss))
            after.append({k: v.numpy() for k, v in
                          model.state_dict().items()})
        return start, losses, after, opt.state_dict()


@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizer_over_5_steps_matches_the_reference(name):
    ref = train(rpt, OPTS[name])
    port = train(tpt, OPTS[name], state=ref[0])
    np.testing.assert_allclose(port[1], ref[1], rtol=1e-5, atol=1e-5)
    for step, (pa, ra) in enumerate(zip(port[2], ref[2])):
        for k in ra:
            np.testing.assert_allclose(pa[k], ra[k], rtol=1e-5, atol=1e-5,
                                       err_msg=f"step {step} {k}")
    assert sorted(port[3]) == sorted(ref[3])
    for k in ref[3]:
        np.testing.assert_allclose(port[3][k], ref[3][k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_minimize_under_dygraph_is_step():
    a = train(tpt, OPTS["Adam"])
    b = train(tpt, OPTS["Adam"], state=a[0], use_minimize=True)
    np.testing.assert_array_equal(a[1], b[1])


def test_a_parameter_without_a_gradient_is_left_alone():
    with guard(tpt):
        lin, other = tpt.nn.Linear(2, 2), tpt.nn.Linear(2, 2)
        opt = tpt.optimizer.Adam(0.1, parameters=lin.parameters()
                                 + other.parameters())
        before = other.weight.numpy()
        lin(tpt.to_tensor(np.ones((1, 2), np.float32))).sum().backward()
        opt.step()
        np.testing.assert_array_equal(other.weight.numpy(), before)
        assert not np.array_equal(lin.weight.numpy(), before)


def test_optimizer_state_crosses_packages_and_waits_for_the_first_step():
    """State saved by the reference's optimizer after 2 steps, set on a
    fresh port optimizer before its first step (pending until the
    micro-program exists), continues as the reference continues."""
    ref = train(rpt, OPTS["Adam"], steps=2)
    with guard(rpt):
        model = net(rpt)
        model.set_state_dict(ref[2][-1])
        opt = rpt.optimizer.Adam(0.01, parameters=model.parameters())
        opt.set_state_dict(ref[3])
        loss = ((model(rpt.dygraph.VarBase(X[2]))
                 - rpt.dygraph.VarBase(Y[2])) ** 2.0).mean()
        loss.backward()
        opt.step()
        want = {k: v.numpy() for k, v in model.state_dict().items()}
    with guard(tpt):
        model = net(tpt)
        model.set_state_dict(ref[2][-1])
        opt = tpt.optimizer.Adam(0.01, parameters=model.parameters())
        opt.set_state_dict(ref[3])
        loss = ((model(tpt.dygraph.VarBase(X[2]))
                 - tpt.dygraph.VarBase(Y[2])) ** 2.0).mean()
        loss.backward()
        opt.step()
        for k, v in model.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        with pytest.raises(ValueError, match="restored 0 entries"):
            opt.set_state_dict({"nothing#0": np.zeros(1)})


# -- LR schedulers -------------------------------------------------------------

def _lr(P):
    return P.optimizer.lr


SCHEDS = {
    "NoamDecay": lambda P: _lr(P).NoamDecay(64, 4),
    "PiecewiseDecay": lambda P: _lr(P).PiecewiseDecay([3, 6], [1.0, 0.5,
                                                               0.1]),
    "NaturalExpDecay": lambda P: _lr(P).NaturalExpDecay(0.5, 0.3),
    "InverseTimeDecay": lambda P: _lr(P).InverseTimeDecay(0.5, 0.3),
    "PolynomialDecay": lambda P: _lr(P).PolynomialDecay(0.5, 5, 0.01, 2.0),
    "PolynomialDecay[cycle]": lambda P: _lr(P).PolynomialDecay(
        0.5, 4, 0.01, 1.0, cycle=True),
    "LinearWarmup": lambda P: _lr(P).LinearWarmup(0.5, 4, 0.0, 0.5),
    "LinearWarmup[wrapped]": lambda P: _lr(P).LinearWarmup(
        _lr(P).ExponentialDecay(0.5, 0.8), 3, 0.1, 0.5),
    "ExponentialDecay": lambda P: _lr(P).ExponentialDecay(0.5, 0.8),
    "MultiStepDecay": lambda P: _lr(P).MultiStepDecay(0.5, [2, 5, 9]),
    "StepDecay": lambda P: _lr(P).StepDecay(0.5, 3, 0.5),
    "LambdaDecay": lambda P: _lr(P).LambdaDecay(0.5, lambda e: 0.9 ** e),
    "CosineAnnealingDecay": lambda P: _lr(P).CosineAnnealingDecay(0.5, 6,
                                                                  0.05),
}
PLATEAU = [1.0, 0.9, 0.95, 0.96, 0.97, 0.5, 0.6, 0.61, 0.62, 0.63, 0.7,
           0.2]


@pytest.mark.parametrize("name", sorted(SCHEDS))
def test_scheduler_rates_match_the_reference(name):
    seqs = []
    for P in (rpt, tpt):
        s = SCHEDS[name](P)
        rates = [s()]
        for _ in range(12):
            s.step()
            rates.append(s())
        s.step(3)
        rates.append(s.last_lr)
        seqs.append(rates)
    np.testing.assert_allclose(seqs[1], seqs[0], rtol=1e-7, atol=0)


def test_reduce_on_plateau_matches_the_reference():
    out = []
    for P in (rpt, tpt):
        s = _lr(P).ReduceOnPlateau(0.5, factor=0.5, patience=2, cooldown=1)
        rates = []
        for m in PLATEAU:
            s.step(m)
            rates.append(s.last_lr)
        out.append((rates, s.state_dict()))
    assert out[0] == out[1]


def test_a_scheduler_drives_the_dygraph_optimizer():
    def make(P, ps):
        return P.optimizer.SGD(_lr(P).StepDecay(0.2, 2, 0.5), parameters=ps)

    for P in (rpt, tpt):
        with guard(P):
            model = net(P)
            opt = make(P, model.parameters())
            sched = opt._learning_rate
            seen = []
            for i in range(4):
                model(P.dygraph.VarBase(X[i])).sum().backward()
                opt.step()
                opt.clear_grad()
                seen.append(round(opt.current_step_lr(), 6))
                sched.step()
            assert seen == [0.2, 0.2, 0.1, 0.1], (P.__name__, seen)


def test_a_scheduler_drives_a_static_program():
    """In static mode the scheduler's rate is a [1] var of the global
    scope; ``step()`` writes it in place, so a compiled step (captured
    after its first run) reads each new rate."""
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import global_scope, scope_guard, Scope

    with scope_guard(Scope()):
        main, startup = tpt.Program(), tpt.Program()
        with tpt.program_guard(main, startup):
            x = L.data("x", [6, 4], append_batch_size=False)
            w = L.create_parameter([4, 2], "float32", name="w",
                                   default_initializer=None)
            loss = L.reduce_mean(L.matmul(x, w))
            sched = _lr(tpt).ExponentialDecay(0.5, 0.5)
            opt = tpt.optimizer.SGD(sched)
            opt.minimize(loss)
        exe = Executor("cpu")
        exe.run(startup, use_compiled=False)
        scope = global_scope()
        grad = np.full((4, 2), X[0].mean(0)[:, None].repeat(2, 1) / 2)
        w0 = scope.find_var("w").numpy().copy()
        for i in range(4):
            exe.run(main, feed={"x": X[0]}, fetch_list=[loss])
            sched.step()
        lr_sum = 0.5 * (1 + 0.5 + 0.25 + 0.125)
        np.testing.assert_allclose(scope.find_var("w").numpy(),
                                   w0 - lr_sum * grad, rtol=1e-5,
                                   atol=1e-6)
