"""PyTorch port: the 17 learning-rate schedulers (``optimizer.lr``) against
the JAX package's.

Both are host-side Python floats computed by the same formulas, so the
rate sequences must be equal to the last bit (rtol 0): 60 ``step()``s of
every scheduler, with the options that change its formula. ``state_dict``
round trips resume a sequence where it stopped; ``ReduceOnPlateau`` follows
a metric sequence.
"""

import math

import pytest

from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.optimizer import lr as tlr

STEPS = 60

SCHEDULES = {
    "noam": lambda m: m.NoamDecay(d_model=64, warmup_steps=10,
                                  learning_rate=2.0),
    "piecewise": lambda m: m.PiecewiseDecay([10, 30], [0.1, 0.05, 0.01]),
    "natural_exp": lambda m: m.NaturalExpDecay(0.5, gamma=0.1),
    "inverse_time": lambda m: m.InverseTimeDecay(0.5, gamma=0.2),
    "polynomial": lambda m: m.PolynomialDecay(0.5, decay_steps=20,
                                              end_lr=0.01, power=2.0),
    "polynomial_cycle": lambda m: m.PolynomialDecay(
        0.5, decay_steps=20, end_lr=0.01, power=1.5, cycle=True),
    "linear_warmup_float": lambda m: m.LinearWarmup(
        0.3, warmup_steps=10, start_lr=0.0, end_lr=0.3),
    "linear_warmup_cosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.5, T_max=40), warmup_steps=10,
        start_lr=0.01, end_lr=0.5),
    "exponential": lambda m: m.ExponentialDecay(0.5, gamma=0.95),
    "multistep": lambda m: m.MultiStepDecay(0.5, milestones=[10, 25, 40],
                                            gamma=0.5),
    "step": lambda m: m.StepDecay(0.5, step_size=7, gamma=0.7),
    "lambda": lambda m: m.LambdaDecay(0.5, lambda e: 0.9 ** e),
    "multiplicative": lambda m: m.MultiplicativeDecay(0.5, lambda e: 0.97),
    "cosine": lambda m: m.CosineAnnealingDecay(0.5, T_max=25, eta_min=0.01),
    "cosine_restarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.5, T_0=7, T_mult=2, eta_min=0.01),
    "one_cycle_cos": lambda m: m.OneCycleLR(1.0, total_steps=50),
    "one_cycle_linear": lambda m: m.OneCycleLR(
        1.0, total_steps=50, divide_factor=10.0, end_learning_rate=0.001,
        phase_pct=0.4, anneal_strategy="linear"),
    "cyclic": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=5,
                                   step_size_down=8),
    "cyclic_triangular2": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=6,
                                               mode="triangular2"),
    "cyclic_exp_range": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=6,
                                             mode="exp_range",
                                             exp_gamma=0.98),
    "cyclic_scale_fn": lambda m: m.CyclicLR(
        0.01, 0.1, step_size_up=4, scale_fn=lambda x: 1.0 / (1.0 + x),
        scale_mode="iterations"),
    "linear_lr": lambda m: m.LinearLR(0.5, total_steps=20,
                                      start_factor=0.25, end_factor=1.0),
    "plateau": lambda m: m.ReduceOnPlateau(0.5),
}


def _rates(sched, steps=STEPS):
    out = [sched.last_lr]
    for _ in range(steps):
        sched.step()
        out.append(sched.last_lr)
    return out


def test_every_scheduler_class_is_covered():
    names = {n for n in dir(jlr) if isinstance(getattr(jlr, n), type)
             and issubclass(getattr(jlr, n), jlr.LRScheduler)
             and n != "LRScheduler"}
    assert len(names) == 17
    assert names == {n for n in dir(tlr) if isinstance(getattr(tlr, n), type)
                     and issubclass(getattr(tlr, n), tlr.LRScheduler)
                     and n != "LRScheduler"}
    built = {type(f(tlr)).__name__ for f in SCHEDULES.values()}
    assert built == names


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_rate_sequence_equals_jax(name):
    got = _rates(SCHEDULES[name](tlr))
    want = _rates(SCHEDULES[name](jlr))
    assert got == want
    assert all(math.isfinite(r) for r in got)


@pytest.mark.parametrize("name", sorted(set(SCHEDULES) - {"plateau"}))
def test_state_dict_round_trip_resumes(name):
    """17 steps, ``state_dict`` into a fresh scheduler, 20 more steps on
    both: the same rates. The state dict holds the JAX package's entries,
    plus ``current_lr`` where the rate is running state (there the JAX
    package's round trip restarts from the base rate)."""
    a, j = SCHEDULES[name](tlr), SCHEDULES[name](jlr)
    _rates(a, 17)
    _rates(j, 17)
    sd = a.state_dict()
    assert {k: v for k, v in sd.items() if k != "current_lr"} == \
        j.state_dict()
    assert ("current_lr" in sd) == (name == "multiplicative")
    b = SCHEDULES[name](tlr)
    b.set_state_dict(sd)
    assert _rates(b, 20) == _rates(a, 20)


@pytest.mark.parametrize("kw", [
    dict(mode="min", patience=2, cooldown=1, factor=0.5),
    dict(mode="max", patience=1, threshold=0.05, threshold_mode="abs",
         min_lr=0.1),
    dict(mode="min", patience=0, threshold_mode="rel", threshold=0.1)])
def test_reduce_on_plateau_follows_metrics(kw):
    metrics = [5.0, 4.0, 4.1, 4.05, 4.2, 3.0, 3.1, 3.2, 3.3, 3.4, 2.9,
               2.95, 2.96, 2.97, 2.98, 2.99, 1.0, None, 1.2, 1.3]
    a, b = tlr.ReduceOnPlateau(0.8, **kw), jlr.ReduceOnPlateau(0.8, **kw)
    got, want = [], []
    for m in metrics:
        a.step(m)
        b.step(m)
        got.append((a.last_lr, a.num_bad, a.cooldown_counter, a.best))
        want.append((b.last_lr, b.num_bad, b.cooldown_counter, b.best))
    assert got == want
    assert a.last_lr < 0.8  # it reduced at least once
    c = tlr.ReduceOnPlateau(0.8, **kw)
    c.set_state_dict(a.state_dict())
    for m in (0.5, 0.6, 0.7, 0.8):
        a.step(m)
        c.step(m)
        assert (c.last_lr, c.num_bad, c.best) == (a.last_lr, a.num_bad,
                                                  a.best)
