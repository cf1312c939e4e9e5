"""The port's five optimizers (rvdd_tpu_torch/training/train_state.py)
against rvdd_tpu's optax ones (rvdd_tpu/training/train_state.py:
make_optimizer): the same small tree of parameters, the same fixed sequence
of gradients, and the learning rate changed midway (rvdd_tpu through
``inject_hyperparams``, the port through ``param_group['lr']``).  13 steps,
so that RAdam rectifies (from step 6) and the lookahead of ``ranger``
syncs twice (steps 6 and 12).  Each step's parameters agree within 5e-6
absolute: float32 rounding of weights up to about 3 (2.4e-7 an ulp),
which optax rounds twice a step (``fast - params`` and back) and the port
once, over 13 steps.  At that learning rate RAdam's rectified steps are
too small to tell optax's float32 rho_t from a float64 one, so RAdam is
also held alone to optax.radam at a learning rate of 1."""

import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from rvdd_tpu.training.train_state import LookaheadState  # noqa: E402
from rvdd_tpu.training.train_state import make_optimizer as jmake_optimizer  # noqa: E402
from rvdd_tpu_torch.training.train_state import (  # noqa: E402
    OPTIMIZERS,
    RAdam,
    create_train_state,
    make_optimizer,
    set_learning_rate,
)

SHAPES = {"a": (3, 4), "b": (5,), "c": (2, 3, 3, 2)}
STEPS, SWITCH = 13, 7
LRS = (1e-2, 3e-3)
ATOL = 5e-6


def _params():
    rng = np.random.default_rng(0)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}


def _grads():
    rng = np.random.default_rng(1)
    return [{k: (rng.standard_normal(s) * 10.0 ** rng.uniform(-3, 0)).astype(np.float32)
             for k, s in SHAPES.items()} for _ in range(STEPS)]


def _optax_run(name, beta1, wd):
    tx = jmake_optimizer(name, beta1, wd)
    params = {k: jnp.asarray(v) for k, v in _params().items()}
    state = tx.init(params)
    out = []
    for i, g in enumerate(_grads()):
        hp = state.inner if isinstance(state, LookaheadState) else state
        hp.hyperparams["learning_rate"] = jnp.asarray(LRS[i >= SWITCH], jnp.float32)
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, updates)
        out.append({k: np.asarray(v) for k, v in params.items()})
    return out


def _torch_params():
    return [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in _params().values()]


def _torch_step(opt, params, g, lr):
    for group in opt.param_groups:
        group["lr"] = lr
    for p, k in zip(params, SHAPES):
        p.grad = torch.from_numpy(g[k].copy())
    opt.step()


@pytest.mark.parametrize("beta1,wd", [(0.9, 0.01), (0.5, 0.1)], ids=["default", "b0.5_wd0.1"])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_matches_optax(name, beta1, wd):
    want = _optax_run(name, beta1, wd)
    params = _torch_params()
    opt = make_optimizer(name, params, beta1, wd)
    for i, g in enumerate(_grads()):
        _torch_step(opt, params, g, LRS[i >= SWITCH])
        for p, k in zip(params, SHAPES):
            np.testing.assert_allclose(p.detach().numpy(), want[i][k], rtol=0, atol=ATOL,
                                       err_msg=f"{name} step {i + 1} leaf {k}")


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_state_dict_resumes_exactly(name):
    """Saved after 7 steps (torch.save of state_dict, as the checkpoints
    save it) and loaded into a new optimizer over copies of the weights,
    the next 6 steps are bit for bit those of an uninterrupted run; the
    lookahead's count and slow weights travel with it."""
    grads = _grads()
    params = _torch_params()
    opt = make_optimizer(name, params)
    for i, g in enumerate(grads):
        _torch_step(opt, params, g, LRS[i >= SWITCH])
        if i + 1 == SWITCH:
            buf = io.BytesIO()
            torch.save(opt.state_dict(), buf)
            copies = [torch.nn.Parameter(p.detach().clone()) for p in params]
    opt2 = make_optimizer(name, copies)
    buf.seek(0)
    opt2.load_state_dict(torch.load(buf, weights_only=True))
    for g in grads[SWITCH:]:
        _torch_step(opt2, copies, g, LRS[1])
    for p, q in zip(params, copies):
        assert torch.equal(p, q)


def test_radam_rectification_follows_optax_float32():
    """rho_t and the rectification factor in float32, as optax's
    scale_by_radam computes them (its first rectified step is 6, where
    float64 would give rho_6 = 5.994 instead of optax's 5.97)."""
    b2 = 0.999
    for t in range(1, 12):
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = b2 ** jnp.asarray(t, jnp.int32)
        ro = ro_inf - 2 * jnp.asarray(t, jnp.int32) * b2t / (1 - b2t)
        got_ro, got_r = RAdam.rectification(b2, t)
        assert got_ro == pytest.approx(float(ro), rel=1e-6), t
        if float(ro) >= 5.0:
            r = jnp.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
            assert got_r == pytest.approx(float(r), rel=1e-6), t
    assert RAdam.rectification(b2, 5)[0] < 5.0 <= RAdam.rectification(b2, 6)[0]


def test_radam_matches_optax_radam_at_unit_lr():
    """RAdam alone against optax.radam at lr = 1 over 9 steps (5
    unrectified, 4 rectified), within 2e-6 relative to the largest weight.
    A float64 rho_t (or torch.optim.RAdam) moves the rectified steps by
    about 1.2% (r_6 = 0.02582 against optax's 0.02552): 2e-4 here."""
    tx = optax.radam(1.0, b1=0.9, b2=0.999)
    jp = {k: jnp.asarray(v) for k, v in _params().items()}
    state = tx.init(jp)
    params = _torch_params()
    opt = RAdam(params, lr=1.0)
    scale = max(np.abs(v).max() for v in _params().values())
    for i, g in enumerate(_grads()[:9]):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        _torch_step(opt, params, g, 1.0)
        for p, k in zip(params, SHAPES):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=0,
                                       atol=2e-6 * scale, err_msg=f"step {i + 1} leaf {k}")


def test_create_train_state_and_learning_rate():
    net = torch.nn.Linear(3, 2)
    state = create_train_state(net, "ranger")
    assert state.step == 0
    set_learning_rate(state, 0.25)
    assert [g["lr"] for g in state.optimizer.param_groups] == [0.25]
    with pytest.raises(NotImplementedError):
        make_optimizer("lamb", net.parameters())
