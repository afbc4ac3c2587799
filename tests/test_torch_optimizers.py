"""The port's optimizers (``ai_toolkit_tpu_torch/train/optimizers.py``)
against the JAX package's ``get_optimizer`` (optax 0.2.6 and JAX
``train/automagic.py``): every name it takes, 5 clipped steps on a small
parameter dict (a 2-D tensor adafactor factors, one it does not, a vector and
a scalar) with seeded gradients, compiled as the JAX step compiles them.

f32: the parameters and every state tensor to rtol 1e-5 (atol 1e-5 of the
largest). bf16, where optax keeps the state in bf16: bit for bit for the
elementwise optimizers; where an update reduces over a tensor (a norm, an
RMS, a mean, an inner product) XLA's order of summation is not torch's, so
those are held to one bf16 step (2^-7) of the largest value."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ai_toolkit_tpu.train.optimizers import get_optimizer as jget_optimizer
from ai_toolkit_tpu_torch.train.optimizers import Automagic, get_optimizer

from test_torch_flux_family import OPT0
from torch_jax_opt import jax_opt0  # noqa: F401

SHAPES = {"a": (130, 129), "b": (8, 12), "bias": (8,), "scale": ()}
NAMES = sorted(SHAPES)
LR = 1e-3
# the optimizers whose bf16 update reduces over a tensor
REDUCING = {"adafactor", "prodigy", "dadapt_adamw", "muon"}
CASES = [("adam", {}), ("lion", {"weight_decay": 0.05}), ("lion8bit", {}), ("adagrad", {}), ("adafactor", {}),
         ("prodigy", {}), ("dadapt_adamw", {"weight_decay": 0.01}), ("ademamix", {}), ("muon", {}),
         ("sgd", {"momentum": 0.8}), ("automagic", {}), ("automagic", {"paramiter_swapping": 0.25}),
         ("automagic", {"packed_lr_mask": False, "lr_bump": 1e-5})]


def _data(dtype):
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32) * 0.5 for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) * (0.2 + 0.3 * i) for k, s in SHAPES.items()}
             for i in range(5)]
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    return params, grads, tdt, jdt


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if hasattr(x, "dtype") else np.asarray(x, np.float32)


def _leaves(state):
    """Every array in an optax state, by its path."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        if hasattr(leaf, "shape") and leaf.dtype != jnp.int32 and leaf.dtype != jnp.uint8:
            out[jax.tree_util.keystr(path)] = _np(leaf)
    return out


def run_both(case, dtype):
    name, opts = CASES[case]
    params, grads, tdt, jdt = _data(dtype)
    tx = jget_optimizer(name, LR, dict(opts), max_grad_norm=1.0)
    jp = {k: jnp.asarray(v, jdt) for k, v in params.items()}
    jstate = tx.init(jp)

    def update(p, s, g):
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s

    jupdate = jax.jit(update, compiler_options=OPT0)
    tp = [torch.tensor(params[k]).to(tdt) for k in NAMES]
    opt = get_optimizer(name, tp, LR, dict(opts), max_grad_norm=1.0)
    for g in grads:
        jp, jstate = jupdate(jp, jstate, {k: jnp.asarray(v, jdt) for k, v in g.items()})
        opt.step([torch.tensor(g[k]).to(tdt) for k in NAMES])
    return jp, jstate, tp, opt


def _held(ours, ref, what, exact, rtol=1e-5):
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    assert ours.shape == ref.shape, f"{what}: {ours.shape} != {ref.shape}"
    if exact:
        np.testing.assert_array_equal(ours, ref, err_msg=what)
    else:
        scale = max(float(np.abs(ref).max()), 1e-30)
        np.testing.assert_allclose(ours, ref, rtol=rtol, atol=rtol * scale, err_msg=what)


_SLOT_FIELDS = {"row": ("exp_avg_sq", "row"), "col": ("exp_avg_sq", "col"), "sq": ("exp_avg_sq", None),
                "adam_mu": ("mu", None), "adam_nu": ("nu", None), "polarity": ("last_polarity", None)}


def _state_pairs(name, jstate, opt):
    """(port tensor, JAX array, label) for each state tensor both keep: the
    JAX leaf ``.<field>['<param>']['<sub>']`` of each port slot."""
    leaves = {}
    for path, arr in _leaves(jstate).items():
        m = re.search(r"\.(\w+)(?:\['(\w+)'\])?(?:\['(\w+)'\])?$", path)
        leaves[m.groups()] = arr
    pairs = []
    for i, k in enumerate(NAMES):
        for slot, t in opt.slots[i].items():
            if slot in ("params0", "lr_q", "lr_scale"):
                continue
            field, sub = _SLOT_FIELDS.get(slot, (slot, None))
            pairs.append((t.float().numpy(), leaves[(field, k, sub)], f"{name} {slot}.{k}"))
    for key, t in opt.scalars.items():
        pairs.append((t.float().numpy(), leaves[(key, None, None)], f"{name} {key}"))
    return pairs


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", range(len(CASES)), ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_optimizer_matches_optax(case, dtype):
    name = CASES[case][0]
    jp, jstate, tp, opt = run_both(case, dtype)
    exact = dtype == "bf16" and name not in REDUCING
    rtol = 1e-5 if dtype == "f32" else 2.0 ** -7
    for i, k in enumerate(NAMES):
        _held(tp[i].float().numpy(), _np(jp[k]), f"{name} {dtype} param {k}", exact, rtol)
    if name == "adam" or (dtype == "bf16" and name in ("muon", "adafactor")):
        return  # adam is AdamW at weight decay 0 (its state: test_torch_full_finetune); bf16 states: the params
    automagic = isinstance(opt, Automagic)  # its state is f32 whatever the parameters' dtype
    for ours, ref, what in _state_pairs(name, jstate, opt):
        _held(ours, ref, f"{what} {dtype}", exact and not automagic, 1e-5 if automagic else rtol)
    if automagic:
        for i, k in enumerate(NAMES):
            ref = jstate[1].lr_mask[k]
            ref = _np(ref["q"]) * _np(ref["scale"]) if isinstance(ref, dict) else _np(ref)
            _held(opt.lr_mask(i).numpy(), ref, f"automagic lr mask {k} {dtype}", False)


def test_optimizer_params_jax_does_not_read_are_dropped_and_printed(capsys):
    """[port] JAX ``get_optimizer`` reads weight_decay, betas, eps and the
    automagic / sgd keys and drops the rest (ROADMAP Queue 3); the port
    trains the same and prints what it dropped."""
    p = [torch.zeros(4, 4)]
    opt = get_optimizer("adamw", p, 1e-3, {"weight_decay": 0.0, "decouple": True, "use_bias_correction": False})
    assert opt.weight_decay == 0.0
    assert "['decouple', 'use_bias_correction']" in capsys.readouterr().out


def test_jax_fault_get_optimizer_drops_unread_params():
    """[jax_fault] the JAX factory silently drops an optimizer_params key it
    does not read: adamw with ``decouple`` is adamw without it."""
    params = {"w": jnp.ones((4,))}
    g = {"w": jnp.full((4,), 0.5)}
    a = jget_optimizer("adamw", 1e-2, {"decouple": False, "amsgrad": True})
    b = jget_optimizer("adamw", 1e-2, {})
    ua, _ = a.update(g, a.init(params), params)
    ub, _ = b.update(g, b.init(params), params)
    np.testing.assert_array_equal(np.asarray(ua["w"]), np.asarray(ub["w"]))


def test_every_jax_name_builds_and_steps():
    """Every name the JAX factory accepts builds and steps in the port; an
    unknown one raises as in JAX."""
    names = ["adamw", "adamw_fused", "adam", "adamw8bit", "adam8bit", "adamw8", "adam8", "lion", "lion8bit",
             "adagrad", "adafactor", "prodigy", "prodigy8bit", "dadaptation", "dadapt_adam", "ademamix",
             "ademamix8bit", "muon", "automagic", "automagic8bit", "sgd"]
    for name in names:
        jget_optimizer(name, 1e-3)
        p = torch.ones(3, 2)
        opt = get_optimizer(name, [p], 1.0)
        opt.step([torch.full((3, 2), 0.1)])
        assert opt.count == 1 and not torch.equal(p, torch.ones(3, 2)), name
    with pytest.raises(ValueError, match="unknown optimizer"):
        get_optimizer("rmsprop", [torch.ones(2)], 1e-3)
