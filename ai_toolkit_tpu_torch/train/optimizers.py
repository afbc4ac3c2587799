"""Optimizers (``ai_toolkit_tpu/train/optimizers.py`` and
``train/automagic.py`` in PyTorch): every name the JAX ``get_optimizer``
takes, behind optax's global-norm clipping. AdamW with blockwise-int8
moments (``adamw8bit``) and plain AdamW follow optax's chain order and
formulas:

    g <- g if |g| < max_norm else (g / |g|) * max_norm      (clip_by_global_norm)
    u <- m_hat / (sqrt(v_hat) + eps)                        (scale_by_adam[_8bit])
    u <- u + wd * p                                         (add_decayed_weights)
    p <- p - lr * u                                         (scale_by_learning_rate)

``torch.nn.utils.clip_grad_norm_`` is not used: it adds 1e-6 to the norm. The
JAX package leaves these elementwise updates to XLA fusion and has no Pallas
kernel for them; here they are plain torch on the parameters' device, updating
the parameters in place.

Low-precision parameters (the bf16 weights of a full fine-tune) follow JAX's
rules of arithmetic, which the tests pin bit for bit: every operation rounds
to its operands' dtype, and a Python scalar that meets an array of a narrower
float dtype is first rounded to that dtype (weak typing: ``0.999`` is ``1.0``
in bf16). So plain ``adamw`` keeps its moments in the parameter dtype and
computes in it, as ``optax.adamw`` does, while ``adamw8bit`` computes in f32
and rounds the parameter once (optax ``apply_updates`` adds in the promoted
dtype); the global norm of bf16 gradients is bf16 (per-tensor f32 sums,
rounded, then added in bf16), as ``optax.global_norm`` gives it. Where XLA
fuses a product into a sum in f32 (the 8-bit moments, the 8-bit update), so
does :func:`_fma`.

The others follow optax 0.2.6, the version the JAX package runs, one class
each with the same interface (``step``, ``state_dict``, ``load_state_dict``):
:class:`Adam`, :class:`Lion`, :class:`Adagrad`, :class:`Adafactor`,
:class:`Prodigy`, :class:`DAdaptAdamW`, :class:`AdEMAMix`, :class:`Muon`
(Newton-Schulz on the 2-D tensors, nesterov AdamW on the rest), :class:`SGD`
(momentum) and :class:`Automagic` (the per-element lr masks, packed to
uint8, and ``paramiter_swapping``'s rotating subset). The state lives in the
parameters' dtype where optax keeps it there, and every Python scalar meets
it as JAX's weak typing has it (:func:`weak`). The ``*8bit`` names other than
adamw8bit train in full precision, as in JAX.

The learning rate is a float or a schedule (:func:`lr_schedule`, JAX
``SDTrainProcess._lr_schedule`` over optax's schedules): a function of the
number of updates taken before this one that returns optax's f32 value.
This is the bf16 trap the tests pin: optax's schedule hands the update an
f32 array, which is not weak-typed, where a constant lr is a Python float,
which is; so under a schedule the lr is rounded to f32 first and only then
to the update's dtype.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

BLOCK = 256


def weak(x: float, dtype: torch.dtype) -> float:
    """The Python scalar ``x`` as JAX applies it to an array of ``dtype``:
    rounded to that dtype first."""
    return torch.tensor(x, dtype=dtype).item()


def _fma(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` in f32 with one rounding, as XLA contracts it on the CPU
    (the JAX reference): exact in f64, then rounded to f32."""
    return (a.double() * weak(b, torch.float32) + c.double()).float()


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax ``global_norm``):
    each tensor's squares summed in f32 and rounded to its dtype, the sums
    added in the promoted dtype."""
    return torch.sqrt(sum(torch.sum(torch.square(t).float()).to(t.dtype) for t in tensors))


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> list[torch.Tensor]:
    norm = global_norm(grads)
    keep = norm < weak(max_norm, norm.dtype)
    return [torch.where(keep, g, (g / norm.to(g.dtype)) * weak(max_norm, g.dtype)) for g in grads]


def quantize_blockwise(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (int8 flat ``[padded]``, f32 block scales ``[padded / BLOCK]``);
    scale = max|block| / 127, values rounded half to even (JAX ``_quantize_blockwise``).
    XLA computes the division by the constant as a product with its f32
    reciprocal, and so does this: the scales, and so the int8 values, agree
    bit for bit."""
    flat = x.reshape(-1).float()
    blocks = F.pad(flat, (0, -flat.numel() % BLOCK)).view(-1, BLOCK)
    scale = blocks.abs().amax(dim=1) * (1.0 / 127.0)
    safe = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(blocks / safe[:, None]), -127, 127).to(torch.int8)
    return q.view(-1), scale


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.view(-1, BLOCK).float() * scale[:, None]).view(-1)
    return flat[: torch.Size(shape).numel()].view(shape)


_F32_TINY = float(np.finfo(np.float32).tiny)


def _f32(x: float) -> float:
    """``x`` rounded to f32, with XLA's flush of f32 subnormals to zero."""
    x = float(np.float32(x))
    return 0.0 if abs(x) < _F32_TINY else x


def _fma32(a: float, b: float, c: float) -> float:
    """``a * b + c`` of f32 operands with one f32 rounding, as XLA contracts it."""
    return _f32(_f32(a) * _f32(b) + _f32(c))


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax ``linear_schedule`` as the jitted step computes it: the count
    divided as a product with the f32 reciprocal, both products contracted."""
    if steps <= 0:
        return lambda count: _f32(init)
    recip = _f32(_f32(1.0) / _f32(steps))
    return lambda count: _fma32(init - end, _fma32(-min(max(count, 0), steps), recip, 1.0), end)


def _cosine(init: float, steps: int, alpha: float = 0.0) -> Callable[[int], float]:
    """optax ``cosine_decay_schedule`` in f32, the division by ``steps`` a
    product with its f32 reciprocal as in the jitted step; the cosine is
    rounded from f64, where XLA's is not correctly rounded (within two f32
    ULPs of ``init`` of optax's value)."""
    recip = _f32(_f32(1.0) / _f32(steps))

    def schedule(count: int) -> float:
        x = _f32(_f32(_f32(math.pi) * _f32(min(count, steps))) * recip)
        decay = _f32(0.5 * _f32(1.0 + _f32(math.cos(x))))
        return _f32(_f32(init) * _f32(_f32(_f32(1.0 - alpha) * decay) + _f32(alpha)))
    return schedule


def lr_schedule(name: str | None, base: float, total: int, params: dict | None = None):
    """The lr of JAX ``SDTrainProcess._lr_schedule``: ``base`` itself for
    ``constant``, else a function of the update count giving optax's f32
    value: ``linear`` (to ``end_lr``), ``cosine`` (``alpha``),
    ``cosine_with_restarts`` (``num_cycles`` cosines of ``total //
    num_cycles`` steps), ``constant_with_warmup`` (``num_warmup_steps`` of a
    linear ramp from 0) and ``step`` (times ``gamma`` every ``step_size``)."""
    p = dict(params or {})
    name = (name or "constant").lower()
    if name == "constant":
        return base
    if name == "linear":
        return _linear(base, p.get("end_lr", 0.0), total)
    if name == "cosine":
        return _cosine(base, total, p.get("alpha", 0.0))
    if name == "cosine_with_restarts":
        n = p.get("num_cycles", 3)
        per = max(1, total // n)
        cos = _cosine(base, per)
        return lambda count: cos(count - min(count // per, n - 1) * per)
    if name == "constant_with_warmup":
        warm = p.get("num_warmup_steps", 100)
        ramp = _linear(0.0, base, warm)
        return lambda count: ramp(count) if count < warm else _f32(base)
    if name == "step":
        every, gamma = p.get("step_size", max(1, total // 3)), p.get("gamma", 0.1)
        return lambda count: _f32(_f32(base) * _f32(_f32(gamma) ** (count // every)))
    raise NotImplementedError(f"lr_scheduler '{name}' is not ported (ported: constant, linear, cosine, "
                              f"cosine_with_restarts, constant_with_warmup, step)")


class AdamW:
    """AdamW over a fixed list of parameters; ``eight_bit`` keeps both
    moments as blockwise int8 with f32 block scales, else they are kept in
    the parameters' dtype. ``lr``: a float or a schedule (:func:`lr_schedule`)."""

    def __init__(self, params: list[torch.Tensor], lr, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2, max_grad_norm: float | None = 1.0,
                 eight_bit: bool = False):
        self.params = list(params)
        self.lr = lr if callable(lr) else float(lr)
        self.eps, self.weight_decay = float(eps), float(weight_decay)
        self.b1, self.b2 = (float(b) for b in betas)
        self.max_grad_norm = max_grad_norm
        self.eight_bit = eight_bit
        self.count = 0
        if eight_bit:
            zeros = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
            self.mu = [quantize_blockwise(z) for z in zeros]
            self.nu = [quantize_blockwise(z) for z in zeros]
        else:
            self.mu = [torch.zeros_like(p) for p in self.params]
            self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> None:
        """Clip, update the moments, and update the parameters in place."""
        if self.max_grad_norm and self.max_grad_norm > 0:
            grads = clip_by_global_norm(grads, self.max_grad_norm)
        lr = self.lr(self.count) if callable(self.lr) else self.lr  # optax's schedule count: updates so far
        self.count += 1
        dev = self.params[0].device
        count = torch.tensor(self.count, dtype=torch.float32, device=dev)
        bc1 = 1.0 - torch.tensor(self.b1, dtype=torch.float32, device=dev) ** count
        bc2 = 1.0 - torch.tensor(self.b2, dtype=torch.float32, device=dev) ** count
        for i, (p, g) in enumerate(zip(self.params, grads)):
            decay = p * weak(self.weight_decay, p.dtype)  # optax add_decayed_weights, in p's dtype
            if self.eight_bit:  # scale_by_adam_8bit: f32 throughout
                g = g.float()
                mu = _fma(dequantize_blockwise(*self.mu[i], g.shape), self.b1, g * (1 - self.b1))
                nu = _fma(dequantize_blockwise(*self.nu[i], g.shape), self.b2, g * g * (1 - self.b2))
                self.mu[i], self.nu[i] = quantize_blockwise(mu), quantize_blockwise(nu)
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
                # apply_updates adds in f32 and rounds to p's dtype once
                p.copy_(_fma(u + decay, -lr, p.float()).to(p.dtype))
            else:  # optax scale_by_adam in the moments' (the parameter's) dtype
                dt = self.mu[i].dtype
                g = g.to(dt)
                mu = self.mu[i] = g * weak(1 - self.b1, dt) + self.mu[i] * weak(self.b1, dt)
                nu = self.nu[i] = g * g * weak(1 - self.b2, dt) + self.nu[i] * weak(self.b2, dt)
                u = (mu / bc1.to(dt)) / (torch.sqrt(nu / bc2.to(dt)) + weak(self.eps, dt))
                p.copy_(p + (u + decay) * weak(-lr, dt))


    def state_dict(self, names: list[str]) -> dict[str, torch.Tensor]:
        """The moments by parameter name (an 8-bit moment as its int8 values
        ``.q`` and block scales ``.scale``) and the update count."""
        out = {"count": torch.tensor(self.count, dtype=torch.int64)}
        for tag, moments in (("mu", self.mu), ("nu", self.nu)):
            for name, m in zip(names, moments):
                if self.eight_bit:
                    out[f"{tag}.{name}.q"], out[f"{tag}.{name}.scale"] = m
                else:
                    out[f"{tag}.{name}"] = m
        return out

    def load_state_dict(self, names: list[str], state: dict[str, torch.Tensor]) -> None:
        """Restore :meth:`state_dict`'s moments and count in place."""
        for tag, moments in (("mu", self.mu), ("nu", self.nu)):
            for i, name in enumerate(names):
                if self.eight_bit:
                    moments[i] = tuple(x.copy_(state[f"{tag}.{name}.{leaf}"])
                                       for x, leaf in zip(moments[i], ("q", "scale")))
                else:
                    moments[i].copy_(state[f"{tag}.{name}"])
        self.count = int(state["count"])




def _promote(*ts: torch.Tensor) -> torch.dtype:
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return dt


def _apply(p: torch.Tensor, u: torch.Tensor) -> None:
    """optax ``apply_updates``: ``p + u`` in the promoted dtype, rounded to p's."""
    dt = _promote(p, u)
    p.copy_((p.to(dt) + u.to(dt)).to(p.dtype))


def _lowest(params: list[torch.Tensor]) -> torch.dtype:
    """optax ``tree.dtype(params, 'lowest')``: the narrowest float dtype."""
    return min((p.dtype for p in params), key=lambda d: torch.finfo(d).bits)


def _bias_correction(decay: float, count: int, device) -> torch.Tensor:
    """``1 - decay ** count`` in f32 (optax ``tree.bias_correction``)."""
    return 1.0 - torch.tensor(decay, dtype=torch.float32, device=device) ** torch.tensor(
        float(count), dtype=torch.float32, device=device)


def _vdot(xs: list[torch.Tensor], ys: list[torch.Tensor]) -> torch.Tensor:
    """optax ``tree.vdot``: each pair's dot product accumulated in f32 and
    rounded to the pair's dtype, the dots added in order."""
    out = None
    for x, y in zip(xs, ys):
        v = (x.float() * y.float()).sum().to(_promote(x, y))
        out = v if out is None else out + v
    return out


def _tree_sum(xs: list[torch.Tensor]) -> torch.Tensor:
    out = None
    for x in xs:
        v = x.float().sum().to(x.dtype)
        out = v if out is None else out + v
    return out


class _Optimizer:
    """The shared frame: clip by global norm, the lr of this update (a float,
    or a schedule of the updates so far), the update count, and the state:
    per-parameter tensors (``self.slots[i][key]``) and scalars
    (``self.scalars[key]``), saved by name."""

    def __init__(self, params: list[torch.Tensor], lr, max_grad_norm: float | None):
        self.params = list(params)
        self.lr = lr if callable(lr) else float(lr)
        self.max_grad_norm = max_grad_norm
        self.count = 0
        self.slots: list[dict[str, torch.Tensor]] = [{} for _ in self.params]
        self.scalars: dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> None:
        if self.max_grad_norm and self.max_grad_norm > 0:
            grads = clip_by_global_norm(grads, self.max_grad_norm)
        lr = self.lr(self.count) if callable(self.lr) else self.lr
        self.count += 1
        self._update(list(grads), lr)

    def _update(self, grads: list[torch.Tensor], lr: float) -> None:
        raise NotImplementedError

    def state_dict(self, names: list[str]) -> dict[str, torch.Tensor]:
        out = {"count": torch.tensor(self.count, dtype=torch.int64)}
        out.update({f"{k}": v for k, v in self.scalars.items()})
        for name, slots in zip(names, self.slots):
            out.update({f"{k}.{name}": v for k, v in slots.items()})
        return out

    def load_state_dict(self, names: list[str], state: dict[str, torch.Tensor]) -> None:
        for k in self.scalars:
            self.scalars[k] = state[k].to(self.scalars[k].device).clone()
        for name, slots in zip(names, self.slots):
            for k in slots:
                slots[k].copy_(state[f"{k}.{name}"])
        self.count = int(state["count"])


class Lion(_Optimizer):
    """optax ``lion``: the sign of a b1 blend of the gradient and the
    moment, the moment a b2 average; decoupled weight decay. The JAX factory
    passes no betas: (0.9, 0.99)."""

    def __init__(self, params, lr, weight_decay: float = 1e-3, b1: float = 0.9, b2: float = 0.99,
                 max_grad_norm: float | None = 1.0):
        super().__init__(params, lr, max_grad_norm)
        self.b1, self.b2, self.wd = b1, b2, float(weight_decay)
        for p, s in zip(self.params, self.slots):
            s["mu"] = torch.zeros_like(p)

    def _update(self, grads, lr):
        for p, g, s in zip(self.params, grads, self.slots):
            dt = s["mu"].dtype
            u = torch.sign(g * weak(1.0 - self.b1, dt) + s["mu"] * weak(self.b1, dt))
            s["mu"] = g * weak(1.0 - self.b2, dt) + s["mu"] * weak(self.b2, dt)
            u = u + p * weak(self.wd, p.dtype)
            _apply(p, u * weak(-lr, u.dtype))


class Adagrad(_Optimizer):
    """optax ``adagrad``: the running sum of squares from 0.1, the update
    ``g / sqrt(sum + 1e-7)``."""

    def __init__(self, params, lr, initial_accumulator_value: float = 0.1, eps: float = 1e-7,
                 max_grad_norm: float | None = 1.0):
        super().__init__(params, lr, max_grad_norm)
        self.eps = eps
        for p, s in zip(self.params, self.slots):
            s["sum_of_squares"] = torch.full_like(p, weak(initial_accumulator_value, p.dtype))

    def _update(self, grads, lr):
        for p, g, s in zip(self.params, grads, self.slots):
            sos = s["sum_of_squares"] = g * g + s["sum_of_squares"]
            inv = torch.where(sos > 0, torch.rsqrt(sos + weak(self.eps, sos.dtype)), torch.zeros_like(sos))
            u = inv * g
            _apply(p, u * weak(-lr, u.dtype))


class SGD(_Optimizer):
    """optax ``sgd`` with ``momentum`` (a trace ``g + momentum * trace``)."""

    def __init__(self, params, lr, momentum: float | None = 0.9, max_grad_norm: float | None = 1.0):
        super().__init__(params, lr, max_grad_norm)
        self.momentum = momentum
        if momentum is not None:
            for p, s in zip(self.params, self.slots):
                s["trace"] = torch.zeros_like(p)

    def _update(self, grads, lr):
        for p, g, s in zip(self.params, grads, self.slots):
            if self.momentum is not None:
                g = s["trace"] = g + s["trace"] * weak(self.momentum, s["trace"].dtype)
            _apply(p, g * weak(-lr, g.dtype))


def _nesterov_adam(g, mu, nu, b1, b2, eps, count):
    """optax ``scale_by_adam(nesterov=True)``'s moments and direction in the
    moments' dtype (Muon's AdamW on the tensors that are not 2-D)."""
    dt = mu.dtype
    mu = g * weak(1.0 - b1, dt) + mu * weak(b1, dt)
    nu = g * g * weak(1.0 - b2, dt) + nu * weak(b2, dt)
    m_next = mu / _bias_correction(b1, count + 1, g.device).to(dt)
    g_hat = g / _bias_correction(b1, count, g.device).to(g.dtype)
    mu_hat = m_next * weak(b1, dt) + g_hat * weak(1.0 - b1, dt)
    nu_hat = nu / _bias_correction(b2, count, g.device).to(dt)
    return mu_hat / (torch.sqrt(nu_hat) + weak(eps, dt)), mu, nu


class AdEMAMix(_Optimizer):
    """optax ``contrib.ademamix``: a fast (b1) and a slow (b3) moment, the
    update ``(m1_hat + alpha m2) / (sqrt(nu_hat) + eps)``, decoupled weight
    decay. The JAX factory passes only the weight decay."""

    def __init__(self, params, lr, weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
                 b3: float = 0.9999, alpha: float = 5.0, eps: float = 1e-8, max_grad_norm: float | None = 1.0):
        super().__init__(params, lr, max_grad_norm)
        self.b1, self.b2, self.b3, self.alpha, self.eps, self.wd = b1, b2, b3, alpha, eps, float(weight_decay)
        for p, s in zip(self.params, self.slots):
            s.update(m1=torch.zeros_like(p), m2=torch.zeros_like(p), nu=torch.zeros_like(p))

    def _update(self, grads, lr):
        for p, g, s in zip(self.params, grads, self.slots):
            dt = s["m1"].dtype
            s["m1"] = g * weak(1.0 - self.b1, dt) + s["m1"] * weak(self.b1, dt)
            s["m2"] = g * weak(1.0 - self.b3, dt) + s["m2"] * weak(self.b3, dt)
            s["nu"] = g * g * weak(1.0 - self.b2, dt) + s["nu"] * weak(self.b2, dt)
            m1_hat = s["m1"] / _bias_correction(self.b1, self.count, g.device).to(dt)
            nu_hat = s["nu"] / _bias_correction(self.b2, self.count, g.device).to(dt)
            u = (m1_hat + s["m2"] * weak(self.alpha, dt)) / (torch.sqrt(nu_hat) + weak(self.eps, dt))
            u = u + p * weak(self.wd, p.dtype)
            _apply(p, u * weak(-lr, u.dtype))


def _factored_dims(shape, min_dim: int = 128) -> tuple[int, int] | None:
    """optax ``_factored_dims``: the second-largest and largest axes, when
    the second-largest has at least ``min_dim`` entries."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


def _rms_bf(x: torch.Tensor) -> torch.Tensor:
    """``sqrt(mean(x^2))`` with the mean accumulated in f32 and rounded to x's dtype."""
    return torch.sqrt((x * x).float().mean().to(x.dtype))


class Adafactor(_Optimizer):
    """optax ``adafactor`` at its defaults: the factored second moment (rows
    and columns of tensors whose second-largest axis has 128 entries or more,
    else full) with the decay ``1 - (k + 1)^-0.8``, the update clipped to a
    block RMS of 1, times the lr, times the parameter's RMS (at least 1e-3)."""

    def __init__(self, params, lr, decay_rate: float = 0.8, eps: float = 1e-30, clipping_threshold: float = 1.0,
                 min_scale: float = 1e-3, max_grad_norm: float | None = 1.0):
        super().__init__(params, lr, max_grad_norm)
        self.decay_rate, self.eps, self.clip, self.min_scale = decay_rate, eps, clipping_threshold, min_scale
        one = lambda p: torch.zeros((1,), dtype=p.dtype, device=p.device)  # noqa: E731
        for p, s in zip(self.params, self.slots):
            dims = _factored_dims(tuple(p.shape))
            if dims is None:
                s.update(v_row=one(p), v_col=one(p), v=torch.zeros_like(p))
            else:
                d1, d0 = dims
                shape = list(p.shape)
                s.update(v_row=torch.zeros([n for i, n in enumerate(shape) if i != d0], dtype=p.dtype,
                                           device=p.device),
                         v_col=torch.zeros([n for i, n in enumerate(shape) if i != d1], dtype=p.dtype,
                                           device=p.device),
                         v=one(p))

    def _update(self, grads, lr):
        t = torch.tensor(float(self.count), dtype=torch.float32, device=self.params[0].device)
        decay = 1.0 - t ** -self.decay_rate  # f32
        for p, g, s in zip(self.params, grads, self.slots):
            dt = p.dtype
            dims = _factored_dims(tuple(p.shape))
            g_sq = g * g + weak(self.eps, g.dtype)
            # the f32 decay promotes the blend to f32 (a 0-d f32 tensor would not promote a bf16 one in torch)
            if dims is None:
                s["v"] = (decay * s["v"].float() + (1.0 - decay) * g_sq.float()).to(dt)
                u = g * s["v"] ** weak(-0.5, dt)
            else:
                d1, d0 = dims
                mean_d0 = g_sq.float().mean(d0).to(g_sq.dtype).float()
                mean_d1 = g_sq.float().mean(d1).to(g_sq.dtype).float()
                s["v_row"] = (decay * s["v_row"].float() + (1.0 - decay) * mean_d0).to(dt)
                s["v_col"] = (decay * s["v_col"].float() + (1.0 - decay) * mean_d1).to(dt)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_col_mean = s["v_row"].float().mean(reduced_d1, keepdim=True).to(dt)
                row_factor = (s["v_row"] / row_col_mean) ** weak(-0.5, dt)
                col_factor = s["v_col"] ** weak(-0.5, dt)
                u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            u = u / torch.clamp(_rms_bf(u) / weak(self.clip, u.dtype), min=1.0)
            u = u * weak(lr, u.dtype)
            rms = _rms_bf(p)
            scale = torch.where(rms <= weak(self.min_scale, dt), torch.tensor(weak(self.min_scale, dt), dtype=dt,
                                                                             device=p.device), rms)
            u = u * scale
            _apply(p, u * weak(-1.0, u.dtype))


class Prodigy(_Optimizer):
    """optax ``contrib.prodigy`` (Mishchenko & Defazio): Adam moments of the
    gradient scaled by the distance estimate ``estim_lr``, which grows with
    the weighted inner product of the gradients and the distance travelled
    from the initial parameters; decoupled weight decay. The JAX factory
    passes the lr (a multiplier of the estimate) and the weight decay."""

    def __init__(self, params, lr, weight_decay: float = 0.0, betas=(0.9, 0.999), eps: float = 1e-8,
                 estim_lr0: float = 1e-6, estim_lr_coef: float = 1.0, max_grad_norm: float | None = 1.0):
        super().__init__(params, lr, max_grad_norm)
        self.b1, self.b2 = betas
        self.b3 = self.b2 ** 0.5
        self.eps, self.estim_lr0, self.coef, self.wd = eps, estim_lr0, estim_lr_coef, float(weight_decay)
        low = _lowest(self.params)
        dev = self.params[0].device
        for p, s in zip(self.params, self.slots):
            s.update(exp_avg=torch.zeros_like(p), exp_avg_sq=torch.zeros_like(p), grad_sum=torch.zeros_like(p),
                     params0=p.detach().clone())
        self.scalars = {"estim_lr": torch.tensor(estim_lr0, dtype=low, device=dev),
                        "numerator_weighted": torch.zeros((), dtype=low, device=dev)}

    def _update(self, grads, lr):
        est, nw = self.scalars["estim_lr"], self.scalars["numerator_weighted"]
        dev = est.device
        bc = _bias_correction(self.b2, self.count, dev) ** 0.5 / _bias_correction(self.b1, self.count, dev)
        dlr = ((est * weak(lr, est.dtype)) * bc).to(est.dtype)
        dgs = [est * g for g in grads]
        num = _vdot(grads, [s["params0"] - p for p, s in zip(self.params, self.slots)])
        for dg, s in zip(dgs, self.slots):
            dt = s["exp_avg"].dtype
            s["exp_avg"] = s["exp_avg"] * weak(self.b1, dt) + dg * weak(1.0 - self.b1, dg.dtype)
            s["exp_avg_sq"] = s["exp_avg_sq"] * weak(self.b2, dt) + dg * weak(1.0 - self.b2, dg.dtype) * dg
            s["grad_sum"] = s["grad_sum"] * weak(self.b3, dt) + dlr * dg / weak(self.estim_lr0, _promote(dlr, dg))
        nw = nw * weak(self.b3, nw.dtype)
        nw = nw + (est / weak(self.estim_lr0, est.dtype)) * dlr * num
        den = _tree_sum([s["grad_sum"].abs() for s in self.slots])
        est = torch.maximum(est, (nw * weak(self.coef, nw.dtype)) / den)
        for p, s in zip(self.params, self.slots):
            ea, eas = s["exp_avg"], s["exp_avg_sq"]
            decay = dlr * weak(-self.wd, dlr.dtype) * p
            step = dlr * ea / (torch.sqrt(eas) + est * weak(self.eps, est.dtype))
            _apply(p, decay - step)
        self.scalars.update(estim_lr=est, numerator_weighted=nw)


class DAdaptAdamW(_Optimizer):
    """optax ``contrib.dadapt_adamw`` (Defazio & Mishchenko): AdamW whose step
    is the D-adaptation estimate of the distance to the solution; the JAX
    factory passes the lr (a multiplier of the estimate) and the weight decay."""

    def __init__(self, params, lr, weight_decay: float = 0.0, betas=(0.9, 0.999), eps: float = 1e-8,
                 estim_lr0: float = 1e-6, max_grad_norm: float | None = 1.0):
        super().__init__(params, lr, max_grad_norm)
        self.b1, self.b2 = betas
        self.sb2 = self.b2 ** 0.5
        self.eps, self.wd = eps, float(weight_decay)
        low = _lowest(self.params)
        dev = self.params[0].device
        for p, s in zip(self.params, self.slots):
            s.update(exp_avg=torch.zeros_like(p), exp_avg_sq=torch.zeros_like(p), grad_sum=torch.zeros_like(p))
        self.scalars = {"estim_lr": torch.tensor(estim_lr0, dtype=low, device=dev),
                        "numerator_weighted": torch.zeros((), dtype=low, device=dev)}

    def _update(self, grads, lr):
        est, nw = self.scalars["estim_lr"], self.scalars["numerator_weighted"]
        dev, sb2 = est.device, self.sb2
        bc = _bias_correction(self.b2, self.count, dev) ** 0.5 / _bias_correction(self.b1, self.count, dev)
        dlr = ((est * weak(lr, est.dtype)) * bc).to(nw.dtype)
        s_weighted = [s["grad_sum"] / (torch.sqrt(s["exp_avg_sq"]) + weak(self.eps, s["exp_avg_sq"].dtype))
                      for s in self.slots]
        num = _vdot(grads, s_weighted)
        for g, s in zip(grads, self.slots):
            dt = s["exp_avg"].dtype
            s["exp_avg"] = s["exp_avg"] * weak(self.b1, dt) + dlr * weak(1.0 - self.b1, dlr.dtype) * g
            s["exp_avg_sq"] = s["exp_avg_sq"] * weak(self.b2, dt) + g * weak(1.0 - self.b2, g.dtype) * g
            s["grad_sum"] = s["grad_sum"] * weak(sb2, dt) + dlr * weak(1.0 - sb2, dlr.dtype) * g
        l1 = _tree_sum([s["grad_sum"].abs() for s in self.slots])
        nw = nw * weak(sb2, nw.dtype) + dlr * weak(1.0 - sb2, dlr.dtype) * num
        est = torch.maximum(est, nw / (l1 * weak(1.0 - sb2, l1.dtype)))
        for p, s in zip(self.params, self.slots):
            ea, eas = s["exp_avg"], s["exp_avg_sq"]
            _apply(p, dlr * weak(-self.wd, dlr.dtype) * p - ea / (torch.sqrt(eas) + weak(self.eps, eas.dtype)))
        self.scalars.update(estim_lr=est, numerator_weighted=nw)


_NS_COEFFS = (3.4445, -4.7750, 2.0315)


def newton_schulz(x: torch.Tensor, steps: int = 5, eps: float = 1e-8) -> torch.Tensor:
    """optax ``orthogonalize_via_newton_schulz`` of a 2-D tensor, in its dtype."""
    transposed = x.shape[0] > x.shape[1]
    if transposed:
        x = x.T
    x = x / (torch.linalg.vector_norm(x.float()).to(x.dtype) + weak(eps, x.dtype))
    a_, b_, c_ = (weak(c, x.dtype) for c in _NS_COEFFS)
    for _ in range(steps):
        a = x @ x.T
        b = a * b_ + (a @ a) * c_
        x = x * a_ + b @ x
    return x.T if transposed else x


class Muon(_Optimizer):
    """optax ``contrib.muon`` at its defaults: on 2-D tensors a nesterov
    momentum (0.95) orthogonalised by five Newton-Schulz steps and scaled by
    ``sqrt(max(1, fan_out / fan_in))``; on the rest nesterov AdamW without
    weight decay."""

    def __init__(self, params, lr, beta: float = 0.95, eps: float = 1e-8, max_grad_norm: float | None = 1.0):
        super().__init__(params, lr, max_grad_norm)
        self.beta, self.eps = beta, eps
        for p, s in zip(self.params, self.slots):
            if p.dim() == 2:
                s["mu"] = torch.zeros_like(p)
            else:
                s.update(adam_mu=torch.zeros_like(p), adam_nu=torch.zeros_like(p))

    def _update(self, grads, lr):
        beta, k = self.beta, self.count
        for p, g, s in zip(self.params, grads, self.slots):
            if p.dim() != 2:
                u, s["adam_mu"], s["adam_nu"] = _nesterov_adam(g, s["adam_mu"], s["adam_nu"], 0.9, 0.999, self.eps, k)
                u = u + p * weak(0.0, p.dtype)
                _apply(p, u * weak(-lr, u.dtype))
                continue
            dt = s["mu"].dtype
            s["mu"] = g * weak(1.0 - beta, dt) + s["mu"] * weak(beta, dt)
            m_next = s["mu"] / _bias_correction(beta, k + 1, g.device).to(dt)
            g_hat = g / _bias_correction(beta, k, g.device).to(g.dtype)
            mu_hat = m_next * weak(beta, dt) + g_hat * weak(1.0 - beta, dt)
            u = newton_schulz(mu_hat, 5, self.eps)
            u = u * weak(math.sqrt(max(1.0, p.shape[1] / p.shape[0])), u.dtype)
            u = u + p * weak(0.0, p.dtype)
            _apply(p, u * weak(-lr, u.dtype))


def _pack_lr(lr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The lr mask as uint8 with a per-row absmax scale over the last axis
    (a 0-d mask: q = 255 and its value / 255), JAX ``automagic._pack_lr``."""
    if lr.dim() == 0:
        scale = torch.clamp(lr * (1.0 / 255.0), min=1e-12)
    else:
        scale = torch.clamp(lr.amax(dim=-1, keepdim=True) * (1.0 / 255.0), min=1e-12)
    q = torch.clamp(torch.round(lr / scale), 0, 255).to(torch.uint8)
    return q, scale.float()


class Automagic(_Optimizer):
    """JAX ``train/automagic.automagic``: an adafactor-style factored second
    moment (rows and columns of every tensor of rank 2 or more) with RMS
    update clipping, times a per-element lr mask that grows by ``lr_bump``
    where the update's sign agrees with the last step's and shrinks where it
    flips, clamped to ``[min_lr, max_lr]``; the mask packed to uint8 with a
    per-row scale (``packed_lr_mask``). With ``paramiter_swapping`` f, only
    one in ``round(1 / f)`` elements (a rotating subset by flat index)
    updates a step. f32 throughout; the update rounds once onto the parameter."""

    def __init__(self, params, lr, lr_bump: float = 3e-6, min_lr: float = 1e-7, max_lr: float = 1e-3,
                 beta2: float = 0.999, eps: float = 1e-30, clip_threshold: float = 1.0,
                 packed_lr_mask: bool = True, paramiter_swapping: float = 0.0, max_grad_norm: float | None = 1.0):
        # JAX starts the mask at a float lr, else (a schedule) at 1e-5
        super().__init__(params, 0.0, max_grad_norm)
        start = lr if isinstance(lr, float) else 1e-5
        self.lr_bump, self.min_lr, self.max_lr = lr_bump, min_lr, max_lr
        self.beta2, self.eps, self.clip, self.packed = beta2, eps, clip_threshold, packed_lr_mask
        self.n_groups = max(1, round(1.0 / paramiter_swapping)) if paramiter_swapping else 1
        for p, s in zip(self.params, self.slots):
            if p.dim() >= 2:
                s.update(row=torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                         col=torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32, device=p.device))
            else:
                s["sq"] = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            s["polarity"] = torch.zeros(p.shape, dtype=torch.bool, device=p.device)
            full = torch.full(p.shape, start, dtype=torch.float32, device=p.device)
            if packed_lr_mask:
                s["lr_q"], s["lr_scale"] = _pack_lr(full)
            else:
                s["lr_mask"] = full

    def lr_mask(self, i: int) -> torch.Tensor:
        s = self.slots[i]
        return s["lr_q"].float() * s["lr_scale"] if self.packed else s["lr_mask"]

    def _update(self, grads, lr):
        count = self.count - 1  # the updates before this one
        for i, (p, g, s) in enumerate(zip(self.params, grads, self.slots)):
            g = g.float()
            u2 = g * g + self.eps
            if g.dim() >= 2:
                s["row"] = s["row"] * self.beta2 + u2.mean(-1) * (1 - self.beta2)
                s["col"] = s["col"] * self.beta2 + u2.mean(-2) * (1 - self.beta2)
                r = torch.rsqrt(s["row"] / s["row"].mean(-1, keepdim=True) + 1e-30)
                c = torch.rsqrt(s["col"] + 1e-30)
                update = g * r[..., None] * c[..., None, :]
            else:
                s["sq"] = s["sq"] * self.beta2 + u2 * (1 - self.beta2)
                update = g * torch.rsqrt(s["sq"] + 1e-30)
            rms = torch.sqrt((update * update).mean() + 1e-30)
            update = update / torch.clamp(rms / self.clip, min=1.0)
            lr_now = self.lr_mask(i)
            pol = update > 0
            new_lr = torch.clamp(torch.where(pol == s["polarity"], lr_now + self.lr_bump, lr_now - self.lr_bump),
                                 self.min_lr, self.max_lr)
            step = update * new_lr
            if self.n_groups > 1:
                idx = torch.arange(step.numel(), dtype=torch.int32, device=p.device).reshape(step.shape)
                active = (idx % self.n_groups) == (count % self.n_groups)
                step = torch.where(active, step, torch.zeros_like(step))
                pol = torch.where(active, pol, s["polarity"])
                new_lr = torch.where(active, new_lr, lr_now)
            s["polarity"] = pol
            if self.packed:
                s["lr_q"], s["lr_scale"] = _pack_lr(new_lr)
            else:
                s["lr_mask"] = new_lr
            _apply(p, -step)


# the optimizer_params keys the JAX factory reads, per optimizer
_COMMON_KEYS = ("weight_decay", "betas", "eps")
_AUTOMAGIC_KEYS = ("lr_bump", "min_lr", "max_lr", "packed_lr_mask", "paramiter_swapping")


def get_optimizer(name: str, params: list[torch.Tensor], lr,
                  optimizer_params: dict | None = None,
                  max_grad_norm: float | None = 1.0):
    """JAX ``get_optimizer``: the optimizer of ``name`` over ``params``
    (``lr`` a float or a schedule), behind clipping at ``max_grad_norm``.
    JAX reads ``weight_decay``, ``betas`` and ``eps`` from
    ``optimizer_params`` (each optimizer takes what its optax alias takes:
    lion, prodigy, dadapt and ademamix only the weight decay), automagic's
    and sgd's own keys, and drops any other key; the port drops them too and
    prints them."""
    name = (name or "adamw").lower()
    p = dict(optimizer_params or {})
    wd = p.pop("weight_decay", 1e-2)
    betas = tuple(p.pop("betas", (0.9, 0.999)))
    eps = p.pop("eps", 1e-8)
    kw = dict(max_grad_norm=max_grad_norm)
    if name in ("adamw", "adamw_fused"):
        opt = AdamW(params, lr, betas=betas, eps=eps, weight_decay=wd, **kw)
    elif name == "adam":
        opt = AdamW(params, lr, betas=betas, eps=eps, weight_decay=0.0, **kw)
    elif name in ("adamw8bit", "adam8bit", "adamw8", "adam8"):  # all adamw8bit in JAX too
        opt = AdamW(params, lr, betas=betas, eps=eps, weight_decay=wd, eight_bit=True, **kw)
    elif name in ("lion", "lion8bit"):
        opt = Lion(params, lr, weight_decay=wd, **kw)
    elif name == "adagrad":
        opt = Adagrad(params, lr, **kw)
    elif name == "adafactor":
        opt = Adafactor(params, lr, **kw)
    elif name in ("prodigy", "prodigy8bit"):
        opt = Prodigy(params, lr, weight_decay=wd, **kw)
    elif name.startswith("dadapt"):
        opt = DAdaptAdamW(params, lr, weight_decay=wd, **kw)
    elif name in ("ademamix", "ademamix8bit"):
        opt = AdEMAMix(params, lr, weight_decay=wd, **kw)
    elif name == "muon":
        opt = Muon(params, lr, **kw)
    elif name.startswith("automagic"):
        opt = Automagic(params, lr, lr_bump=p.pop("lr_bump", 3e-6), min_lr=p.pop("min_lr", 1e-7),
                        max_lr=p.pop("max_lr", 1e-3), packed_lr_mask=bool(p.pop("packed_lr_mask", True)),
                        paramiter_swapping=float(p.pop("paramiter_swapping", 0.0)), **kw)
    elif name == "sgd":
        opt = SGD(params, lr, momentum=p.pop("momentum", 0.9), **kw)
    else:
        raise ValueError(f"unknown optimizer '{name}'")
    if p:
        print(f"JAX fault mirrored: optimizer_params {sorted(p)} are not read by the JAX get_optimizer for "
              f"'{name}' and are dropped (ROADMAP Queue 3)")
    return opt
