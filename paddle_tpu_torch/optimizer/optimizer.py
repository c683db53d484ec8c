"""Optimizers. Counterpart: ``paddle_tpu/optimizer/optimizer.py``
(``Optimizer`` :27-167, ``SGD`` and ``Momentum`` :181-238, ``Adam`` and
``AdamW`` :241-378).

Every optimizer is defined by a functional core over tensors,
``init_state(params) -> state`` and ``update(params, grads, state, lr)
-> (params, state)``, which the eager ``step()`` wraps over ``p.grad``
and ``jit.TrainStep`` calls after the backward. Unlike JAX's pure core,
the port's ``update`` works in place: it writes the new values into the
parameter and state tensors it is given (and returns them), which keeps
one copy of each in device memory. The arithmetic is JAX's, in the same
order, in float32.

``multi_precision`` (the default) keeps float32 master copies of
bfloat16/float16 parameters in ``state["master"]``: the rule runs on the
master and the parameter receives its rounding. ``torch.optim`` is not
used: its handling of low-precision parameters differs.

``grad_clip`` (``optimizer.clip``, or the MoE clip of
``incubate.distributed.models.moe``) clips the gradient list in
``update``, before the rule, as JAX's ``_apply_clip_and_decay`` does, so
the eager ``step()`` and ``jit.TrainStep`` both clip; each clipped
gradient is made when the rule reaches it. ``learning_rate`` may be an
``optimizer.lr`` scheduler, read at every step (the caller steps it).
JAX's ``AdamW`` with a mixed ``apply_decay_param_fun`` runs its rule, and
so a global-norm clip, one parameter at a time; the port clips the whole
list once, as Paddle does.

A tensor-parallel model's ``parameters()`` are logical views
(``distributed/fleet/mpu.py``); the optimizer steps their shards in
place, each under its logical parameter's name (``expand_shards``):
the rules are elementwise, so a shard's update is the logical update's
slice, a global norm sums over every shard, and ``ClipGradByNorm``
norms each logical parameter over its shards.

Not ported yet (it raises): regularizer objects as ``weight_decay``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..nn.functional.activation import _const
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW",
           "expand_shards"]

_LOW = (torch.bfloat16, torch.float16)
_MOMENT_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                  "float16": torch.float16}


def _f32(x) -> float:
    """x rounded to float32, as JAX's float32 scalar arithmetic gives."""
    return float(np.float32(x))


def _wd_grad(p, g, wd):
    """Weight decay coupled into the gradient, ``g + wd * p`` in g's
    dtype (JAX's ``_wd_grad`` :169)."""
    if not wd:
        return g
    return g + p.to(g.dtype) * _const(wd, g.dtype)


def expand_shards(named):
    """(k, name, tensor) for each (name, tensor) pair (or bare tensor,
    named ""), k its index: a logical view of a tp model's parameter
    gives its shards, each under its name. A generator, so that a
    model's views (full copies) are dropped as they are read."""
    for k, it in enumerate(named):
        n, p = it if isinstance(it, tuple) else ("", it)
        for s in getattr(p, "_mp_shards", (p,)):
            yield k, n, s


class _Clipped:
    """The gradient list as a clip gives it, each gradient clipped when
    it is read by index (None stays None)."""

    def __init__(self, grads, one):
        self._grads, self._one = grads, one

    def __getitem__(self, i):
        g = self._grads[i]
        return None if g is None else self._one(g, i)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None,
                 multi_precision: bool = True):
        if parameters is None:
            raise ValueError("parameters must be provided: tensors, or "
                             "(name, tensor) pairs as named_parameters() "
                             "gives")
        if weight_decay is not None and \
                not isinstance(weight_decay, (int, float)):
            raise NotImplementedError(
                "regularizer objects (L1Decay / L2Decay) as weight_decay "
                "are not ported yet (ROADMAP queue 1, item 10); pass a "
                "float")
        # a shard's group is its logical parameter's index
        self._groups, self._parameter_names, self._parameter_list = \
            [], [], []
        for k, n, p in expand_shards(parameters):
            self._groups.append(k)
            self._parameter_names.append(n)
            self._parameter_list.append(p)
        self._learning_rate = learning_rate \
            if isinstance(learning_rate, LRScheduler) else float(learning_rate)
        self._grad_clip = grad_clip
        self._weight_decay = 0.0 if weight_decay is None else \
            float(weight_decay)
        self._multi_precision = multi_precision
        self._state: Optional[Dict[str, Any]] = None
        self._step_count = 0

    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return self._learning_rate

    def set_lr(self, value: float):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("set_lr not allowed with an LRScheduler")
        self._learning_rate = float(value)

    # -- functional core ------------------------------------------------------
    def _needs_master(self, p) -> bool:
        return self._multi_precision and p.dtype in _LOW

    def _master_dtype(self, p):
        return torch.float32 if self._needs_master(p) else p.dtype

    def init_state(self, params: List[torch.Tensor]) -> Dict[str, Any]:
        st = self._init_state_impl(params)
        if any(self._needs_master(p) for p in params):
            st["master"] = [p.detach().float() if self._needs_master(p)
                            else None for p in params]
        return st

    def _init_state_impl(self, params) -> Dict[str, Any]:
        return {"step": 0}

    @torch.no_grad()
    def update(self, params, grads, state, lr):
        """One step of the rule, in place: masters (where kept) take the
        float32 update and the parameter their rounding. Returns
        (params, state); a parameter whose grad is None is untouched."""
        masters = state.get("master")
        eff = params if masters is None else \
            [m if m is not None else p for p, m in zip(params, masters)]
        clipped = grads if self._grad_clip is None else \
            _Clipped(grads, self._grad_clip._plan(grads, self._groups))
        self._update_impl(eff, clipped, state, lr)
        if masters is not None:
            for p, m, g in zip(params, masters, grads):
                if m is not None and g is not None:
                    p.copy_(m)
        return params, state

    def _update_impl(self, params, grads, state, lr):
        raise NotImplementedError

    # -- eager API ----------------------------------------------------------
    def step(self):
        params = self._parameter_list
        grads = [p.grad for p in params]
        if self._state is None:
            self._state = self.init_state(params)
        self.update(params, grads, self._state, self.get_lr())
        self._step_count += 1

    def clear_grad(self):
        for p in self._parameter_list:
            p.grad = None


class SGD(Optimizer):
    """``m = m - lr * g`` in the master's dtype, after the clip and the
    coupled weight decay."""

    def _update_impl(self, params, grads, state, lr):
        for i, p in enumerate(params):
            g = grads[i]
            if g is None:
                continue
            g = _wd_grad(p, g, self._weight_decay)
            p.sub_(g.to(p.dtype) * _const(_f32(lr), p.dtype))
            del g
        state["step"] += 1


class Momentum(Optimizer):
    """Heavy ball: ``v = mu * v + g``; the update is ``g + mu * v`` with
    ``use_nesterov``, else ``v``; ``m = m - lr * update``. The velocity
    is kept in the master's dtype; the arithmetic is in that dtype, in
    JAX's order, with ``mu`` and ``lr`` rounded to it."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_state_impl(self, params):
        return {"step": 0,
                "velocity": [torch.zeros(p.shape, device=p.device,
                                         dtype=self._master_dtype(p))
                             for p in params]}

    def _update_impl(self, params, grads, state, lr):
        for i, p in enumerate(params):
            g = grads[i]
            if g is None:
                continue
            mu = _const(self._momentum, p.dtype)
            g = _wd_grad(p, g, self._weight_decay).to(p.dtype)
            v = state["velocity"][i]
            v.mul_(mu).add_(g)
            upd = v.mul(mu).add_(g) if self._nesterov else v
            del g
            p.sub_(upd * _const(_f32(lr), p.dtype))
            del upd
        state["step"] += 1


class Adam(Optimizer):
    _decoupled_wd = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=True, amsgrad=False,
                 moment_dtype=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._amsgrad = amsgrad
        # storage dtype of m/v (None: the master's); the arithmetic stays
        # float32, only the STORED moments are rounded
        self._moment_dtype = None if moment_dtype is None else \
            _MOMENT_DTYPES[moment_dtype]
        self._decay = [True] * len(self._parameter_list)

    def _moment_zeros(self, p):
        return torch.zeros(p.shape, device=p.device,
                           dtype=self._moment_dtype or self._master_dtype(p))

    def _init_state_impl(self, params):
        st = {"step": 0,
              "m": [self._moment_zeros(p) for p in params],
              "v": [self._moment_zeros(p) for p in params]}
        if self._amsgrad:
            st["vmax"] = [self._moment_zeros(p) for p in params]
        return st

    def _update_impl(self, params, grads, state, lr):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        t = state["step"] + 1
        # float32 scalars, as JAX computes them from its int32 step
        bc1 = _f32(np.float32(1.0) - np.power(np.float32(b1), np.float32(t)))
        bc2 = _f32(np.float32(1.0) - np.power(np.float32(b2), np.float32(t)))
        lr32 = _f32(lr)
        # by index: a zip would keep the last (clipped) gradient alive in
        # the tuple it reuses
        for i, p in enumerate(params):
            g = grads[i]
            if g is None:
                continue
            m_s, v_s = state["m"][i], state["v"][i]
            wd = self._weight_decay if self._decay[i] else 0.0
            if not self._decoupled_wd and wd:
                g = g + wd * p.to(g.dtype)
            g32 = g.to(p.dtype)
            # in place wherever a result is not read again (moments kept
            # in the master's dtype are updated where they lie): the same
            # float32 operations in the same order, with at most two
            # temporaries of the parameter's size alive at a time, a
            # clipped gradient included
            m = m_s.to(p.dtype).mul_(b1).add_(g32 * (1 - b1))
            v = v_s.to(p.dtype).mul_(b2).add_(g32.square().mul_(1 - b2))
            # a clipped gradient is a temporary: free it before the next
            del g, g32
            v_hat = v / bc2
            if self._amsgrad:
                vm = torch.maximum(state["vmax"][i].to(p.dtype), v_hat)
                state["vmax"][i].copy_(vm)
                denom = vm.sqrt_().add_(eps)
                del vm
            else:
                denom = v_hat.sqrt_().add_(eps)
            upd = m.div(bc1).div_(denom)
            del v_hat, denom
            if self._decoupled_wd and wd:
                p.mul_(_f32(1.0 - _f32(lr32 * _f32(wd))))
            p.sub_(upd.mul_(lr32))
            if m is not m_s:
                m_s.copy_(m)
            if v is not v_s:
                v_s.copy_(v)
            del m, v, upd
        state["step"] = t


class AdamW(Adam):
    """Decoupled weight decay. ``apply_decay_param_fun(name) -> bool``
    picks the parameters that decay by name: the names of (name, tensor)
    pairs in ``parameters``, "" for a bare tensor (as an unnamed JAX
    Parameter has)."""
    _decoupled_wd = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=True, amsgrad=False, moment_dtype=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, multi_precision, amsgrad,
                         moment_dtype)
        if apply_decay_param_fun is not None:
            self._decay = [bool(apply_decay_param_fun(n))
                           for n in self._parameter_names]
