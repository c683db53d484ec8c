"""Optimizers. Counterpart: ``paddle_tpu/optimizer/optimizer.py``
(``Optimizer`` :27-167, ``Adam`` and ``AdamW`` :241-378).

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

Not ported yet (they raise): ``grad_clip`` objects, regularizer objects
as ``weight_decay``, learning-rate schedulers.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

__all__ = ["Optimizer", "Adam", "AdamW"]

_LOW = (torch.bfloat16, torch.float16)
_MOMENT_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                  "float16": torch.float16}


def _f32(x) -> float:
    """x rounded to float32, as JAX's float32 scalar arithmetic gives."""
    return float(np.float32(x))


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None,
                 multi_precision: bool = True):
        if parameters is None:
            raise ValueError("parameters must be provided: tensors, or "
                             "(name, tensor) pairs as named_parameters() "
                             "gives")
        if grad_clip is not None:
            raise NotImplementedError(
                "grad_clip is not ported yet (ROADMAP queue 1, item 10)")
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "learning-rate schedulers are not ported yet (ROADMAP "
                "queue 1, item 10)")
        if weight_decay is not None and \
                not isinstance(weight_decay, (int, float)):
            raise NotImplementedError(
                "regularizer objects as weight_decay are not ported yet "
                "(ROADMAP queue 1, item 10); pass a float")
        named = [it if isinstance(it, tuple) else ("", it)
                 for it in parameters]
        self._parameter_names = [n for n, _ in named]
        self._parameter_list = [p for _, p in named]
        self._learning_rate = float(learning_rate)
        self._weight_decay = 0.0 if weight_decay is None else \
            float(weight_decay)
        self._multi_precision = multi_precision
        self._state: Optional[Dict[str, Any]] = None
        self._step_count = 0

    def get_lr(self) -> float:
        return self._learning_rate

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
        self._update_impl(eff, grads, state, lr)
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
        for i, (p, g) in enumerate(zip(params, grads)):
            if g is None:
                continue
            m_s, v_s = state["m"][i], state["v"][i]
            wd = self._weight_decay if self._decay[i] else 0.0
            if not self._decoupled_wd and wd:
                g = g + wd * p.to(g.dtype)
            g32 = g.to(p.dtype)
            m = m_s.to(p.dtype) * b1 + g32 * (1 - b1)
            v = v_s.to(p.dtype) * b2 + g32.square() * (1 - b2)
            v_hat = v / bc2
            if self._amsgrad:
                vm = torch.maximum(state["vmax"][i].to(p.dtype), v_hat)
                state["vmax"][i].copy_(vm)
                denom = vm.sqrt() + eps
            else:
                denom = v_hat.sqrt() + eps
            upd = (m / bc1) / denom
            if self._decoupled_wd and wd:
                p.mul_(_f32(1.0 - _f32(lr32 * _f32(wd))))
            p.sub_(upd * lr32)
            m_s.copy_(m)
            v_s.copy_(v)
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
