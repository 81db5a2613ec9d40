"""Optimizer construction: schedules, clipping and the optimizer cores.

Counterpart of ``tensorflowonspark_tpu/optim.py``, which builds optax
transforms. The port carries optax's algorithms over term for term
(``torch.optim``'s AdamW, Adafactor and SGD are other update rules): a
:class:`GradientTransformation` is an ``(init, update)`` pair over flat
``{name: tensor}`` dicts, composed with :func:`chain` and applied by
:func:`apply_updates`.

Where optax returns new arrays, the port updates in place: the optimizer
state's tensors, and the incoming gradient dict, which an ``update``
consumes (its tensors may come back as the updates). A caller that still
needs its gradients passes copies. Learning-rate schedules are evaluated
on the host from the step count, which starts at 0 on the first update as
in optax.

Over a mesh whose weights are cut into blocks (``parallel.sharding``),
each rank's transformation sees its blocks, and the reductions over a
whole parameter must span the mesh: the global-norm clip's norm,
Adafactor's factored row and column means (and the rule that picks the
factored dims, which reads the global shape) and the block rms of its
clip and scale. The train state runs ``update`` (and ``init``) inside
:func:`param_layout`, which names each parameter's global shape and mesh
spec; the reductions then sum their partial sums over the axes that cut
the dimensions they reduce, as the reference's GSPMD computes them on
global arrays. Outside it (one card, or a data-parallel state whose every
parameter is whole) nothing changes. A factored statistic is a cut
block too, the parameter's block less the dimension it reduced
(:func:`factored_slots`), and a checkpoint holds it whole
(``parallel.sharding.gather_state``).
"""

import contextlib
import math
import threading
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

SCHEDULES = ("constant", "cosine", "linear")
OPTIMIZERS = ("adamw", "lion", "adafactor", "sgd")

Params = Dict[str, torch.Tensor]
Schedule = Callable[[int], float]


class GradientTransformation(NamedTuple):
  """``init(params) -> state``; ``update(updates, state, params) ->
  (updates, state)``. An update dict may leave a name out: no change."""
  init: Callable[[Params], Any]
  update: Callable[..., Any]


# -- schedules ---------------------------------------------------------------


def constant_schedule(value: float) -> Schedule:
  return lambda count: value


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
  """optax.linear_schedule: from ``init_value`` to ``end_value`` over
  ``transition_steps`` updates, then flat."""
  if transition_steps <= 0:
    return constant_schedule(init_value)

  def schedule(count):
    frac = 1.0 - min(max(count, 0), transition_steps) / transition_steps
    return (init_value - end_value) * frac + end_value
  return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
  """optax.cosine_decay_schedule: half a cosine from ``init_value`` down
  to ``alpha * init_value`` over ``decay_steps``, then flat."""
  if decay_steps <= 0:
    raise ValueError("cosine_decay_schedule needs decay_steps > 0, got %r"
                     % (decay_steps,))

  def schedule(count):
    frac = min(count, decay_steps) / decay_steps
    cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
    return init_value * ((1.0 - alpha) * cosine + alpha)
  return schedule


def join_schedules(schedules: Sequence[Schedule],
                   boundaries: Sequence[int]) -> Schedule:
  """optax.join_schedules: schedule ``i + 1`` takes over at boundary
  ``i``, counting from 0 there."""
  def schedule(count):
    out = schedules[0](count)
    for boundary, sched in zip(boundaries, schedules[1:]):
      if count >= boundary:
        out = sched(count - boundary)
    return out
  return schedule


def make_schedule(learning_rate: float, schedule: str = "constant",
                  warmup_steps: int = 0, decay_steps: int = 0,
                  end_value: float = 0.0) -> Schedule:
  """Optional linear warmup from 0, then the decay; ``decay_steps``
  counts AFTER warmup and is required for cosine/linear."""
  if schedule not in SCHEDULES:
    raise ValueError("schedule must be one of %s, got %r"
                     % (SCHEDULES, schedule))
  if schedule == "constant":
    base = constant_schedule(learning_rate)
  else:
    if decay_steps <= 0:
      raise ValueError("decay_steps must be > 0 for %r" % (schedule,))
    if schedule == "cosine":
      base = cosine_decay_schedule(
          learning_rate, decay_steps,
          alpha=end_value / learning_rate if learning_rate else 0.0)
    else:
      base = linear_schedule(learning_rate, end_value, decay_steps)
  if warmup_steps > 0:
    warmup = linear_schedule(0.0, learning_rate, warmup_steps)
    return join_schedules([warmup, base], [warmup_steps])
  return base


# -- building blocks ---------------------------------------------------------


_LAYOUT = threading.local()


@contextlib.contextmanager
def param_layout(layout):
  """Run the optimizer's ``init`` / ``update`` over blocks of weights
  laid out by ``layout`` (a ``parallel.sharding.StateSharding``: its
  ``mesh``, ``spec(name)`` and ``global_shape(name)``); None: the
  parameters are whole."""
  before = getattr(_LAYOUT, "current", None)
  _LAYOUT.current = layout
  try:
    yield
  finally:
    _LAYOUT.current = before


def _layout():
  return getattr(_LAYOUT, "current", None)


def _summed(x: torch.Tensor, axes, layout) -> torch.Tensor:
  """``x`` summed over the mesh axes of ``axes`` that are not None."""
  from tensorflowonspark_tpu_torch.parallel import collectives
  axes = tuple(a for a in axes if a is not None)
  return collectives.all_reduce(x, layout.mesh, axes) if axes else x


def _mean_over(x: torch.Tensor, dim: int, axis, size: int, layout,
               keepdim: bool = False) -> torch.Tensor:
  """The mean over dimension ``dim`` of a block whose ``dim`` is cut over
  ``axis`` (None: whole) from a global dimension of ``size``."""
  if layout is None or axis is None:
    return x.mean(dim=dim, keepdim=keepdim)
  return _summed(x.sum(dim=dim, keepdim=keepdim), (axis,), layout) / size


class _Count(object):
  """A step counter as optax keeps one (``ScaleByScheduleState`` etc.)."""

  def __init__(self):
    self.count = 0


def _lists(updates: Params, names=None) -> List[torch.Tensor]:
  return [updates[n] for n in (updates if names is None else names)]


def _resolve_mask(mask, params: Params) -> Optional[Dict[str, bool]]:
  if mask is None:
    return None
  return dict(mask(params) if callable(mask) else mask)


def default_decay_mask(params: Params) -> Dict[str, bool]:
  """True for matrices and larger (kernels, embedding tables), False for
  vectors (LayerNorm scales) — the standard LLM recipe."""
  return {name: p.dim() >= 2 for name, p in params.items()}


def _bias_correction(decay: float, count: int) -> float:
  # 1 - decay**count in f32, as optax computes it
  return float(np.float32(1.0) - np.power(np.float32(decay),
                                          np.float32(count)))


def chain(*transforms: GradientTransformation) -> GradientTransformation:
  def init(params):
    return [t.init(params) for t in transforms]

  def update(updates, state, params=None):
    new_state = []
    for t, s in zip(transforms, state):
      updates, s = t.update(updates, s, params)
      new_state.append(s)
    return updates, new_state
  return GradientTransformation(init, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
  """Scale every update by ``max_norm / global_norm`` when the global L2
  norm is at or above ``max_norm`` (decided on the device: no sync)."""
  def update(updates, state, params=None):
    grads = _lists(updates)
    if grads:
      norms = torch._foreach_norm(grads)
      layout = _layout()
      if layout is None:
        g_norm = torch.linalg.vector_norm(torch.stack(norms))
      else:
        g_norm = _sharded_norm(updates, norms, layout)
      factor = torch.where(g_norm < max_norm, torch.ones_like(g_norm),
                           max_norm / g_norm)
      torch._foreach_mul_(grads, factor)
    return updates, state
  return GradientTransformation(lambda params: None, update)


def _sharded_norm(updates, norms, layout) -> torch.Tensor:
  """The global L2 norm of blocks: each block's square counted once, on
  the rank at coordinate 0 of every axis its parameter is whole on (the
  others hold the same values), then summed over the whole mesh."""
  from tensorflowonspark_tpu_torch.parallel import collectives
  mesh = layout.mesh
  sq = []
  for name, n in zip(updates, norms):
    spec = layout.spec(name)
    owner = all(mesh.coord(a) == 0 for a in mesh.wide() if a not in spec)
    sq.append(n * n if owner else torch.zeros_like(n))
  total = collectives.all_reduce(torch.stack(sq).sum(), mesh,
                                 mesh.axis_names)
  return torch.sqrt(total)


class AdamState(NamedTuple):
  count: _Count
  mu: List[torch.Tensor]
  nu: List[torch.Tensor]


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
  """optax.scale_by_adam: bias-corrected moments, ``eps`` outside the
  square root."""
  def init(params):
    return AdamState(_Count(), [torch.zeros_like(p) for p in params.values()],
                     [torch.zeros_like(p) for p in params.values()])

  def update(updates, state, params=None):
    g = _lists(updates)
    torch._foreach_mul_(state.mu, b1)
    torch._foreach_add_(state.mu, g, alpha=1.0 - b1)
    torch._foreach_mul_(state.nu, b2)
    torch._foreach_addcmul_(state.nu, g, g, value=1.0 - b2)
    state.count.count += 1
    c = state.count.count
    denom = torch._foreach_div(state.nu, _bias_correction(b2, c))
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    out = torch._foreach_div(state.mu, _bias_correction(b1, c))
    torch._foreach_div_(out, denom)
    return dict(zip(updates, out)), state
  return GradientTransformation(init, update)


class MomentState(NamedTuple):
  count: _Count
  mu: List[torch.Tensor]


def scale_by_lion(b1: float = 0.9, b2: float = 0.99) -> GradientTransformation:
  """optax.scale_by_lion: ``sign((1 - b1) g + b1 mu)``, then ``mu <- (1 -
  b2) g + b2 mu``."""
  def init(params):
    return MomentState(_Count(), [torch.zeros_like(p)
                                  for p in params.values()])

  def update(updates, state, params=None):
    g = _lists(updates)
    out = torch._foreach_mul(state.mu, b1)
    torch._foreach_add_(out, g, alpha=1.0 - b1)
    for t in out:
      t.sign_()
    torch._foreach_mul_(state.mu, b2)
    torch._foreach_add_(state.mu, g, alpha=1.0 - b2)
    state.count.count += 1
    return dict(zip(updates, out)), state
  return GradientTransformation(init, update)


def trace(decay: float, nesterov: bool = False) -> GradientTransformation:
  """optax.trace: ``t <- g + decay t``; the update is ``t`` or, with
  Nesterov, ``g + decay t``."""
  def init(params):
    return [torch.zeros_like(p) for p in params.values()]

  def update(updates, state, params=None):
    g = _lists(updates)
    torch._foreach_mul_(state, decay)
    torch._foreach_add_(state, g)
    if nesterov:
      torch._foreach_add_(g, state, alpha=decay)
      return updates, state
    return dict(zip(updates, [t.clone() for t in state])), state
  return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float,
                        mask=None) -> GradientTransformation:
  """optax.add_decayed_weights: ``u + weight_decay * p`` where ``mask``
  (None, a ``{name: bool}`` dict, or a callable of the params) says so."""
  def update(updates, state, params=None):
    if params is None:
      raise ValueError("add_decayed_weights needs the params")
    m = _resolve_mask(mask, params)
    names = [n for n in updates if m is None or m[n]]
    if names and weight_decay:
      torch._foreach_add_(_lists(updates, names), _lists(params, names),
                          alpha=weight_decay)
    return updates, state
  return GradientTransformation(lambda params: None, update)


def scale_by_learning_rate(learning_rate,
                           flip_sign: bool = True) -> GradientTransformation:
  """Multiply by ``-learning_rate`` (``+learning_rate`` without
  ``flip_sign``; a float, or a schedule evaluated at this
  transformation's own count)."""
  sched = learning_rate if callable(learning_rate) else \
      constant_schedule(learning_rate)
  sign = -1.0 if flip_sign else 1.0

  def update(updates, state, params=None):
    lr = sched(state.count)
    state.count += 1
    torch._foreach_mul_(_lists(updates), sign * float(lr))
    return updates, state
  return GradientTransformation(lambda params: _Count(), update)


def scale(step_size: float) -> GradientTransformation:
  """optax.scale: multiply every update by ``step_size``."""
  def update(updates, state, params=None):
    torch._foreach_mul_(_lists(updates), step_size)
    return updates, state
  return GradientTransformation(lambda params: None, update)


def _block_rms(tensors: List[torch.Tensor],
               names: Sequence[str] = ()) -> List[torch.Tensor]:
  """``sqrt(mean(x ** 2))`` of each tensor, on its device; of the whole
  parameter ``names[i]`` when :func:`param_layout` cuts it into blocks."""
  layout = _layout()
  out = []
  for i, t in enumerate(tensors):
    spec = layout.spec(names[i]) if layout is not None else ()
    if not any(spec):
      out.append(torch.sqrt(torch.mean(t * t)))
      continue
    total = _summed(torch.sum(t * t), spec, layout)
    out.append(torch.sqrt(total / math.prod(layout.global_shape(names[i]))))
  return out


def clip_by_block_rms(threshold: float) -> GradientTransformation:
  """optax.clip_by_block_rms: divide each update by ``max(1, rms(u) /
  threshold)``."""
  def update(updates, state, params=None):
    u = _lists(updates)
    if u:
      denom = [torch.clamp(r / threshold, min=1.0)
               for r in _block_rms(u, list(updates))]
      torch._foreach_div_(u, denom)
    return updates, state
  return GradientTransformation(lambda params: None, update)


def scale_by_param_block_rms(min_scale: float = 1e-3
                             ) -> GradientTransformation:
  """optax.scale_by_param_block_rms: multiply each update by its
  parameter's rms, or by ``min_scale`` where that is at or below it."""
  def update(updates, state, params=None):
    if params is None:
      raise ValueError("scale_by_param_block_rms needs the params")
    names = list(updates)
    if names:
      factors = [torch.where(r <= min_scale, torch.full_like(r, min_scale), r)
                 for r in _block_rms(_lists(params, names), names)]
      torch._foreach_mul_(_lists(updates, names), factors)
    return updates, state
  return GradientTransformation(lambda params: None, update)


def _factored_dims(shape: Sequence[int], min_dim_size_to_factor: int
                   ) -> Optional[Tuple[int, int]]:
  """optax's rule: the (second largest, largest) dims of a parameter of
  two or more dims whose second largest is at least
  ``min_dim_size_to_factor``, else None. The shape is the parameter's
  own: a [D, H, d] kernel is never viewed as a matrix."""
  if len(shape) < 2:
    return None
  order = np.argsort(shape)
  if shape[order[-2]] < min_dim_size_to_factor:
    return None
  return int(order[-2]), int(order[-1])


class FactoredState(NamedTuple):
  """optax.FactoredState: the step count and, per parameter, its row and
  column second moments (factored) or its whole second moment (not); a
  slot a parameter does not use holds one zero, as in optax."""
  count: _Count
  v_row: List[torch.Tensor]
  v_col: List[torch.Tensor]
  v: List[torch.Tensor]


def factored_slots(global_shape: Sequence[int], block_shape: Sequence[int],
                   v_row_shape: Sequence[int], v_col_shape: Sequence[int],
                   v_shape: Sequence[int]) -> Optional[Tuple[int, int]]:
  """Which slots of a :class:`FactoredState` one parameter uses, from the
  shapes they hold: ``(d1, d0)`` of :func:`_factored_dims` on the
  parameter's GLOBAL shape when ``v_row`` is its block less ``d0`` and
  ``v_col`` its block less ``d1`` (factored: over a mesh each is cut as
  the dimensions it keeps are), None when ``v`` is its block (not
  factored). Whether a parameter factors hangs on
  ``min_dim_size_to_factor``, which the state does not keep, so the
  shapes decide; where neither reading fits, ``ValueError``."""
  block = tuple(block_shape)
  if len(global_shape) >= 2:
    d1, d0 = _factored_dims(global_shape, 0)
    if tuple(v_row_shape) == block[:d0] + block[d0 + 1:] and \
        tuple(v_col_shape) == block[:d1] + block[d1 + 1:] and \
        tuple(v_shape) == (1,):
      return d1, d0
  if tuple(v_shape) == block and tuple(v_row_shape) == (1,) and \
      tuple(v_col_shape) == (1,):
    return None
  raise ValueError(
      "factored statistics of shapes v_row %s, v_col %s, v %s fit neither "
      "reading of a parameter block %s (global %s)"
      % (tuple(v_row_shape), tuple(v_col_shape), tuple(v_shape), block,
         tuple(global_shape)))


def scale_by_factored_rms(decay_rate: float = 0.8,
                          min_dim_size_to_factor: int = 128,
                          epsilon: float = 1e-30) -> GradientTransformation:
  """optax.scale_by_factored_rms (no step offset): the gradient scaled by
  the inverse root of a second-moment estimate decayed at ``1 - (t +
  1) ** -decay_rate`` from ``g ** 2 + epsilon``. A factored parameter keeps
  the means over its largest dim (``v_row``) and over its second largest
  (``v_col``) and scales by their outer product over ``v_row``'s mean."""
  def shape_of(name, t):
    layout = _layout()
    return layout.global_shape(name) if layout is not None else t.shape

  def init(params):
    v_row, v_col, v = [], [], []
    for name, p in params.items():
      dims = _factored_dims(shape_of(name, p), min_dim_size_to_factor)
      if dims is None:
        v_row.append(p.new_zeros(1))
        v_col.append(p.new_zeros(1))
        v.append(torch.zeros_like(p))
        continue
      d1, d0 = dims
      shape = list(p.shape)
      v_row.append(p.new_zeros(shape[:d0] + shape[d0 + 1:]))
      v_col.append(p.new_zeros(shape[:d1] + shape[d1 + 1:]))
      v.append(p.new_zeros(1))
    return FactoredState(_Count(), v_row, v_col, v)

  def update(updates, state, params=None):
    if params is None:
      raise ValueError("scale_by_factored_rms needs the params")
    # the decay in f32, as optax computes it on the device
    t = np.float32(state.count.count + 1)
    beta = np.float32(1.0) - t ** np.float32(-decay_rate)
    keep, take = float(beta), float(np.float32(1.0) - beta)
    out = {}
    layout = _layout()
    for i, (name, g) in enumerate(updates.items()):
      g2 = (g * g).add_(epsilon)
      gshape = shape_of(name, g)
      dims = _factored_dims(gshape, min_dim_size_to_factor)
      if dims is None:
        v = state.v[i]
        v.mul_(keep).add_(g2, alpha=take)
        out[name] = g * torch.rsqrt(v)
        continue
      d1, d0 = dims
      spec = layout.spec(name) if layout is not None else (None,) * g.dim()
      v_row, v_col = state.v_row[i], state.v_col[i]
      v_row.mul_(keep).add_(_mean_over(g2, d0, spec[d0], gshape[d0], layout),
                            alpha=take)
      v_col.mul_(keep).add_(_mean_over(g2, d1, spec[d1], gshape[d1], layout),
                            alpha=take)
      reduced_d1 = d1 - 1 if d1 > d0 else d1
      row_factor = torch.rsqrt(v_row / _mean_over(
          v_row, reduced_d1, spec[d1], gshape[d1], layout, keepdim=True))
      col_factor = torch.rsqrt(v_col)
      out[name] = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
    state.count.count += 1
    return out, state
  return GradientTransformation(init, update)


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4,
          mask=None) -> GradientTransformation:
  """optax.adamw (its defaults)."""
  return chain(scale_by_adam(b1, b2, eps),
               add_decayed_weights(weight_decay, mask),
               scale_by_learning_rate(learning_rate))


def lion(learning_rate, b1: float = 0.9, b2: float = 0.99,
         weight_decay: float = 1e-3, mask=None) -> GradientTransformation:
  """optax.lion (its defaults)."""
  return chain(scale_by_lion(b1, b2), add_decayed_weights(weight_decay, mask),
               scale_by_learning_rate(learning_rate))


def adafactor(learning_rate) -> GradientTransformation:
  """optax.adafactor at its defaults: factored second moments (decay
  0.8, factored from dims of 128), each update clipped to rms 1, scaled
  by the learning rate and by its parameter's rms (at least 1e-3); no
  momentum, no weight decay of its own."""
  return chain(scale_by_factored_rms(), clip_by_block_rms(1.0),
               scale_by_learning_rate(learning_rate, flip_sign=False),
               scale_by_param_block_rms(), scale(-1.0))


def sgd(learning_rate, momentum: Optional[float] = None,
        nesterov: bool = False) -> GradientTransformation:
  """optax.sgd: optional (Nesterov) momentum, then the learning rate."""
  parts = [] if momentum is None else [trace(momentum, nesterov)]
  return chain(*parts, scale_by_learning_rate(learning_rate))


def _lr_scaled_weight_decay(sched: Schedule, weight_decay: float,
                            mask) -> GradientTransformation:
  """Decoupled weight decay ``u - lr_t * weight_decay * p`` on its own
  count, honouring the mask (the reference adds it after the cores that
  lack an lr-scaled decay: adafactor and sgd)."""
  def update(updates, state, params=None):
    if params is None:
      raise ValueError("weight decay requires params")
    lr = sched(state.count)
    state.count += 1
    m = _resolve_mask(mask, params)
    names = [n for n in updates if m is None or m[n]]
    if names:
      torch._foreach_add_(_lists(updates, names), _lists(params, names),
                          alpha=-float(lr) * weight_decay)
    return updates, state
  return GradientTransformation(lambda params: _Count(), update)


class MultiStepsState(object):
  """optax.MultiStepsState: the mini-step within the current k, the
  optimizer steps taken, the inner state and the running gradient mean."""

  def __init__(self, inner, acc):
    self.mini_step = 0
    self.gradient_step = 0
    self.inner = inner
    self.acc = acc


class MultiSteps(object):
  """optax.MultiSteps (mean of gradients): the inner transformation runs
  once every ``every_k_schedule`` updates on the mean of their gradients;
  the updates in between are empty (no change)."""

  def __init__(self, opt: GradientTransformation, every_k_schedule: int):
    if every_k_schedule < 1:
      raise ValueError("every_k_schedule must be >= 1, got %d"
                       % every_k_schedule)
    self.inner_opt = opt
    self.k = int(every_k_schedule)

  def init(self, params: Params) -> MultiStepsState:
    return MultiStepsState(self.inner_opt.init(params),
                           {n: torch.zeros_like(p)
                            for n, p in params.items()})

  def update(self, updates: Params, state: MultiStepsState, params=None):
    names = list(updates)
    g = _lists(updates)
    acc = _lists(state.acc, names)
    # acc + (g - acc) / (n + 1)
    torch._foreach_sub_(g, acc)
    torch._foreach_div_(g, float(state.mini_step + 1))
    torch._foreach_add_(acc, g)
    if state.mini_step < self.k - 1:
      state.mini_step += 1
      return {}, state
    out, state.inner = self.inner_opt.update(state.acc, state.inner, params)
    state.acc = {n: torch.zeros_like(t) for n, t in state.acc.items()}
    state.mini_step = 0
    state.gradient_step += 1
    return out, state

  def has_updated(self, state: MultiStepsState) -> bool:
    return state.mini_step == 0 and state.gradient_step > 0


def make_optimizer(learning_rate: float = 3e-4, weight_decay: float = 0.01,
                   schedule: str = "constant", warmup_steps: int = 0,
                   decay_steps: int = 0, end_value: float = 0.0,
                   clip_norm: float = 0.0, b1: float = 0.9, b2: float = 0.95,
                   decay_mask="auto", optimizer: str = "adamw",
                   momentum: float = 0.9, grad_accum_steps: int = 1,
                   tx_extra: Optional[GradientTransformation] = None):
  """The standard training recipe around a chosen optimizer core, as the
  JAX package's ``make_optimizer``: ``clip_norm`` > 0 prepends global-norm
  clipping; ``decay_mask="auto"`` decays only ndim >= 2 params (None
  decays everything, or pass a dict / callable); ``tx_extra`` is chained
  last; ``grad_accum_steps`` > 1 wraps the chain in :class:`MultiSteps`.
  Cores: ``adamw``, ``lion``, ``adafactor`` and ``sgd`` (Nesterov); the
  last two take their decay from :func:`_lr_scaled_weight_decay`.
  """
  if optimizer not in OPTIMIZERS:
    raise ValueError("optimizer must be one of %s, got %r"
                     % (OPTIMIZERS, optimizer))
  sched = make_schedule(learning_rate, schedule, warmup_steps, decay_steps,
                        end_value)
  if isinstance(decay_mask, str) and decay_mask == "auto":
    decay_mask = default_decay_mask if weight_decay else None
  parts = []
  if clip_norm and clip_norm > 0:
    parts.append(clip_by_global_norm(clip_norm))
  if optimizer == "adamw":
    parts.append(adamw(sched, b1=b1, b2=b2, weight_decay=weight_decay,
                       mask=decay_mask))
  elif optimizer == "lion":
    parts.append(lion(sched, b1=b1, b2=b2, weight_decay=weight_decay,
                      mask=decay_mask))
  elif optimizer == "adafactor":
    parts.append(adafactor(sched))
  else:
    parts.append(sgd(sched, momentum=momentum, nesterov=True))
  if optimizer in ("adafactor", "sgd") and weight_decay:
    parts.append(_lr_scaled_weight_decay(sched, weight_decay, decay_mask))
  if tx_extra is not None:
    parts.append(tx_extra)
  tx = chain(*parts) if len(parts) > 1 else parts[0]
  if grad_accum_steps > 1:
    tx = MultiSteps(tx, every_k_schedule=grad_accum_steps)
  return tx


@torch.no_grad()
def apply_updates(params: Params, updates: Params) -> None:
  """``p += u`` in place for every name in ``updates``."""
  names = [n for n in updates]
  if names:
    torch._foreach_add_(_lists(params, names), _lists(updates, names))
