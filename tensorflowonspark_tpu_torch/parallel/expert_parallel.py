"""Expert parallelism: a mixture-of-experts FFN cut over the ``expert``
mesh axis.

Counterpart of ``tensorflowonspark_tpu/parallel/expert_parallel.py``:
the same routing (top-k over the router's softmax, ties to the lower
expert index as ``lax.top_k`` breaks them; combine weights renormalized
over the selected set for top-k > 1), the Switch/GShard
:func:`load_balancing_loss`, the single-device :func:`moe_ffn_reference`
and the two dispatch strategies:

- :func:`moe_ffn` — dense masked dispatch: each rank of the ``expert``
  axis runs its block of the experts over every token of its data block
  (masked), and one all-reduce over the axis sums the partial outputs;
- :func:`moe_ffn_a2a` — GShard-style: each rank routes its ``1/E`` slice
  of the tokens, two all-to-alls move the capacity-bounded assignments
  to the ranks that own their experts and back, and the slices are
  gathered again over the axis.

Where the reference runs a ``shard_map`` body per device, the port runs
it in each process on the rank's blocks, and the conjugate of every
collective is explicit (``parallel.collectives``): in :func:`moe_ffn`
the input, which every expert rank holds alike, enters through
``copy_to`` (its gradient summed over the axis) and the partial sums
leave through ``reduce_from``; the combine weights' columns are cut with
``split_to``, so the router's gradient is whole on every rank. In
:func:`moe_ffn_a2a` the token slice is ``split_to`` and the gather back
``gather_to`` (a reduce-scatter there would multiply the gradient by
the axis's degree), and the router weight enters through ``copy_to``:
each rank routes only its own tokens, so its share of the router's
gradient is summed over the axis. The router and the experts compute in
f32 from f32 weights and the output is cast back to the input's dtype.
The expert products are batched matrix products, which the JAX package
computes outside any Pallas kernel too.

In a train state the expert stacks are cut by the logical rule
``"expert"`` on their leading dimension (:func:`shard_moe_params` cuts
the same blocks from whole weights), so a checkpoint gathers them, and
their moments, along that dimension and a restore cuts them again for
any expert degree (``parallel.sharding.gather_state`` / ``cut_state``).
"""

from typing import Dict, Optional

import numpy as np
import torch

from tensorflowonspark_tpu_torch.parallel import collectives
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib


def init_moe_params(seed: int, num_experts: int, d_model: int, d_ff: int,
                    dtype: torch.dtype = torch.float32
                    ) -> Dict[str, torch.Tensor]:
  """The reference's ``init_moe_params`` laws (standard normals scaled by
  ``1/sqrt(d_model)`` for the gate and ``w_up``, ``1/sqrt(d_ff)`` for
  ``w_down``) drawn with numpy from ``seed``: the numbers differ from
  JAX's draw."""
  rng = np.random.default_rng(seed)
  scale_in = 1.0 / d_model ** 0.5

  def normal(shape, scale):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                            * np.float32(scale)).to(dtype)

  return {"w_gate": normal((d_model, num_experts), scale_in),
          "w_up": normal((num_experts, d_model, d_ff), scale_in),
          "w_down": normal((num_experts, d_ff, d_model), 1.0 / d_ff ** 0.5)}


def _router_probs(x: torch.Tensor, w_gate: torch.Tensor) -> torch.Tensor:
  """Router forward: softmax probabilities ``[T, E]`` in f32, the single
  source of the gating math for every dispatch strategy and the aux
  loss."""
  return torch.softmax(x.float() @ w_gate.float(), dim=-1)


def _topk_dispatch(probs: torch.Tensor, top_k: int) -> torch.Tensor:
  """Binary multi-hot dispatch ``[T, E]`` selecting each token's top-k
  experts; equal probabilities rank the lower expert index first, as
  ``lax.top_k`` does (a stable descending sort)."""
  idx = torch.sort(probs.detach(), dim=-1, descending=True,
                   stable=True).indices[:, :top_k]
  out = torch.zeros_like(probs, requires_grad=False)
  return out.scatter_(1, idx, 1.0)


def _combine_weights(probs: torch.Tensor, dispatch: torch.Tensor,
                     top_k: int) -> torch.Tensor:
  """Combine weights ``[T, E]``: the gate probabilities of the selected
  experts, renormalized over them for top_k > 1."""
  selected = probs * dispatch
  if top_k == 1:
    return selected
  return selected / selected.sum(dim=-1, keepdim=True)


def route(params, x: torch.Tensor, top_k: int = 1):
  """Top-k routing: ``(dispatch [T, E] multi-hot, combine [T, E], probs
  [T, E])``, as the reference's ``route``."""
  probs = _router_probs(x, params["w_gate"])
  dispatch = _topk_dispatch(probs, top_k)
  return dispatch, _combine_weights(probs, dispatch, top_k), probs


def _route(params, x, top_k: int = 1):
  return route(params, x, top_k)[:2]


def aux_loss_from(probs: torch.Tensor, dispatch: torch.Tensor,
                  top_k: int = 1) -> torch.Tensor:
  """The load-balancing loss from an existing routing: ``E * sum_e
  fraction_routed_e * mean_prob_e`` (1.0 under uniform routing)."""
  fraction = dispatch.mean(dim=0) / top_k
  return probs.shape[-1] * torch.sum(fraction * probs.mean(dim=0))


def load_balancing_loss(params, x: torch.Tensor,
                        top_k: int = 1) -> torch.Tensor:
  """Auxiliary load-balancing loss (Switch/GShard style) of ``x``'s
  routing; differentiable in the gate."""
  probs = _router_probs(x, params["w_gate"])
  return aux_loss_from(probs, _topk_dispatch(probs, top_k), top_k)


def _experts(x: torch.Tensor, dispatch: torch.Tensor, combine: torch.Tensor,
             w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
  """The dense masked expert FFN over ``w_up``'s experts: ``x [T, D]``,
  ``dispatch`` / ``combine`` ``[T, E]`` -> f32 ``[T, D]``."""
  xe = dispatch.t()[:, :, None] * x.float()[None]              # [E, T, D]
  h = torch.relu(torch.bmm(xe, w_up.float()))                  # [E, T, F]
  out = torch.bmm(h, w_down.float())                           # [E, T, D]
  return torch.einsum("etd,te->td", out, combine)


def moe_ffn_reference(params, x: torch.Tensor, top_k: int = 1,
                      routing=None) -> torch.Tensor:
  """Single-device reference: ``x [T, D] -> [T, D]``. ``routing``
  optionally supplies a precomputed ``(dispatch, combine)`` pair from
  :func:`route`."""
  dispatch, combine = routing if routing is not None \
      else _route(params, x, top_k)
  return _experts(x, dispatch, combine, params["w_up"],
                  params["w_down"]).to(x.dtype)


def _expert_block(mesh, num_experts: int, local: int) -> slice:
  """The experts this rank holds: ``local`` of ``num_experts`` at its
  coordinate on the expert axis."""
  n = mesh_lib.axis_size(mesh, mesh_lib.AXIS_EXPERT)
  if local * n != num_experts:
    raise ValueError("%d experts do not divide over the expert axis of %d "
                     "(a rank holds %d)" % (num_experts, n, local))
  r = mesh_lib.axis_index(mesh, mesh_lib.AXIS_EXPERT)
  return slice(r * local, (r + 1) * local)


def moe_ffn(params, x: torch.Tensor, mesh, top_k: int = 1,
            routing=None) -> torch.Tensor:
  """Expert-sharded MoE FFN with dense masked dispatch. ``x``: this
  rank's tokens ``[T, D]`` (its block of the data axes, the same on
  every rank of the expert axis); ``params``: the gate whole, ``w_up`` /
  ``w_down`` this rank's block of the experts (:func:`shard_moe_params`).
  Returns the rank's ``[T, D]``, whole over the expert axis."""
  ax = mesh_lib.AXIS_EXPERT
  dispatch, combine = routing if routing is not None \
      else _route(params, x, top_k)
  block = _expert_block(mesh, dispatch.shape[-1], params["w_up"].shape[0])
  combine = collectives.split_to(combine, mesh, ax, axis=1)
  partial = _experts(collectives.copy_to(x, mesh, ax), dispatch[:, block],
                     combine, params["w_up"], params["w_down"])
  return collectives.reduce_from(partial, mesh, ax).to(x.dtype)


def moe_ffn_a2a(params, x: torch.Tensor, mesh, capacity_factor: float = 2.0,
                top_k: int = 1, drops: Optional[list] = None
                ) -> torch.Tensor:
  """Expert-parallel MoE with all-to-all token dispatch (GShard). ``x``:
  this rank's tokens ``[T, D]``, the same on every rank of the expert
  axis; each rank takes its ``T / E_axis`` slice (``t_local``), routes
  it, queues each (token, expert) assignment at its position in that
  expert's queue (a cumulative count over the slice in token order) and
  keeps those below the capacity, ``max(1, int(ceil(t_local * k / E) *
  capacity_factor))`` as the reference's; the dropped ones contribute
  zero, and a token's surviving experts keep their renormalized weights.
  Two all-to-alls over the expert axis carry the kept assignments to the
  rank holding their expert and the outputs back; the slices' outputs
  are gathered again. With ``drops`` (a list), this rank's count of
  dropped assignments is appended to it (a 0-d tensor, not read on the
  host)."""
  ax = mesh_lib.AXIS_EXPERT
  num_experts = params["w_gate"].shape[-1]
  n = mesh_lib.axis_size(mesh, ax)
  _expert_block(mesh, num_experts, params["w_up"].shape[0])
  if x.shape[0] % n:
    raise ValueError("%d tokens do not divide over the expert axis of %d"
                     % (x.shape[0], n))
  t_local = x.shape[0] // n
  capacity = max(1, int(-(-t_local * top_k // num_experts)
                        * capacity_factor))
  xs = collectives.split_to(x, mesh, ax, axis=0)
  probs = _router_probs(xs, collectives.copy_to(params["w_gate"], mesh, ax))
  mh = _topk_dispatch(probs, top_k)
  combine_w = _combine_weights(probs, mh, top_k)
  pos = (torch.cumsum(mh, dim=0) - 1.0) * mh                   # [T, E]
  keep = mh * (pos < capacity).to(mh.dtype)
  if drops is not None:
    drops.append((mh.sum() - keep.sum()).detach())
  slots = torch.nn.functional.one_hot(
      pos.long().clamp(0, capacity - 1), capacity).to(mh.dtype)
  dispatch = keep[:, :, None] * slots                          # [T, E, C]
  combine = dispatch * combine_w[:, :, None]
  expert_in = torch.einsum("tec,td->ecd", dispatch, xs.float())
  expert_in = collectives.all_to_all(expert_in, mesh, ax, 0, 1)
  h = torch.relu(torch.bmm(expert_in, params["w_up"].float()))
  out = torch.bmm(h, params["w_down"].float())
  out = collectives.all_to_all(out, mesh, ax, 1, 0)            # [E, C, D]
  y = torch.einsum("ecd,tec->td", out, combine).to(x.dtype)
  return collectives.gather_to(y, mesh, ax, axis=0)


def shard_moe_params(params, mesh) -> Dict[str, torch.Tensor]:
  """This rank's MoE weights from whole ones: the gate whole, the expert
  stacks' block of the expert axis."""
  n = mesh_lib.axis_size(mesh, mesh_lib.AXIS_EXPERT)
  local = params["w_up"].shape[0] // n
  block = _expert_block(mesh, params["w_up"].shape[0], local)
  return {"w_gate": params["w_gate"], "w_up": params["w_up"][block],
          "w_down": params["w_down"][block]}


__all__ = ["init_moe_params", "route", "load_balancing_loss",
           "aux_loss_from", "moe_ffn_reference", "moe_ffn", "moe_ffn_a2a",
           "shard_moe_params"]
