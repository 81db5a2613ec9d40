"""DeploymentController: SLO-gated canary rollout over the serving fleet.

The port's copy of ``tensorflowonspark_tpu/serving/deploy.py``. A trainer
publishes versioned params to a :class:`~.registry.ModelRegistry`; this
controller watches the registry and drives every new version through a
small, recoverable state machine on a live :class:`~.fleet.ServingFleet`,
shedding no accepted request at any point, because every replica move
rides the fleet's zero-shed ``swap_replica`` drain.

State machine::

    IDLE ── registry.watch() sees version v ──▶ CANARY
    CANARY: swap ONE replica to v (zero-shed), route a configurable
            traffic slice to it (fleet.set_canary), stamp every
            request/trace with the serving model_version
    VERIFY: greedy parity spot-checks of the canary engine against a
            reference decode of the candidate params (bit-identical or
            it fails), plus obs deltas over a bake window: canary-vs-
            baseline TTFT from the fleet's timing ledgers, ejection/
            shed/replay-mismatch counter deltas, and an ``slo_status()``
            burn check when a source is wired
    PROMOTE: rolling zero-shed swap of the remaining replicas to v; the
             fleet factory adopts v (later ejection rebuilds and
             ``on_saturated`` scale-ups build v engines)
    ROLLBACK: swap the canary back to the baseline version and
              quarantine v in the registry with the structured verdict,
              so ``watch()`` never hands it out again

The parity oracle is the caller's ``reference_decode``. On the card in
bf16 it must be an engine with the replicas' options (a bare
``ServingEngine`` on the candidate's params, one request at a time): the
port's ``greedy_generate_kv`` is not held to the engine's bf16 bits.

Chaos (``TOS_CHAOS_DEPLOY``, ``utils/chaos.py``): ``kill`` at a state
boundary raises :class:`ControllerKilled` (the controller dying with the
fleet mid-transition), and :meth:`resume` must then converge every
replica to one version with zero shed; ``poison`` corrupts the
candidate's params at the canary build, which VERIFY must catch and
quarantine, never promote.
"""

import logging
import os
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tensorflowonspark_tpu_torch.obs import metrics as obs_metrics
from tensorflowonspark_tpu_torch.utils import chaos

logger = logging.getLogger(__name__)

#: canary traffic slice as a fraction of placement rounds (0.25 ⇒ every
#: 4th round tries the canary first)
ENV_DEPLOY_SLICE = "TOS_DEPLOY_SLICE"
#: VERIFY bake window in seconds (sampling traffic flows during it)
ENV_DEPLOY_BAKE = "TOS_DEPLOY_BAKE"
#: number of greedy parity spot-checks VERIFY runs on the canary engine
ENV_DEPLOY_SPOT_CHECKS = "TOS_DEPLOY_SPOT_CHECKS"
#: canary/baseline median-TTFT ratio above which VERIFY fails
#: (``canary_degraded``'s threshold too — generous by default: CPU test
#: boxes are noisy, and parity is the sharp gate)
ENV_DEPLOY_TTFT_RATIO = "TOS_DEPLOY_TTFT_RATIO"
#: registry poll cadence of the watch loop, seconds
ENV_DEPLOY_POLL = "TOS_DEPLOY_POLL"
#: per-replica drain bound for every zero-shed swap, seconds
ENV_DEPLOY_SWAP_TIMEOUT = "TOS_DEPLOY_SWAP_TIMEOUT"

_DEFAULT_SLICE = 0.25
_DEFAULT_BAKE = 2.0
_DEFAULT_SPOT_CHECKS = 4
_DEFAULT_TTFT_RATIO = 10.0
_DEFAULT_POLL = 0.2
_DEFAULT_SWAP_TIMEOUT = 60.0

IDLE = "idle"
CANARY = "canary"
VERIFY = "verify"
PROMOTE = "promote"
ROLLBACK = "rollback"
#: numeric codes for the ``deploy.state`` gauge (obs_top renders them)
STATE_CODES = {IDLE: 0, CANARY: 1, VERIFY: 2, PROMOTE: 3, ROLLBACK: 4}


class ControllerKilled(RuntimeError):
  """The driver-side controller died at a deploy boundary (chaos kill).
  The fleet keeps serving whatever mix of versions the death left; a
  new/restarted controller calls :meth:`DeploymentController.resume` to
  converge it."""


def _env_float(name: str, default: float) -> float:
  return float(os.environ.get(name, str(default)))


def _env_int(name: str, default: int) -> int:
  return int(os.environ.get(name, str(default)))


def _poison(params):
  """The chaos ``poison`` action: a deterministic, shape- and
  dtype-preserving corruption of every leaf of the flat params (nested
  dicts are walked): the canary serves confidently wrong logits, the
  failure class VERIFY's bit-parity gate exists to catch."""
  def leaf(a):
    if isinstance(a, dict):
      return {k: leaf(v) for k, v in a.items()}
    if torch.is_tensor(a):
      return (-a - 1).to(a.dtype)
    a = np.asarray(a)
    return (-a - 1).astype(a.dtype)
  return leaf(params)


class DeploymentController(object):
  """Drive registry versions through CANARY → VERIFY → PROMOTE/ROLLBACK
  on a live fleet, zero-shed end to end.

  ``make_engine_factory(params, manifest)`` returns a zero-arg engine
  factory for a version (the caller closes over its TransformerConfig —
  the controller never imports the model). ``reference_decode(params,
  prompt, budget)`` is the parity oracle: the single-request greedy
  decode (prompt + generated, stop-truncated) the canary's output must
  equal bit-for-bit. ``probe_prompts`` is a list of ``(prompt, budget)``
  pairs used for both VERIFY spot-checks and the pre-canary baseline
  capture (the rollback bit-identity proof). ``slo_source`` (optional)
  is a zero-arg callable returning ``Cluster.slo_status()``-shaped
  dicts; any burning objective fails VERIFY.
  """

  def __init__(self, fleet, registry,
               make_engine_factory: Callable,
               reference_decode: Callable,
               probe_prompts: Sequence[Tuple],
               baseline_version: Optional[int] = None,
               traffic_slice: Optional[float] = None,
               bake_seconds: Optional[float] = None,
               spot_checks: Optional[int] = None,
               ttft_degrade_ratio: Optional[float] = None,
               poll: Optional[float] = None,
               swap_timeout: Optional[float] = None,
               slo_source: Optional[Callable] = None):
    if not probe_prompts:
      raise ValueError("probe_prompts must name at least one "
                       "(prompt, budget) pair — VERIFY has no parity "
                       "oracle without one")
    self.fleet = fleet
    self.registry = registry
    self.make_engine_factory = make_engine_factory
    self.reference_decode = reference_decode
    self.probe_prompts = [(np.asarray(p, np.int32).ravel(), int(b))
                          for p, b in probe_prompts]
    # explicit arguments beat the env knobs (the num_slots rule)
    self.traffic_slice = float(
        traffic_slice if traffic_slice is not None
        else _env_float(ENV_DEPLOY_SLICE, _DEFAULT_SLICE))
    if not 0.0 < self.traffic_slice <= 1.0:
      raise ValueError("traffic_slice must be in (0, 1], got %r"
                       % self.traffic_slice)
    self.bake_seconds = float(
        bake_seconds if bake_seconds is not None
        else _env_float(ENV_DEPLOY_BAKE, _DEFAULT_BAKE))
    self.spot_checks = int(
        spot_checks if spot_checks is not None
        else _env_int(ENV_DEPLOY_SPOT_CHECKS, _DEFAULT_SPOT_CHECKS))
    self.ttft_degrade_ratio = float(
        ttft_degrade_ratio if ttft_degrade_ratio is not None
        else _env_float(ENV_DEPLOY_TTFT_RATIO, _DEFAULT_TTFT_RATIO))
    self.poll = float(poll if poll is not None
                      else _env_float(ENV_DEPLOY_POLL, _DEFAULT_POLL))
    self.swap_timeout = float(
        swap_timeout if swap_timeout is not None
        else _env_float(ENV_DEPLOY_SWAP_TIMEOUT, _DEFAULT_SWAP_TIMEOUT))
    self.slo_source = slo_source
    #: the version the fleet BASELINE serves (promoted last), or None
    self.current_version = baseline_version
    #: the version currently mid-state-machine, or None
    self.candidate_version: Optional[int] = None
    self.state = IDLE
    self.last_verdict: Optional[dict] = None
    self._stats_lock = threading.Lock()
    self.stats = {"canaries": 0, "promotions": 0, "rollbacks": 0,
                  "parity_failures": 0, "resumes": 0}
    self._stop_evt = threading.Event()
    self._thread: Optional[threading.Thread] = None
    reg = obs_metrics.active()
    self._obs_m = None if reg is None else {
        k: reg.counter("deploy." + k) for k in self.stats}
    self._obs_g = None if reg is None else {
        "state": reg.gauge("deploy.state"),
        "version": reg.gauge("deploy.version"),
        "candidate": reg.gauge("deploy.candidate"),
        "canary_ttft_ratio": reg.gauge("deploy.canary_ttft_ratio"),
    }
    if baseline_version is not None:
      self.registry.acquire(baseline_version)  # tosa: ignore[TOS007] - refcount, not a lock
    self._set_state(IDLE)

  # -- bookkeeping -----------------------------------------------------------

  def _count(self, key: str, n: int = 1) -> None:
    with self._stats_lock:
      self.stats[key] += n
    if self._obs_m is not None:
      self._obs_m[key].inc(n)

  def _set_state(self, state: str) -> None:
    self.state = state
    if self._obs_g is not None:
      self._obs_g["state"].set(STATE_CODES[state])
      self._obs_g["version"].set(self.current_version or 0)
      self._obs_g["candidate"].set(self.candidate_version or 0)

  def status(self) -> dict:
    """The HEALTH-wire deploy payload (obs_top renders it)."""
    return {"state": self.state,
            "state_code": STATE_CODES[self.state],
            "version": self.current_version,
            "candidate": self.candidate_version,
            "served_versions": {str(k): v for k, v in
                                self.fleet.served_versions().items()},
            "stats": dict(self.stats),
            "last_verdict": self.last_verdict}

  def _chaos(self, point: str, index) -> Optional[str]:
    verdict = chaos.deploy_fault(point, index)
    if verdict == "kill":
      # the driver-side controller dies HERE: no cleanup, no rollback —
      # whatever version mix the fleet serves right now is what a
      # restarted controller's resume() must converge
      raise ControllerKilled(
          "chaos: deploy controller killed at %r (index %r)"
          % (point, index))
    return verdict

  # -- the state machine -----------------------------------------------------

  def deploy(self, version: int, bake_seconds: Optional[float] = None,
             bake_traffic: Optional[Sequence[Tuple]] = None) -> dict:
    """Drive one registry version through the full state machine;
    returns the structured verdict (``ok`` True ⇒ promoted, False ⇒
    rolled back + quarantined). ``bake_traffic`` (optional list of
    ``(prompt, budget)``) flows through the fleet during VERIFY so the
    canary-vs-baseline latency comparison has live samples; without it
    the probe prompts are used."""
    params, manifest = self.registry.get(version)   # fingerprint-verified
    self.registry.acquire(version)  # tosa: ignore[TOS007] - refcount, not a lock
    self.candidate_version = version
    canary_rid = None
    prev_factory = self.fleet._factory
    baseline_version = self.current_version
    try:
      # ---- CANARY ----------------------------------------------------------
      self._set_state(CANARY)
      poisoned = self._chaos("canary", version) == "poison"
      canary_params = _poison(params) if poisoned else params
      factory = self.make_engine_factory(canary_params, manifest)
      order = [rid for rid, st in
               sorted(self.fleet.replica_states().items())
               if st != "ejected"]
      if not order:
        raise RuntimeError("no live replica to canary on")
      canary_rid = order[0]
      # pre-canary baseline capture THROUGH the fleet: the outputs a
      # forced rollback must reproduce bit-identically
      baseline_out = [np.asarray(self.fleet.result(
          self.fleet.submit(p, max_new_tokens=b), timeout=120.0))
          for p, b in self.probe_prompts]
      self.fleet.swap_replica(canary_rid, self.swap_timeout,
                              engine_factory=factory, version=version)
      every = max(1, int(round(1.0 / self.traffic_slice)))
      self.fleet.set_canary(canary_rid, every)
      self._count("canaries")
      logger.info("deploy: version %d canarying on replica %d "
                  "(1/%d traffic slice)", version, canary_rid, every)

      # ---- VERIFY ----------------------------------------------------------
      self._set_state(VERIFY)
      self._chaos("verify", version)
      verdict = self._verify(version, params, canary_rid,
                             bake_seconds=bake_seconds,
                             bake_traffic=bake_traffic)
      self.last_verdict = verdict
      if not verdict["ok"]:
        # ---- ROLLBACK ------------------------------------------------------
        self._set_state(ROLLBACK)
        self._chaos("rollback", version)
        self.fleet.clear_canary()
        self.fleet.swap_replica(canary_rid, self.swap_timeout,
                                engine_factory=prev_factory,
                                version=baseline_version)
        self.registry.quarantine(version, verdict)
        self.registry.release(version)        # quarantine is the pin now
        self._count("rollbacks")
        after = [np.asarray(self.fleet.result(
            self.fleet.submit(p, max_new_tokens=b), timeout=120.0))
            for p, b in self.probe_prompts]
        verdict["rollback_bit_identical"] = all(
            a.shape == b.shape and bool((a == b).all())
            for a, b in zip(baseline_out, after))
        self.candidate_version = None
        self._set_state(IDLE)
        logger.warning("deploy: version %d rolled back and quarantined "
                       "(%s)", version, verdict["reason"])
        return verdict

      # ---- PROMOTE ---------------------------------------------------------
      self._set_state(PROMOTE)
      clean_factory = self.make_engine_factory(params, manifest)
      self.fleet.clear_canary()
      for rid, st in sorted(self.fleet.replica_states().items()):
        if st == "ejected" or rid == canary_rid:
          continue
        self._chaos("promote", rid)
        self.fleet.swap_replica(rid, self.swap_timeout,
                                engine_factory=clean_factory,
                                version=version)
      self.fleet._factory = clean_factory   # rebuilds/scale-ups serve v
      if baseline_version is not None:
        self.registry.release(baseline_version)
      self.current_version = version
      self.candidate_version = None
      self._count("promotions")
      self._set_state(IDLE)
      self.registry.gc()
      logger.info("deploy: version %d promoted fleet-wide", version)
      verdict["promoted"] = True
      return verdict
    except ControllerKilled:
      raise                 # the fleet keeps the mix; resume() converges
    except BaseException:
      self.registry.release(version)
      raise

  def _verify(self, version: int, params, canary_rid: int,
              bake_seconds: Optional[float] = None,
              bake_traffic: Optional[Sequence[Tuple]] = None) -> dict:
    """The VERIFY gate: greedy parity spot-checks + obs/SLO deltas over
    the bake window. Pure read-side — it never mutates the fleet."""
    bake = self.bake_seconds if bake_seconds is None else float(bake_seconds)
    base = self.fleet.stats_snapshot()
    t0 = time.monotonic()
    deadline = t0 + bake
    traffic = [(np.asarray(p, np.int32).ravel(), int(b))
               for p, b in (bake_traffic if bake_traffic is not None
                            else self.probe_prompts)]
    canary_ttft: List[float] = []
    baseline_ttft: List[float] = []
    # sampling traffic through the live router until the bake window
    # closes — the canary slice routes ~1/every of it to the candidate,
    # and the timing ledger's model_version stamp partitions the sides
    i = 0
    while True:
      p, b = traffic[i % len(traffic)]
      frid = self.fleet.submit(p, max_new_tokens=b)
      freq = self.fleet.request(frid)
      self.fleet.result(frid, timeout=120.0)
      t = freq.timing()
      if t["ttft"] is not None:
        if t["model_version"] == version:
          canary_ttft.append(t["ttft"])
        else:
          baseline_ttft.append(t["ttft"])
      i += 1
      if time.monotonic() >= deadline and i >= len(traffic):
        break
    # greedy parity spot-checks, submitted straight at the canary engine
    # (the router's slice must not decide whether the gate runs)
    canary_eng = self.fleet._replicas[canary_rid].engine
    checked = mismatches = 0
    for p, b in self.probe_prompts[:max(1, self.spot_checks)]:
      ref = np.asarray(self.reference_decode(params, p, b))
      out = np.asarray(canary_eng.generate([p], max_new_tokens=b,
                                           timeout=120.0)[0])
      checked += 1
      if ref.shape != out.shape or not bool((ref == out).all()):
        mismatches += 1
    if mismatches:
      self._count("parity_failures", mismatches)
    delta = base.delta()
    ratio = None
    if canary_ttft and baseline_ttft:
      ratio = (float(np.median(canary_ttft))
               / max(1e-9, float(np.median(baseline_ttft))))
      if self._obs_g is not None:
        self._obs_g["canary_ttft_ratio"].set(ratio)
    burning = []
    if self.slo_source is not None:
      slo = self.slo_source()
      for obj in (slo or {}).get("objectives", []):
        if obj.get("burning"):
          burning.append(obj.get("name", "?"))
    counters_clean = (delta.get("ejections", 0) == 0
                      and delta.get("shed", 0) == 0
                      and delta.get("replay_mismatches", 0) == 0)
    reasons = []
    if mismatches:
      reasons.append("parity: %d/%d spot-checks diverged"
                     % (mismatches, checked))
    if not counters_clean:
      reasons.append("counters: ejections/shed/replay_mismatches moved "
                     "during the bake (%r)" % (delta,))
    if ratio is not None and ratio > self.ttft_degrade_ratio:
      reasons.append("latency: canary/baseline median TTFT ratio %.2f > "
                     "%.2f" % (ratio, self.ttft_degrade_ratio))
    if burning:
      reasons.append("slo: burning objectives %s" % (burning,))
    return {"version": version, "ok": not reasons,
            "reason": "; ".join(reasons) or None,
            "parity": {"checked": checked, "mismatches": mismatches},
            "counters": delta, "ttft_ratio": ratio,
            "canary_samples": len(canary_ttft),
            "baseline_samples": len(baseline_ttft),
            "slo_burning": burning,
            "bake_s": round(time.monotonic() - t0, 3)}

  # -- recovery --------------------------------------------------------------

  def resume(self, timeout: Optional[float] = None) -> dict:
    """Converge the fleet after a controller death mid-deploy (the chaos
    ``kill`` contract): pick ONE target version — the registry's newest
    non-quarantined version if any replica already serves it (a promote
    in flight finishes), else the pre-canary baseline (an abandoned or
    quarantined candidate is swapped back out) — and zero-shed swap
    every replica that disagrees. Returns ``{"target", "swapped"}``."""
    timeout = self.swap_timeout if timeout is None else float(timeout)
    self._count("resumes")
    self.fleet.clear_canary()
    served = self.fleet.served_versions()
    latest = self.registry.latest()
    if latest is not None and latest in served.values():
      target = latest
    elif self.current_version is not None:
      target = self.current_version
    else:
      target = latest
    if target is None:
      # nothing published and nothing stamped: the fleet is consistent
      # by construction; just clear the in-flight marker
      self.candidate_version = None
      self._set_state(IDLE)
      return {"target": None, "swapped": 0}
    params, manifest = self.registry.get(target)
    factory = self.make_engine_factory(params, manifest)
    swapped = 0
    for rid, ver in sorted(served.items()):
      if ver == target:
        continue
      self.fleet.swap_replica(rid, timeout, engine_factory=factory,
                              version=target)
      swapped += 1
    self.fleet._factory = factory
    if target != self.current_version:
      self.registry.acquire(target)  # tosa: ignore[TOS007] - refcount, not a lock
      if self.current_version is not None:
        self.registry.release(self.current_version)
    if self.candidate_version is not None:
      # drop the in-flight ref deploy() took on the candidate — it is
      # either the target (now pinned as current) or abandoned (GC-able)
      self.registry.release(self.candidate_version)
    self.current_version = target
    self.candidate_version = None
    self._set_state(IDLE)
    logger.info("deploy: resume converged fleet to version %s "
                "(%d replica(s) swapped)", target, swapped)
    return {"target": target, "swapped": swapped}

  # -- the watch loop --------------------------------------------------------

  def poll_once(self, timeout: Optional[float] = None) -> Optional[dict]:
    """One watch step: wait (bounded) for a version newer than both the
    promoted and any quarantined candidate, deploy it, return the
    verdict (None when nothing new arrived)."""
    timeout = self.poll if timeout is None else float(timeout)
    seen = self.current_version or 0
    ver = self.registry.watch(timeout, last_seen=seen, poll=self.poll)
    if ver is None:
      return None
    return self.deploy(ver)

  def start(self) -> "DeploymentController":
    """Run the watch loop in a daemon thread until :meth:`stop`."""
    if self._thread is not None and self._thread.is_alive():
      return self
    self._stop_evt.clear()
    self._thread = threading.Thread(target=self._loop, daemon=True,
                                    name="tos-deploy-controller")
    self._thread.start()
    return self

  def stop(self, timeout: float = 30.0) -> None:
    self._stop_evt.set()
    t = self._thread
    if t is not None:
      t.join(timeout=timeout)

  def _loop(self) -> None:
    while not self._stop_evt.is_set():
      try:
        self.poll_once(timeout=self.poll)
      except ControllerKilled:
        raise          # chaos: the controller thread IS the casualty
      except Exception:  # noqa: BLE001 - the watch loop must outlive
        # one bad deploy (the fleet monitor rule); the failure is
        # visible: rollback counters moved, the verdict is quarantined
        logger.exception("deploy watch pass failed")
        self._stop_evt.wait(self.poll)
