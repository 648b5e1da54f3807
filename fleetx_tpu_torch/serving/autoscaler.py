"""Closed-loop fleet autoscaling for the multi-replica router.

Port of the JAX package's ``serving/autoscaler.py`` (host-only).

The router gives the fleet QoS *within* a fixed replica set; this module
closes the loop on the set itself. :class:`FleetAutoscaler` periodically
reads the same per-replica ``health()`` reports the router's prober
already consumes — ``queue_tokens`` (the prefill backlog priced in
tokens), slot occupancy (``active``/``slots``), lifecycle ``state`` —
averages them over the live rotation, and compares against high/low
watermarks:

- **Scale up** — the average queued-token backlog per live replica has
  sat above ``high_queue_tokens`` (or every slot has been busy) for
  ``up_after`` consecutive evaluations: call ``spawn_fn()`` for a fresh
  engine, *pre-warm* its prefix trie (below), then
  ``router.add_replica(engine)`` so it enters the rotation already warm.
- **Scale down** — the backlog has sat below ``low_queue_tokens`` with
  slots mostly idle for ``down_after`` evaluations and the fleet is
  above ``min_replicas``: pick the least-loaded replica, ask it to
  drain (``request_shutdown(grace_s)``) — the router's prober sees
  ``"draining"`` and rotates it out on its own — and once its in-flight
  work has retired, ``router.remove_replica(index)``.

Hysteresis is deliberate on both sides (consecutive-evaluation counters,
distinct watermarks): a bursty trace must not make the fleet breathe on
every spike.

**Pre-warm.** A fresh replica sharing the fleet's ``DiskPageStore``
starts with a cold device trie but a warm persistent tier. Before the
new engine takes traffic the autoscaler replays the router's hottest
observed prompt prefixes (``router.hot_prefixes()``) through
``engine.prewarm()``, which revives the longest persisted prefix of
each into the device trie and parks it zero-ref-warm — so the replica's
first real request prefix-hits instead of re-prefilling from scratch.

Knobs (constructor args override the ``FLEETX_AUTOSCALE_*`` envs):
``min_replicas``/``max_replicas``, ``high_queue_tokens``/
``low_queue_tokens``, ``eval_every`` (router ticks between
evaluations), ``up_after``/``down_after`` (hysteresis), ``prewarm``,
``grace_s`` (drain grace forwarded to ``request_shutdown``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from fleetx_tpu_torch.obs.events import emit as obs_emit
from fleetx_tpu_torch.serving.engine import _env_float, _env_int
from fleetx_tpu_torch.serving.router import ReplicaState, ServingRouter
from fleetx_tpu_torch.utils.log import logger

__all__ = ["FleetAutoscaler"]


class FleetAutoscaler:
    """Watch a :class:`ServingRouter`'s replica health and grow/shrink
    the fleet through a ``spawn_fn`` seam (module docstring)."""

    def __init__(self, router: ServingRouter,
                 spawn_fn: Callable[[], object], *,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 high_queue_tokens: Optional[float] = None,
                 low_queue_tokens: Optional[float] = None,
                 eval_every: Optional[int] = None,
                 up_after: Optional[int] = None,
                 down_after: Optional[int] = None,
                 prewarm: Optional[bool] = None,
                 grace_s: Optional[float] = None):
        self.router = router
        self.spawn_fn = spawn_fn
        self.min_replicas = max(1, (
            min_replicas if min_replicas is not None
            else _env_int("FLEETX_AUTOSCALE_MIN", 1)))
        self.max_replicas = max(self.min_replicas, (
            max_replicas if max_replicas is not None
            else _env_int("FLEETX_AUTOSCALE_MAX", 8)))
        self.high_queue_tokens = (
            high_queue_tokens if high_queue_tokens is not None
            else _env_float("FLEETX_AUTOSCALE_HIGH_QT", 512.0))
        self.low_queue_tokens = (
            low_queue_tokens if low_queue_tokens is not None
            else _env_float("FLEETX_AUTOSCALE_LOW_QT", 16.0))
        self.eval_every = max(1, (
            eval_every if eval_every is not None
            else _env_int("FLEETX_AUTOSCALE_EVERY", 8)))
        self.up_after = max(1, (
            up_after if up_after is not None
            else _env_int("FLEETX_AUTOSCALE_UP_AFTER", 2)))
        self.down_after = max(1, (
            down_after if down_after is not None
            else _env_int("FLEETX_AUTOSCALE_DOWN_AFTER", 4)))
        self.prewarm = (prewarm if prewarm is not None
                        else _env_int("FLEETX_AUTOSCALE_PREWARM", 1) == 1)
        self.grace_s = (grace_s if grace_s is not None
                        else _env_float("FLEETX_AUTOSCALE_GRACE_S", 30.0))
        self._ticks = 0
        self._high_streak = 0
        self._low_streak = 0
        self._draining: List[int] = []  # replica indices we asked to drain
        self.scale_ups = 0
        self.scale_downs = 0

    # ------------------------------------------------------------- evaluate

    def step(self) -> Optional[str]:
        """Call once per router tick. Every ``eval_every`` ticks the
        fleet is evaluated; returns ``"up"``/``"down"`` when an action
        was taken this call, else None."""
        self._ticks += 1
        self._finish_drains()
        if self._ticks % self.eval_every:
            return None
        live = [r for r in self.router._replicas
                if r.state == ReplicaState.OK
                and r.index not in self._draining]
        if not live:
            return None  # a lost fleet is the operator's page, not ours
        qt = slots = busy = 0
        for rep in live:
            try:
                h = rep.engine.health()
            except Exception:  # noqa: BLE001 — prober owns fault handling
                continue
            qt += float(h.get("queue_tokens", 0) or 0)
            slots += int(h.get("slots", 0) or 0)
            busy += int(h.get("active", 0) or 0)
        backlog = qt / len(live)
        saturated = slots > 0 and busy >= slots
        if backlog > self.high_queue_tokens or saturated:
            self._high_streak += 1
            self._low_streak = 0
        elif backlog < self.low_queue_tokens and (
                slots == 0 or busy * 2 <= slots):
            self._low_streak += 1
            self._high_streak = 0
        else:
            self._high_streak = self._low_streak = 0
        if (self._high_streak >= self.up_after
                and len(live) < self.max_replicas):
            self._high_streak = 0
            return self._scale_up(backlog)
        if (self._low_streak >= self.down_after
                and len(live) > self.min_replicas):
            self._low_streak = 0
            return self._scale_down(live, backlog)
        return None

    # --------------------------------------------------------------- actions

    def _scale_up(self, backlog: float) -> Optional[str]:
        engine = self.spawn_fn()
        if engine is None:
            return None  # launcher could not provide capacity
        warmed = 0
        if self.prewarm and hasattr(engine, "prewarm"):
            for prefix in self.router.hot_prefixes():
                try:
                    warmed += int(engine.prewarm(prefix))
                except Exception as e:  # noqa: BLE001 — warm is best-effort
                    logger.warning("autoscaler: prewarm failed: %s", e)
                    break
        index = self.router.add_replica(engine)
        self.scale_ups += 1
        obs_emit("autoscale_up", replica=index, backlog=round(backlog, 1),
                 prewarmed_tokens=warmed)
        logger.info(
            "autoscaler: scale-up -> replica %d (backlog %.0f tokens/"
            "replica, %d prefix tokens pre-warmed)", index, backlog, warmed)
        return "up"

    def _scale_down(self, live, backlog: float) -> Optional[str]:
        # least-loaded OK replica drains; the router's prober rotates it
        # out the moment health() says "draining"
        victim = min(live, key=lambda r: len(r.dispatched))
        try:
            victim.engine.request_shutdown(self.grace_s)
        except Exception as e:  # noqa: BLE001
            logger.warning("autoscaler: drain request failed: %s", e)
            return None
        self._draining.append(victim.index)
        self.scale_downs += 1
        obs_emit("autoscale_down", replica=victim.index,
                 backlog=round(backlog, 1))
        logger.info(
            "autoscaler: scale-down -> draining replica %d (backlog "
            "%.0f tokens/replica)", victim.index, backlog)
        return "down"

    def _finish_drains(self) -> None:
        """Retire drained replicas: once a replica we asked to drain has
        no dispatched work left and is out of the OK rotation, remove it
        from the router for good."""
        still: List[int] = []
        for idx in self._draining:
            if self.router.remove_replica(idx):
                continue
            still.append(idx)
        self._draining = still

    # --------------------------------------------------------- introspection

    def snapshot(self) -> Dict:
        """Counters + watermarks for bench/debug output."""
        return {
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "draining": list(self._draining),
            "high_queue_tokens": self.high_queue_tokens,
            "low_queue_tokens": self.low_queue_tokens,
        }
