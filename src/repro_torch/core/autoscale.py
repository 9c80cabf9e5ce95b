"""Cost-ledger-driven fleet autoscaling — replicas as a runtime control loop.

The paper's economics ("pay only for queries actually served") and its tail
story (replicated partitions + hedged scatter legs) pull in opposite
directions when the replica count is a BUILD-TIME constant: an
over-provisioned fleet pays a keep-warm/hedge tax through every quiet hour,
a cold-heavy one re-buys the p99 blowups hedging exists to fix. The
:class:`FleetController` turns that $/1k-queries vs. p99 operating point
into feedback: on a virtual-clock tick it reads, per replica group,

* recent WARM latency quantiles (``FaaSRuntime.latency_percentiles`` over
  the group — the same baseline the :class:`~repro_torch.core.partition.HedgePolicy`
  hedges against),
* queue-wait/cold-boot projections (``FaaSRuntime.probe``, no fleet
  mutation), and
* the :class:`~repro_torch.core.cost.CostLedger`'s hedge/idle attribution — what
  tail mitigation and standby capacity actually cost since the last tick,

then steers the group toward a PER-GROUP replica target — real traffic is
Zipf-skewed, and the serverless bet (pay only for what runs) only pays off
when a hot head partition can hold R=3 while its cold siblings drain to
R=1 under the same fleet-wide traffic. Capacity moves **up** by
registering a fresh ``search-p{p}rN`` function over the partition's
already-published segment (one ``AssetCatalog`` entry, N pools — the
replication invariant; nothing is re-published) and prewarming its pool; **down** by
draining the newest replica through ``FaaSRuntime.retire`` so in-flight
work finishes and the keep-alive pings that made it cost money stop.

Keep-alive is the controller's second job: a pool the provider would reap
before its next use gets a ping, billed to the ledger's IDLE line — which
is exactly the spend a scale-down decision needs to see. Ticks piggyback
on request arrivals — the gateway coordinator calls :meth:`maybe_tick`
AFTER dispatch, never before: a pre-dispatch ping races the request it
rides in on for the pool's single idle instance and causes the very cold
start it exists to prevent — and additionally fire when the kill log grows
(the analogue of a spot/instance-termination notice, so routing and
capacity react to a killed pool before the next full period). Long quiet
stretches need an out-of-band timer driving :meth:`maybe_tick` as well
(B10 does this), or pools expire between sparse arrivals.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

from repro_torch.core.partition import ScatterGather
from repro_torch.core.runtime import FaaSRuntime, Handler


@dataclasses.dataclass
class AutoscalePolicy:
    """Knobs for one controller. Defaults are deliberately conservative:
    scale up eagerly on tail pressure (a cold start costs ~10× a warm
    query), scale down only after ``idle_ticks_to_retire`` consecutive
    quiet ticks (hysteresis — a diurnal lull should retire standby pools,
    a two-query gap should not).

    Replica bounds may be ONE int pair (every partition shares them) or a
    per-partition sequence — a fleet whose partitions are known a priori to
    be heterogeneous (a Zipf-hot head partition, a cold tail) can bound
    each group separately, and the controller's per-group targets do the
    rest at runtime."""

    min_replicas: "int | Sequence[int]" = 1
    max_replicas: "int | Sequence[int]" = 3
    tick_s: float = 1.0                 # control period (virtual seconds)
    rate_window_s: float = 2.0          # trailing window for arrival rate
    # demand thresholds are INVOCATIONS/s per replica (a micro-batch
    # occupies an instance once, so it counts once): scale up above
    # up_qps_per_replica, count an idle tick below down_qps_per_replica
    up_qps_per_replica: float = 10.0
    down_qps_per_replica: float = 1.0
    idle_ticks_to_retire: int = 2       # ...for this many consecutive ticks
    # up-scale hysteresis: how many CONSECUTIVE pressured ticks before a
    # scale-up lands. 1 (default) reacts within one control period — right
    # when pressure means kills or burst onset. Raise it for fleets whose
    # pressure has known sub-tick transients (a generation rollover's
    # hydration stall congests every pool for ~2 ticks; scaling up buys
    # pools that would themselves hydrate) so only PERSISTENT pressure
    # grows the fleet.
    up_ticks_to_scale: int = 1
    up_overhead_s: float | None = None  # queue/cold projection trigger;
    #                                     None → max(provision/2, 2× warm p50)
    # The MEASURED cold overhead (provision + first-query hydration) the
    # projection floor derives from. The runtime's ``provision_s`` alone
    # under-states an eager-hydration fleet's cold cost (~0.47 s vs the
    # 0.15 s boot) and over-states a lazy-hydration one's (~0.2 s) — B13
    # measures both profiles; feed its number here so the scale-up trigger
    # prices cold starts the fleet will ACTUALLY pay. None keeps the
    # provision_s/2 floor (bit-identical pre-existing behaviour).
    cold_overhead_s: float | None = None
    # Little's-law capacity target per group: replicas chase
    # ceil(arrival_rate × warm_p50 / target_utilization), the rule that
    # makes a fleet HETEROGENEOUS under skew — a partition whose vmapped
    # eval runs 7× longer (7× the documents) needs 7× the pool-seconds at
    # the same invocation rate, which no shared invocations/s threshold
    # can express. None disables (the escalation triggers only).
    target_utilization: float | None = 0.6
    # Execution-model scale applied to the warm p50 the concurrency rule
    # reads — one float for the fleet, or a per-partition sequence. A
    # PRUNED fleet's observable service time carries the dense-path
    # constant (the modeled clock charges ``sim_exec_s`` calibrated
    # against the dense pass; a measured clock still includes the dense
    # top-k scan), but the work its kernel actually sustains at saturation
    # is linear in blocks TOUCHED — B9b measures that fraction directly
    # (the gated ``b9b_pruned_blocks_touched_frac_*`` rows, ~0.02 under
    # tight single-term bounds). Feed the measured fraction here and
    # Little's law prices warm service time as frac × p50, so a pruned
    # fleet stops buying ~50× the pools its own arithmetic needs — and the
    # over-provisioned drain rule shrinks one that already did. 1.0
    # (default) keeps every pre-existing decision bit-identical.
    exec_scale: "float | Sequence[float]" = 1.0
    # newest-N warm records behind every quantile the controller reads —
    # the SAME window HedgePolicy scans, so scaling and hedging judge one
    # latency regime (unwindowed, a long-running fleet would hedge on
    # recent behaviour while scaling on stale history)
    warm_window: int = 256
    keepalive: bool = True              # ping pools the provider would reap
    keepalive_margin_s: float | None = None  # ping when expiry < margin;
    #                                     None → idle_timeout / 2
    prewarm: bool = True                # ping a just-registered replica


@dataclasses.dataclass
class _GroupState:
    base: str                 # the partition's base function name (group[0])
    next_replica: int         # suffix for the next registered replica
    idle_ticks: int = 0
    over_ticks: int = 0       # consecutive ticks above the concurrency target
    up_ticks: int = 0         # consecutive ticks WITH up-pressure (hysteresis)
    last_target: int = 0      # the target the last tick computed (introspection)


class FleetController:
    """The feedback loop between one runtime's ledger and one scatter's
    replica groups.

    ``handler_factories[p]()`` must build a fresh handler serving partition
    ``p``'s published segment — the controller never touches the object
    store, so a scale-up is registration + prewarm, never a re-publish.
    ``ping_payload`` is the no-op request keep-alive and prewarm pings
    carry (e.g. ``{"q": "", "k": 1, "fetch_docs": False}``).
    """

    def __init__(self, runtime: FaaSRuntime, scatter: ScatterGather,
                 handler_factories: Sequence[Callable[[], Handler]],
                 policy: AutoscalePolicy | None = None, *,
                 ping_payload: Any = None) -> None:
        if len(handler_factories) != len(scatter.groups):
            raise ValueError(
                f"{len(handler_factories)} handler factories for "
                f"{len(scatter.groups)} replica groups")
        self.runtime = runtime
        self.scatter = scatter
        self.factories = list(handler_factories)
        self.policy = policy if policy is not None else AutoscalePolicy()
        self.ping_payload = ping_payload if ping_payload is not None else {}
        for bound in (self.policy.min_replicas, self.policy.max_replicas):
            if (not isinstance(bound, int)
                    and len(bound) != len(scatter.groups)):
                raise ValueError(
                    f"per-partition replica bounds need one entry per group: "
                    f"{len(bound)} bounds for {len(scatter.groups)} groups")
        scale = self.policy.exec_scale
        if (not isinstance(scale, (int, float))
                and len(scale) != len(scatter.groups)):
            raise ValueError(
                f"per-partition exec_scale needs one entry per group: "
                f"{len(scale)} entries for {len(scatter.groups)} groups")
        self.groups = [_GroupState(base=g[0], next_replica=len(g),
                                   last_target=len(g))
                       for g in scatter.groups]
        self.events: list[dict] = []     # scale_up / retire, with reasons
        self.pings = 0
        # admission sheds the gateway reported (Gateway.route_batched's
        # on_shed hook): refused demand never reaches a pool, so none of
        # the record-derived signals can see it — without this counter a
        # fleet in deep overload looks QUIET to the controller (sheds
        # suppress arrivals) and would never buy the capacity that ends
        # the shedding
        self.sheds_seen = 0              # cumulative (introspection)
        self._sheds = 0                  # since the last tick (the signal)
        self._last_tick = -math.inf
        self._rec_ptr = 0                # window start into runtime.records
        self._kill_ptr = 0               # interrupt: unseen kill_log entries
        self._last_spend = dict(self.runtime.ledger.attribution())

    # -- the loop entry points -------------------------------------------------

    def maybe_tick(self, now: float | None = None) -> bool:
        """Tick if a full period elapsed OR the kill log grew (termination
        notices shouldn't wait out the period). Called by the gateway
        coordinator at every request arrival AFTER dispatch (pre-dispatch
        keep-alive pings would race the request for the pool's idle
        instance), and by any out-of-band timer the deployment runs."""
        t = self.runtime.clock if now is None else now
        if (t - self._last_tick >= self.policy.tick_s
                or len(self.runtime.kill_log) > self._kill_ptr):
            self.tick(t)
            return True
        return False

    def note_shed(self, t: float) -> None:
        """One admission-shed arrival (gateway backpressure). Counted as
        scale-up pressure at the next tick — the only demand signal a shed
        leaves, since the request is refused before any invocation."""
        self.sheds_seen += 1
        self._sheds += 1

    def tick(self, now: float | None = None) -> None:
        t = self.runtime.clock if now is None else now
        pol = self.policy
        window = [r for r in self.runtime.records[self._rec_ptr:]
                  if not r.keepalive]
        self._rec_ptr = len(self.runtime.records)
        self._kill_ptr = len(self.runtime.kill_log)
        self._last_tick = t
        # what the fleet spent since the last look: hedge tax (tail
        # mitigation that fired) and idle tax (standby pools kept warm)
        spend = self.runtime.ledger.attribution()
        spend_delta = {k: spend[k] - self._last_spend.get(k, 0.0)
                       for k in spend}
        self._last_spend = spend

        sheds, self._sheds = self._sheds, 0
        for p, group in enumerate(self.scatter.groups):
            self._control_group(p, group, window, spend_delta, t,
                                sheds=sheds)
        if pol.keepalive:
            self._keepalive(t)

    # -- per-group control ----------------------------------------------------

    def _group_rate(self, group: list[str], now: float) -> float:
        """Arrival rate (INVOCATIONS/s) over the trailing rate window. An
        invocation is the capacity-consuming unit — a micro-batch occupies
        an instance once however many queries it carries — so the policy's
        qps thresholds are per-invocation, and batched traffic reads as its
        invocation rate, not its (higher) logical-query rate."""
        names = set(group)
        cutoff = now - self.policy.rate_window_s
        n = 0
        for r in reversed(self.runtime.records):
            if r.t_arrival < cutoff:
                break
            if r.fn in names and not r.keepalive:
                n += 1
        return n / self.policy.rate_window_s

    def _bounds(self, p: int) -> tuple[int, int]:
        """(min, max) replicas for partition ``p`` — shared ints or the
        per-partition entries of a heterogeneous bounds sequence."""
        pol = self.policy
        lo = (pol.min_replicas if isinstance(pol.min_replicas, int)
              else pol.min_replicas[p])
        hi = (pol.max_replicas if isinstance(pol.max_replicas, int)
              else pol.max_replicas[p])
        return lo, max(lo, hi)

    def _exec_scale(self, p: int) -> float:
        """Partition ``p``'s execution-model scale — the measured
        work-per-observed-second ratio (e.g. B9b's blocks-touched fraction
        on a pruned fleet) the concurrency rule multiplies into warm p50."""
        scale = self.policy.exec_scale
        return float(scale if isinstance(scale, (int, float)) else scale[p])

    def _overhead_threshold(self, group: list[str]) -> float:
        if self.policy.up_overhead_s is not None:
            return self.policy.up_overhead_s
        wp50 = self.runtime.latency_percentiles(
            group, qs=(0.5,), warm_only=True,
            window=self.policy.warm_window)[0.5]
        cold = (self.policy.cold_overhead_s
                if self.policy.cold_overhead_s is not None
                else self.runtime.config.provision_s)
        floor = cold / 2
        return floor if math.isnan(wp50) else max(floor, 2.0 * wp50)

    def _control_group(self, p: int, group: list[str], window: list,
                       spend_delta: dict, now: float, *,
                       sheds: int = 0) -> None:
        """Steer partition ``p``'s group toward ITS OWN replica target.

        Every signal here is per-group — this group's trailing arrival
        share, this group's warm quantiles (windowed to the current
        latency regime), this group's hedge/cold pressure — so a
        Zipf-hot partition holds R=3 while its cold siblings drain to
        R=1 under the same fleet-wide traffic. The escalation triggers
        (demand/hedge/tail/projection) step capacity by one;
        the Little's-law concurrency rule may target several steps at
        once, and the controller walks the whole gap in one tick (a
        saturated head partition should not wait N control periods for
        capacity the math already justifies)."""
        pol, st = self.policy, self.groups[p]
        lo, hi = self._bounds(p)
        names = set(group)
        grp = [r for r in window if r.fn in names]
        # capacity pressure counts FRESH container boots only: a
        # hydration-only cold (warm pool, new index generation after a
        # commit) is content turnover every pool pays once per generation —
        # more pools would mean MORE hydrations, not fewer
        colds = sum(r.provisioned for r in grp)
        hedges = sum(r.hedged for r in grp)
        rate = self._group_rate(group, now)
        # project one tick AHEAD: at the tick instant itself the request
        # just dispatched still occupies its instance, and a pool serving
        # exactly one in-flight query would look like a cold start to a
        # same-instant probe. Queue pressure that persists a tick out is
        # the real signal.
        horizon = now + self.policy.tick_s
        best_overhead = min(
            (sum(self.runtime.probe(f, horizon)) for f in group), default=0.0)

        # tail pressure only justifies capacity when there is actually
        # traffic: a once-an-hour query on a fleet whose pools expire
        # between arrivals is cold BECAUSE it's idle — adding a second
        # cold pool would burn a rehydration per burst-that-never-comes
        # and the cold-in-window signal would block every retire
        active = rate >= pol.down_qps_per_replica
        target, up_reason = len(group), None
        if rate / len(group) > pol.up_qps_per_replica:
            target = len(group) + 1
            up_reason = f"demand: {rate:.1f} q/s over {len(group)} pool(s)"
        elif sheds:
            # NOT gated on `active`: shed arrivals never become records,
            # so deep overload reads as a LOW arrival rate here — the shed
            # count is the only trace the refused demand leaves
            target = len(group) + 1
            up_reason = f"backpressure: {sheds} shed arrival(s) since last tick"
        elif active and hedges:
            target = len(group) + 1
            up_reason = (f"hedge tax: {hedges} backup leg(s), "
                         f"${spend_delta.get('hedge', 0.0):.6f} since last tick")
        elif active and colds:
            target = len(group) + 1
            up_reason = f"tail: {colds} cold boot(s) in window"
        elif active and best_overhead > self._overhead_threshold(group):
            target = len(group) + 1
            up_reason = f"projection: {best_overhead * 1e3:.0f} ms queued/cold"

        # the heterogeneous-fleet rule: offered concurrency (Little's law,
        # arrival rate × warm service time) over the utilization target is
        # how many pools THIS group's load needs — a head partition whose
        # eval runs 7× longer demands 7× the capacity at the same
        # invocation rate, invisible to any shared invocations/s threshold
        need = None
        if active and pol.target_utilization:
            wp50 = self.runtime.latency_percentiles(
                group, qs=(0.5,), warm_only=True,
                window=pol.warm_window)[0.5]
            if not math.isnan(wp50):
                # the exec model: observed p50 × this partition's measured
                # work fraction (B9b's blocks-touched frac on pruned
                # fleets; 1.0 = the observed time IS the work)
                svc = wp50 * self._exec_scale(p)
                need = math.ceil(rate * svc / pol.target_utilization)
                if need > target:
                    target = need
                    up_reason = (
                        f"concurrency: {rate:.1f} inv/s × {svc * 1e3:.0f} ms "
                        f"modeled warm p50 ÷ {pol.target_utilization:g} util "
                        f"→ {need} pool(s)")

        target = min(target, hi)
        st.last_target = max(target, min(len(group), hi))
        if target > len(group):
            st.idle_ticks = st.over_ticks = 0
            st.up_ticks += 1
            if st.up_ticks < pol.up_ticks_to_scale:
                return                  # pressure must persist before it buys pools
            while len(self.scatter.groups[p]) < target:
                self._scale_up(p, st, now, up_reason)
            st.up_ticks = 0
            return
        st.up_ticks = 0
        if up_reason is not None:
            st.idle_ticks = st.over_ticks = 0   # pressure at the cap ≠ idleness
            return

        if (len(group) > lo
                and rate / len(group) < pol.down_qps_per_replica):
            st.over_ticks = 0
            st.idle_ticks += 1
            if st.idle_ticks >= pol.idle_ticks_to_retire:
                self._retire(p, group, st, now,
                             f"idle: {rate:.2f} q/s, no hedges, idle tax "
                             f"${spend_delta.get('idle', 0.0):.6f} since last tick")
                st.idle_ticks = 0
        elif need is not None and need < len(group) > lo:
            # OVER-provisioned under live traffic: a transient (one commit's
            # concurrency spike, a one-off cold) grew the group past what
            # its own concurrency math justifies, and the idle rule will
            # never fire while traffic flows. Converge DOWN to the target
            # with the same hysteresis scale-down uses — so a tail
            # partition that briefly ballooned drains back to R=1 while a
            # head partition whose demand is real keeps its pools (its
            # up-pressure resets the counter every tick).
            st.idle_ticks = 0
            st.over_ticks += 1
            if st.over_ticks >= pol.idle_ticks_to_retire:
                self._retire(p, group, st, now,
                             f"over-provisioned: {rate:.1f} inv/s needs "
                             f"{need} pool(s), running {len(group)}")
                st.over_ticks = 0
        else:
            st.idle_ticks = st.over_ticks = 0

    def _scale_up(self, p: int, st: _GroupState, now: float,
                  reason: str) -> None:
        fn = f"{st.base}r{st.next_replica}"
        st.next_replica += 1
        self.runtime.register(fn, self.factories[p]())
        self.scatter.add_replica(p, fn)
        if self.policy.prewarm:
            self.runtime.invoke(fn, self.ping_payload, t_arrival=now,
                                keepalive=True)
            self.pings += 1
        self.events.append({"t": now, "partition": p, "action": "scale_up",
                            "fn": fn, "reason": reason,
                            "replicas": len(self.scatter.groups[p])})

    def _retire(self, p: int, group: list[str], st: _GroupState,
                now: float, reason: str) -> None:
        fn = group[-1]                  # newest replica; base never leaves
        self.scatter.remove_replica(p, fn)
        self.runtime.retire(fn, t=now)
        self.events.append({"t": now, "partition": p, "action": "retire",
                            "fn": fn, "reason": reason,
                            "replicas": len(self.scatter.groups[p])})

    # -- keep-warm ------------------------------------------------------------

    def _keepalive(self, now: float) -> None:
        """Ping every pool the provider would reap before we'd plausibly
        touch it again. Pools fed by live traffic never need it; standby
        replicas are pinged roughly every margin-worth of quiet — the idle
        spend this books is precisely the standing cost a retire decision
        weighs against the hedge tax the replica saves."""
        margin = self.policy.keepalive_margin_s
        if margin is None:
            margin = self.runtime.config.idle_timeout_s / 2
        for group in self.scatter.groups:
            for fn in group:
                # a pool with in-flight work is being kept warm by its own
                # traffic — pinging it would race the live request for the
                # idle instance and force a cold start (see pool_busy)
                if self.runtime.pool_busy(fn, now):
                    continue
                expiry = self.runtime.pool_expiry_s(fn, now)
                if expiry is None or expiry < margin:
                    self.runtime.invoke(fn, self.ping_payload,
                                        t_arrival=now, keepalive=True)
                    self.pings += 1

    # -- introspection --------------------------------------------------------

    def replica_counts(self) -> list[int]:
        return [len(g) for g in self.scatter.groups]

    def replica_targets(self) -> list[int]:
        """Per-group targets from the last tick — the heterogeneous shape
        the controller is steering toward (counts converge to targets as
        scale-ups land and idle hysteresis drains)."""
        return [st.last_target for st in self.groups]

    def stats(self) -> dict:
        led = self.runtime.ledger
        return {
            "replica_counts": self.replica_counts(),
            "replica_targets": self.replica_targets(),
            "scale_ups": sum(e["action"] == "scale_up" for e in self.events),
            "retires": sum(e["action"] == "retire" for e in self.events),
            "pings": self.pings,
            "sheds_seen": self.sheds_seen,
            "spend": led.attribution(),
        }
