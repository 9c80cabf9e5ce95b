"""FaaS runtime simulator — the Lambda execution substrate of the paper.

Models what AWS does "behind the scenes" (§2): provisioning containers,
scaling the fleet up/down with load, load-balancing, and the cold/warm
distinction. One request occupies one instance for its duration (Lambda's
concurrency = instance model); a request that finds no idle instance forces a
*cold start*: container provision + asset hydration, both charged to that
request's latency.

The simulator runs on a virtual clock (simulated seconds) so behaviour is
deterministic and fast; actual compute time for a request is supplied by the
handler (measured wall time of the jitted scoring fn, or a model).

Fault tolerance: instances can be killed (failure injection); in-flight
requests are retried on another instance. Straggler mitigation: requests
whose execution exceeds ``hedge_after_s`` are duplicated ("backup requests",
Dean's tail-at-scale trick) and the earlier completion wins.
"""

from __future__ import annotations

import dataclasses
import itertools
import random
from typing import Any, Callable

from repro_torch.core.cache import HydrationCache
from repro_torch.core.cost import CostLedger, Invocation


class RuntimeError_(Exception):
    pass


class RetriesExhausted(RuntimeError_):
    """A function's client-side retries ran out: every attempt landed on an
    instance that died before the handler ran. Subclasses ``RuntimeError_``
    so pre-existing broad handlers still catch it, but carries enough for a
    gateway to map it to a typed 503 instead of a generic 502."""

    def __init__(self, fn: str, attempts: int) -> None:
        super().__init__(f"{fn}: instance died {attempts} times")
        self.fn = fn
        self.attempts = attempts


# A handler receives (instance_cache, payload) and returns
# (result, exec_seconds). exec_seconds is the simulated compute time for the
# request *excluding* hydration (the cache accounts hydration separately).
Handler = Callable[[HydrationCache, Any], tuple[Any, float]]


def nearest_rank_percentiles(lats, qs=(0.5, 0.9, 0.99)) -> dict[float, float]:
    """Nearest-rank quantiles over an (unsorted) latency list; NaN when
    empty. The ONE quantile convention for the runtime, the gateway, and
    the benchmarks — so their p99s agree on the same run."""
    lats = sorted(lats)
    if not lats:
        return {q: float("nan") for q in qs}
    return {q: lats[min(len(lats) - 1, int(q * len(lats)))] for q in qs}


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded client-side retries for instance death.

    ``max_attempts`` counts TOTAL tries (first attempt included); backoff
    before retry *n* is ``base_backoff_s * multiplier**(n-1)`` capped at
    ``max_backoff_s``, stretched by up to ``jitter`` (a fraction, drawn from
    the runtime's seeded RNG so a retry schedule is reproducible per seed).
    The zero-backoff default reproduces the historical immediate-retry
    behaviour exactly — including the RNG draw sequence, since jitter only
    consumes a draw when both jitter and the backoff are nonzero."""

    max_attempts: int = 3
    base_backoff_s: float = 0.0
    multiplier: float = 2.0
    max_backoff_s: float = 2.0
    jitter: float = 0.0

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.base_backoff_s < 0 or self.max_backoff_s < 0:
            raise ValueError("backoff seconds must be >= 0")
        if self.multiplier < 1.0:
            raise ValueError("multiplier must be >= 1")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")

    def backoff_s(self, attempt: int, rng) -> float:
        """Virtual-clock delay before retry ``attempt`` (1-based)."""
        delay = min(self.base_backoff_s * self.multiplier ** (attempt - 1),
                    self.max_backoff_s)
        if delay > 0.0 and self.jitter > 0.0:
            delay *= 1.0 + self.jitter * rng.random()
        return delay


@dataclasses.dataclass
class RuntimeConfig:
    memory_bytes: int = 2 << 30          # the paper's "generous 2GB instance"
    provision_s: float = 0.150           # container cold-boot (JVM/runtime init)
    idle_timeout_s: float = 600.0        # AWS reaps idle containers ~5-15 min
    max_instances: int = 1000            # account concurrency limit
    hedge_after_s: float | None = None   # straggler mitigation threshold
    failure_rate: float = 0.0            # per-invocation instance-death prob
    max_retries: int = 2                 # legacy knob; ignored when retry set
    retry: RetryPolicy | None = None     # None -> immediate retries, bounded
                                         # by max_retries (legacy behaviour)
    seed: int = 0

    def retry_policy(self) -> RetryPolicy:
        if self.retry is not None:
            return self.retry
        return RetryPolicy(max_attempts=self.max_retries + 1)


@dataclasses.dataclass
class InvocationRecord:
    fn: str
    t_arrival: float
    t_done: float
    latency_s: float
    exec_s: float
    hydrate_s: float
    cold: bool
    # cold splits two ways: ``provisioned`` means a FRESH container booted
    # for this request (capacity shortfall — more standby pools would have
    # absorbed it), while a hydration-only cold (warm container, new index
    # generation) is content turnover that every pool pays exactly once per
    # generation — adding pools ADDS hydrations, so a scaling policy must
    # not read it as load pressure
    provisioned: bool
    instance_id: int
    retries: int = 0
    hedged: bool = False
    # cross-replica hedging (invoke_hedged): the losing leg's function and
    # the latency the caller would have eaten without the backup
    backup_fn: str | None = None
    loser_latency_s: float = 0.0
    # keep-alive ping (standby-capacity maintenance, not a query): excluded
    # from latency percentiles and hedge-policy history, billed as idle
    keepalive: bool = False
    # indexing work (delta pack / merge): billed to the ledger's write line
    write: bool = False
    # partial → full lazy-hydration upgrade run after the response was
    # computed: billed to the ledger's backfill line, EXCLUDED from
    # latency_s/hydrate_s (it extends instance busy time, not the caller's
    # wait) — hedging/autoscaling thus see the PARTIAL cold cost
    backfill_s: float = 0.0

    @property
    def overhead_s(self) -> float:
        return self.latency_s - self.exec_s


class Instance:
    _ids = itertools.count()

    def __init__(self, memory_bytes: int, now: float, fn: str = "") -> None:
        self.id = next(Instance._ids)
        self.fn = fn                  # Lambda pins environments per function
        self.cache = HydrationCache(memory_bytes)
        self.busy_until = now
        self.last_used = now
        self.born = now
        self.invocations = 0
        self.alive = True

    def is_warm_for(self, asset_key: tuple[str, str]) -> bool:
        return asset_key in self.cache


class FaaSRuntime:
    """The fleet. ``invoke`` is the Lambda entry point."""

    def __init__(self, config: RuntimeConfig | None = None) -> None:
        self.config = config if config is not None else RuntimeConfig()
        self._handlers: dict[str, Handler] = {}
        self._instances: list[Instance] = []
        self._rng = random.Random(self.config.seed)
        self.ledger = CostLedger()
        self.records: list[InvocationRecord] = []
        self.clock = 0.0
        self._retired: dict[str, float] = {}        # fn -> retirement time
        self.kill_log: list[tuple[float, str]] = []  # (time, fn) per kill

    # -- registration ---------------------------------------------------------

    def register(self, fn_name: str, handler: Handler) -> None:
        self._handlers[fn_name] = handler
        self._retired.pop(fn_name, None)   # re-registering reinstates

    def registered(self, fn_name: str) -> bool:
        return fn_name in self._handlers and fn_name not in self._retired

    def retire(self, fn_name: str, *, t: float | None = None) -> None:
        """Stop routing to ``fn_name`` and drain its pool.

        Retirement is the scale-down half of fleet control: no NEW
        invocation may land on a retired function (``invoke`` raises), its
        idle instances are reclaimed immediately, and busy ones finish
        their in-flight request — win or lose a hedge race, FaaS can't
        cancel — then evaporate on the next fleet sweep. The published
        segment is untouched: retiring ``search-p0r2`` removes one instance
        pool over the asset, never the asset itself."""
        if fn_name not in self._handlers:
            raise RuntimeError_(f"no function {fn_name!r} registered")
        now = self.clock if t is None else max(t, 0.0)
        self._retired[fn_name] = now
        self._instances = [
            i for i in self._instances
            if not (i.fn == fn_name and i.busy_until <= now)]

    # -- fleet management (what AWS does behind the scenes) --------------------

    def _reap_idle(self, now: float) -> None:
        cfg = self.config
        self._instances = [
            i for i in self._instances
            if i.alive and (now - i.last_used) <= cfg.idle_timeout_s
            and not (i.fn in self._retired and i.busy_until <= now)
        ]

    def _acquire(self, now: float, fn: str = "") -> tuple[Instance, bool]:
        """Find an idle warm instance FOR THIS FUNCTION, else provision.

        Lambda execution environments are per-function: an instance that
        booted for function A is never handed a request for function B (a
        partitioned fleet would otherwise thrash each other's hydration
        caches). Within a function's pool, prefer the most-recently-used
        idle instance (AWS's observed bin-packing; maximizes warmth)."""
        self._reap_idle(now)
        idle = [i for i in self._instances
                if i.busy_until <= now and i.fn == fn]
        if idle:
            inst = max(idle, key=lambda i: i.last_used)
            return inst, False
        if len(self._instances) >= self.config.max_instances:
            # throttled: wait for the earliest-free same-function instance
            # (429 + retry in real Lambda; modeled as queueing delay)
            pool = [i for i in self._instances if i.fn == fn]
            if pool:
                inst = min(pool, key=lambda i: i.busy_until)
                return inst, False
            # fleet is full of OTHER functions' environments: reclaim the
            # earliest-free one and boot a fresh environment for this fn in
            # its place (never hand fn a foreign instance's cache) — the
            # request queues until the victim frees, then pays a cold boot.
            victim = min(self._instances, key=lambda i: i.busy_until)
            self._instances.remove(victim)
            inst = Instance(self.config.memory_bytes, now, fn)
            inst.busy_until = max(now, victim.busy_until)
            self._instances.append(inst)
            return inst, True
        inst = Instance(self.config.memory_bytes, now, fn)
        self._instances.append(inst)
        return inst, True

    def kill_instance(self, instance_id: int | None = None, *,
                      fn: str | None = None) -> bool:
        """Failure injection: kill one instance (random if unspecified).

        ``fn`` restricts the pick to one function's pool — this is how a
        benchmark makes one partition's fleet deliberately cold while its
        replicas stay warm."""
        live = [i for i in self._instances
                if i.alive and (fn is None or i.fn == fn)]
        if not live:
            return False
        victim = None
        if instance_id is None:
            victim = self._rng.choice(live)
        else:
            for i in live:
                if i.id == instance_id:
                    victim = i
        if victim is None:
            return False
        victim.alive = False
        self._instances.remove(victim)
        # the kill log is what hedge-aware routing rotates primaries on:
        # a pool that just lost an instance is the one most likely to greet
        # the next request with a cold start
        self.kill_log.append((self.clock, victim.fn))
        return True

    def recent_kills(self, fn: str, *, now: float | None = None,
                     window_s: float = 30.0) -> int:
        """Kill events in ``fn``'s pool within the trailing window — the
        'recently struggling' signal for routing and scale-up decisions."""
        t = self.clock if now is None else now
        return sum(1 for (tk, f) in self.kill_log
                   if f == fn and 0.0 <= t - tk <= window_s)

    def pool_busy(self, fn: str, now: float | None = None) -> bool:
        """True if any of ``fn``'s instances has in-flight work at ``now``.
        A busy pool needs no keep-alive: serving traffic IS its keep-alive,
        and a ping racing a live request would steal the idle instance the
        request was about to reuse — forcing a pointless cold start."""
        t = self.clock if now is None else now
        return any(i.fn == fn and i.alive and i.busy_until > t
                   for i in self._instances)

    def pool_expiry_s(self, fn: str, now: float | None = None) -> float | None:
        """Seconds until the LAST of ``fn``'s instances would be reaped for
        idleness (None if the pool has no instances). A keep-alive manager
        pings a pool when this drops under its margin; a warm pool serving
        steady traffic never needs the ping.

        Boundary contract (``tests`` pin this): an instance idle EXACTLY
        ``idle_timeout_s`` is still alive — ``_reap_idle``, ``probe``, and
        ``_acquire`` all keep instances at ``now - last_used <=
        idle_timeout_s``, reaping strictly after — and this method reports
        ``0.0`` for it. Keep-alive margin math (``autoscale._keepalive``
        pings when ``expiry < margin``) therefore fires the ping while the
        instance is still warm: an expiry of 0 is a pingable pool, not a
        lost one, and a margin of 0 would (correctly) never ping."""
        t = self.clock if now is None else now
        expiries = [i.last_used + self.config.idle_timeout_s - t
                    for i in self._instances if i.fn == fn and i.alive]
        return max(expiries) if expiries else None

    # -- invocation -------------------------------------------------------------

    def probe(self, fn: str, t_arrival: float | None = None) -> tuple[float, float]:
        """Projected (queue_wait_s, cold_boot_s) for the NEXT invocation of
        ``fn``, without mutating the fleet.

        Mirrors ``_acquire``'s placement decision at ``t_arrival`` under the
        virtual clock: an idle warm instance → (0, 0); a throttled fleet →
        queueing delay; otherwise a fresh provision. Hydration is not
        projected (the runtime doesn't know the handler's assets), so this is
        a lower bound — which is all a hedging policy needs, since a cold
        boot alone already dwarfs any warm-latency quantile."""
        now = self.clock if t_arrival is None else max(t_arrival, 0.0)
        cfg = self.config
        live = [i for i in self._instances
                if i.alive and (now - i.last_used) <= cfg.idle_timeout_s]
        if any(i.busy_until <= now and i.fn == fn for i in live):
            return 0.0, 0.0
        if len(live) >= cfg.max_instances:
            pool = [i for i in live if i.fn == fn]
            if pool:
                inst = min(pool, key=lambda i: i.busy_until)
                return max(0.0, inst.busy_until - now), 0.0
            victim = min(live, key=lambda i: i.busy_until)
            return max(0.0, victim.busy_until - now), cfg.provision_s
        return 0.0, cfg.provision_s

    def invoke(self, fn: str, payload: Any, *, t_arrival: float | None = None,
               keepalive: bool = False,
               write: bool = False) -> tuple[Any, InvocationRecord]:
        if fn not in self._handlers:
            raise RuntimeError_(f"no function {fn!r} registered")
        if fn in self._retired:
            raise RuntimeError_(f"function {fn!r} is retired (draining)")
        now = self.clock if t_arrival is None else max(t_arrival, 0.0)
        self.clock = max(self.clock, now)
        return self._invoke_retrying(fn, payload, now, keepalive=keepalive,
                                     write=write)

    def invoke_hedged(self, fn: str, backup_fn: str, payload: Any, *,
                      t_arrival: float | None = None) -> tuple[Any, InvocationRecord]:
        """Fire ``fn`` AND ``backup_fn`` (a replica serving the same asset)
        at the same arrival instant; the first completion wins.

        This is the cross-replica half of tail hedging: the per-instance
        ``hedge_after_s`` backup fires mid-execution on the SAME pool, while
        this one is decided at dispatch (from ``probe``'s projection) and
        lands on a DIFFERENT pool, so it sidesteps a cold/throttled fleet
        entirely. FaaS offers no cancellation, so the losing leg runs to
        completion, keeps its instance busy, and is billed in full (the
        hedging tax, visible in ``CostLedger.hedge_gb_seconds``) — but only
        the winner's latency is what the caller waits for, and only one
        logical record is appended (latency = winner's)."""
        for name in (fn, backup_fn):
            if name not in self._handlers:
                raise RuntimeError_(f"no function {name!r} registered")
            if name in self._retired:
                raise RuntimeError_(f"function {name!r} is retired (draining)")
        now = self.clock if t_arrival is None else max(t_arrival, 0.0)
        self.clock = max(self.clock, now)
        # Each leg retries independently; a leg whose retries run out must
        # not sink the call when its sibling succeeded — that is the whole
        # point of sending two. Retried legs keep their attribution flag, so
        # a dying-then-retried backup still bills on the hedge line.
        legs: list[tuple[Any, InvocationRecord]] = []
        first_err: RetriesExhausted | None = None
        for name, is_hedge in ((fn, False), (backup_fn, True)):
            try:
                legs.append(self._invoke_retrying(name, payload, now,
                                                  record=False, hedge=is_hedge))
            except RetriesExhausted as e:
                first_err = first_err or e
        if not legs:
            raise first_err
        if len(legs) == 1:
            (res, win), = legs
            dead = backup_fn if win.fn == fn else fn
            rec = dataclasses.replace(
                win, hedged=True, backup_fn=dead,
                loser_latency_s=float("inf"))   # the dead leg never finished
            self.records.append(rec)
            return res, rec
        (res, win), (_, lose) = sorted(
            legs, key=lambda p: p[1].latency_s)
        rec = dataclasses.replace(
            win, hedged=True, backup_fn=lose.fn, loser_latency_s=lose.latency_s)
        self.records.append(rec)
        return res, rec

    def _invoke_retrying(self, fn: str, payload: Any, now: float, *,
                         record: bool = True, hedge: bool = False,
                         keepalive: bool = False, write: bool = False):
        policy = self.config.retry_policy()
        attempt = 0
        while True:
            try:
                return self._invoke_once(fn, payload, now, attempt,
                                         record=record, hedge=hedge,
                                         keepalive=keepalive, write=write)
            except _InstanceDied:
                attempt += 1
                if attempt >= policy.max_attempts:
                    raise RetriesExhausted(fn, attempt) from None
                # client-side retry on another instance, after an exponential
                # backoff on the virtual clock (0 under the legacy default).
                # A dead attempt billed nothing: failure injection fires
                # before the handler runs and before any ledger charge, so
                # the retry's invocation carries the SAME attribution flags
                # (a hedged leg's retry stays on the hedge line).
                now += policy.backoff_s(attempt, self._rng)
                self.clock = max(self.clock, now)

    def _invoke_once(self, fn: str, payload: Any, now: float, attempt: int, *,
                     record: bool = True, hedge: bool = False,
                     keepalive: bool = False, write: bool = False):
        cfg = self.config
        inst, fresh = self._acquire(now, fn)
        queue_wait = max(0.0, inst.busy_until - now)
        t_start = now + queue_wait
        cold_boot = cfg.provision_s if fresh else 0.0

        if cfg.failure_rate and self._rng.random() < cfg.failure_rate:
            inst.alive = False
            if inst in self._instances:
                self._instances.remove(inst)
            raise _InstanceDied()

        hyd_before = inst.cache.stats.hydrate_seconds
        bf_before = inst.cache.stats.backfill_seconds
        result, exec_s = self._handlers[fn](inst.cache, payload)
        hydrate_s = inst.cache.stats.hydrate_seconds - hyd_before
        backfill_s = inst.cache.stats.backfill_seconds - bf_before
        cold = fresh or hydrate_s > 0

        # backfill (partial → full upgrade after the response) is OFF the
        # critical path: the caller's duration excludes it, but the instance
        # stays busy while it streams — and it bills on its own ledger line.
        duration = cold_boot + hydrate_s + exec_s
        # the primary occupies its instance for its FULL execution, win or
        # lose the hedge race — mark it busy now so a backup request can
        # never be "concurrently" placed on this same instance.
        inst.busy_until = t_start + duration + backfill_s
        inst.last_used = inst.busy_until
        inst.invocations += 1

        # Straggler hedging: if this execution ran past the hedge threshold,
        # fire a backup request on a second instance and take the faster.
        hedged = False
        result_duration = duration         # what the CALLER waits for
        if cfg.hedge_after_s is not None and exec_s > cfg.hedge_after_s:
            t_hedge = t_start + cfg.hedge_after_s
            inst2, fresh2 = self._acquire(t_hedge, fn)
            # a capped 1-instance fleet hands back the busy primary — there
            # is no second instance to back up on, so don't pretend to hedge
            if inst2 is not inst:
                queue2 = max(0.0, inst2.busy_until - t_hedge)
                hyd2_before = inst2.cache.stats.hydrate_seconds
                bf2_before = inst2.cache.stats.backfill_seconds
                result2, exec2_s = self._handlers[fn](inst2.cache, payload)
                hyd2 = inst2.cache.stats.hydrate_seconds - hyd2_before
                bf2 = inst2.cache.stats.backfill_seconds - bf2_before
                dur2 = (cfg.hedge_after_s + queue2
                        + (cfg.provision_s if fresh2 else 0.0) + hyd2 + exec2_s)
                if dur2 < result_duration:
                    result, result_duration = result2, dur2
                inst2.busy_until = t_start + dur2 + bf2
                inst2.last_used = inst2.busy_until
                inst2.invocations += 1
                self.ledger.charge(
                    Invocation(cfg.memory_bytes, exec2_s + hyd2, fresh2,
                               hedge=True))
                if bf2 > 0:
                    self.ledger.charge(
                        Invocation(cfg.memory_bytes, bf2, False,
                                   hedge=True, backfill=True))
                hedged = True

        self.clock = max(self.clock, inst.busy_until)

        self.ledger.charge(Invocation(cfg.memory_bytes, exec_s + hydrate_s,
                                      cold, hedge=hedge, idle=keepalive,
                                      write=write))
        if backfill_s > 0:
            # the deferred bulk transfer bills as its own invocation-time
            # line — never folded into the serving charge above, never into
            # the caller-visible latency below
            self.ledger.charge(Invocation(cfg.memory_bytes, backfill_s, False,
                                          hedge=hedge, backfill=True))
        rec = InvocationRecord(
            fn=fn, t_arrival=now, t_done=t_start + result_duration,
            latency_s=queue_wait + result_duration, exec_s=exec_s,
            hydrate_s=hydrate_s, cold=cold, provisioned=fresh,
            instance_id=inst.id,
            retries=attempt, hedged=hedged, keepalive=keepalive, write=write,
            backfill_s=backfill_s,
        )
        if record:
            self.records.append(rec)
        return result, rec

    # -- introspection ------------------------------------------------------------

    @property
    def fleet_size(self) -> int:
        return len(self._instances)

    def recent_latencies(self, fn=None, *, warm_only: bool = False,
                         window: int | None = None) -> list[float]:
        """Matching latencies from the record log, NEWEST first. ``window``
        caps the scan at that many newest matches — one bounded reverse
        pass, so per-query policy work never grows with the run length.
        Keep-alive pings never match (capacity maintenance, not queries)."""
        if fn is None:
            match = lambda r: True
        elif isinstance(fn, str):
            match = lambda r: r.fn == fn
        else:
            names = set(fn)
            match = lambda r: r.fn in names
        out: list[float] = []
        for r in reversed(self.records):
            if match(r) and not r.keepalive and not (warm_only and r.cold):
                out.append(r.latency_s)
                if window is not None and len(out) >= window:
                    break
        return out

    def latency_percentiles(self, fn=None, qs=(0.5, 0.9, 0.99), *,
                            warm_only: bool = False,
                            window: int | None = None) -> dict[float, float]:
        """Latency quantiles over the record log. ``fn`` may be a single
        function name or a collection of names (e.g. one partition's replica
        group); ``warm_only`` drops cold-start records — the baseline a
        hedging policy compares projected completions against. Keep-alive
        pings are never counted: they are capacity maintenance, not queries,
        and their near-zero exec would drag every quantile down.

        ``window`` restricts the quantiles to the newest matching records —
        the SAME recency convention :class:`~repro.core.partition.
        HedgePolicy` scans with, so a long-running fleet's controller scales
        on the latency regime it is actually in, not on hours-stale history
        (unwindowed, a mid-run regime shift is invisible until the old
        records are outnumbered)."""
        return nearest_rank_percentiles(
            self.recent_latencies(fn, warm_only=warm_only, window=window), qs)

    def warm_fraction(self, fn: str | None = None) -> float:
        recs = [r for r in self.records if fn is None or r.fn == fn]
        if not recs:
            return 0.0
        return sum(not r.cold for r in recs) / len(recs)


class _InstanceDied(Exception):
    pass
